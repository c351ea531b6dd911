// Decode WKV-7: one token step, three entry points around one body.
//
// Replaces the TPU kernels rwkv_tts_tpu/ops/wkv7.py:372 wkv7_single_bt_stack
// (body _wkv7_single_bt_stack_kernel, :349; entry `wkv7_decode`), :206
// wkv7_single_pallas and :306 wkv7_single_bt_pallas (bodies :174, :283; the
// same function, out of place; entry `wkv7_decode_out`), and the profiling
// tool's tools/profile_stack_kernel.py:115 merged_step_fn (all layers of a
// step in one call; entry `wkv7_decode_layers`). Per (batch b, head h), with
// the N x N state S (S[i, j]: value channel i, key channel j):
//
//     S <- S * diag(exp(-exp(w))) + (S a) b^T + v k^T,    y = S r
//
// The state is read in its storage dtype (float or bf16), the math runs in
// f32, and the result is rounded once, at the store (round to nearest even,
// as `s.astype(s_out_ref.dtype)` does in the TPU kernels).
//
// `wkv7_decode`, in place: the kernel addresses layer `layer` of the whole
// [L, B, H, N, N] stack and rewrites only that slab. This keeps the property
// the TPU kernel got from `input_output_aliases`: the rest of the stack is
// never read, written or copied, so the state crosses device memory once
// each way per layer per token. `wkv7_decode_out` reads `state_in` and
// writes a separate `state_out` (the per-layer TPU kernels' contract; the
// port keeps the plain [B, H, N, N] layout for both TPU layouts).
// `wkv7_decode_layers` runs every layer's tile of one step in one launch,
// grid (B*H, L): legal only because its inputs drop the inter-layer
// dependency, so it exists for measurement, and since every tile runs the
// same body its result is bit-identical to L launches of `wkv7_decode`.
//
// Bound: bytes. A step moves the layer's state slab twice (read + write,
// 2 * B*H*N*N*elem bytes) against ~9 flops per state element, far below the
// card's ops-per-byte balance. Design: one block per (b, h); each of its 8
// warps owns 8 rows i of the 64 x 64 tile and its 32 lanes own the key
// columns j = lane and lane + 32, so every row load is one coalesced
// 128-byte (f32) transaction. A warp first loads all of its 16 state values
// into registers (independent loads in flight), then reduces S a and S r
// across the lanes with shuffles. No shared memory, no block barrier.
// `expf`, not `__expf`: the decay must match the f32 reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 64;              // head size
constexpr int kWarps = 8;
constexpr int kRows = kN / kWarps;  // state rows per warp

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One (b, h) tile: reads `s_in` (all of a warp's values before any store),
// writes `s_out`; the two may be the same tile (in place). `vec` is the
// offset of the tile's N-vectors in the [.., N] inputs and y.
template <typename S>
__device__ __forceinline__ void decode_tile(
    const float* __restrict__ r, const float* __restrict__ w,
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ a, const float* __restrict__ b,
    const S* s_in, S* s_out, float* __restrict__ y, long long vec) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int j0 = lane, j1 = lane + 32;
  const float d0 = expf(-expf(w[vec + j0]));
  const float d1 = expf(-expf(w[vec + j1]));
  const float a0 = a[vec + j0], a1 = a[vec + j1];
  const float b0 = b[vec + j0], b1 = b[vec + j1];
  const float k0 = k[vec + j0], k1 = k[vec + j1];
  const float r0 = r[vec + j0], r1 = r[vec + j1];

  const int row0 = warp * kRows;
  float s0[kRows], s1[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    s0[q] = load_f32(s_in + (row0 + q) * kN + j0);
    s1[q] = load_f32(s_in + (row0 + q) * kN + j1);
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = row0 + q;
    const float vi = v[vec + i];
    const float sa = warp_sum(s0[q] * a0 + s1[q] * a1);
    const float n0 = s0[q] * d0 + sa * b0 + vi * k0;
    const float n1 = s1[q] * d1 + sa * b1 + vi * k1;
    store_f32(s_out + i * kN + j0, n0);
    store_f32(s_out + i * kN + j1, n1);
    const float yi = warp_sum(n0 * r0 + n1 * r1);
    if (lane == 0) y[vec + i] = yi;
  }
}

// in place on one layer's slab: block x = b * H + h
template <typename S>
__global__ void __launch_bounds__(kWarps * 32)
wkv7_decode_kernel(const float* __restrict__ r, const float* __restrict__ w,
                   const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ a, const float* __restrict__ b,
                   S* slab, float* __restrict__ y) {
  const long long vec = static_cast<long long>(blockIdx.x) * kN;
  S* tile = slab + vec * kN;
  decode_tile<S>(r, w, k, v, a, b, tile, tile, y, vec);
}

// out of place: [B, H, N, N] in, [B, H, N, N] out
template <typename S>
__global__ void __launch_bounds__(kWarps * 32)
wkv7_decode_out_kernel(const float* __restrict__ r,
                       const float* __restrict__ w,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ a,
                       const float* __restrict__ b,
                       const S* __restrict__ s_in, S* __restrict__ s_out,
                       float* __restrict__ y) {
  const long long vec = static_cast<long long>(blockIdx.x) * kN;
  decode_tile<S>(r, w, k, v, a, b, s_in + vec * kN, s_out + vec * kN, y,
                 vec);
}

// every layer in place: block (b * H + h, layer); inputs and y [L, B, H, N]
template <typename S>
__global__ void __launch_bounds__(kWarps * 32)
wkv7_decode_layers_kernel(const float* __restrict__ r,
                          const float* __restrict__ w,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ a,
                          const float* __restrict__ b, S* stack,
                          long long layer_stride, float* __restrict__ y) {
  const long long bh = blockIdx.x;
  const long long layer = blockIdx.y;
  const long long vec = (layer * gridDim.x + bh) * kN;
  S* tile = stack + layer * layer_stride + bh * kN * kN;
  decode_tile<S>(r, w, k, v, a, b, tile, tile, y, vec);
}

}  // namespace

// r, w, k, v, a, b, y: [B, H, 64] f32, contiguous. state_stack: [L, B, H,
// 64, 64], f32 (state_is_bf16 == 0) or bf16, each layer's B * H tiles
// contiguous and the layers `layer_stride` elements apart (B * H * 64 * 64
// for a whole stack, more for the first B slots of a wider one); layer in
// [0, L). Launches on `stream` of card `device` and returns
// cudaGetLastError().
extern "C" int wkv7_decode(const float* r, const float* w, const float* k,
                           const float* v, const float* a, const float* b,
                           float* y, void* state_stack, int state_is_bf16,
                           long long layer, long long layer_stride,
                           int batch_heads, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long slab = layer_stride;
  const dim3 grid(batch_heads), block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (state_is_bf16) {
    __nv_bfloat16* s = static_cast<__nv_bfloat16*>(state_stack) + layer * slab;
    wkv7_decode_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(r, w, k, v, a, b,
                                                              s, y);
  } else {
    float* s = static_cast<float*>(state_stack) + layer * slab;
    wkv7_decode_kernel<float><<<grid, block, 0, st>>>(r, w, k, v, a, b, s, y);
  }
  return static_cast<int>(cudaGetLastError());
}

// r, w, k, v, a, b, y: [B, H, 64] f32; state_in, state_out: [B, H, 64, 64],
// both f32 (state_is_bf16 == 0) or both bf16, contiguous and distinct;
// state_in is not written. Launches on `stream` of card `device` and
// returns cudaGetLastError().
extern "C" int wkv7_decode_out(const float* r, const float* w, const float* k,
                               const float* v, const float* a, const float* b,
                               float* y, const void* state_in, void* state_out,
                               int state_is_bf16, int batch_heads, int device,
                               void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(batch_heads), block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (state_is_bf16) {
    wkv7_decode_out_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        r, w, k, v, a, b, static_cast<const __nv_bfloat16*>(state_in),
        static_cast<__nv_bfloat16*>(state_out), y);
  } else {
    wkv7_decode_out_kernel<float><<<grid, block, 0, st>>>(
        r, w, k, v, a, b, static_cast<const float*>(state_in),
        static_cast<float*>(state_out), y);
  }
  return static_cast<int>(cudaGetLastError());
}

// r, w, k, v, a, b, y: [L, B, H, 64] f32, contiguous. state_stack: [L, B, H,
// 64, 64] f32 or bf16 as for wkv7_decode, every layer updated in place.
// Launches on `stream` of card `device` and returns cudaGetLastError().
extern "C" int wkv7_decode_layers(const float* r, const float* w,
                                  const float* k, const float* v,
                                  const float* a, const float* b, float* y,
                                  void* state_stack, int state_is_bf16,
                                  int layers, long long layer_stride,
                                  int batch_heads, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(batch_heads, layers), block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (state_is_bf16) {
    wkv7_decode_layers_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        r, w, k, v, a, b, static_cast<__nv_bfloat16*>(state_stack),
        layer_stride, y);
  } else {
    wkv7_decode_layers_kernel<float><<<grid, block, 0, st>>>(
        r, w, k, v, a, b, static_cast<float*>(state_stack), layer_stride, y);
  }
  return static_cast<int>(cudaGetLastError());
}
