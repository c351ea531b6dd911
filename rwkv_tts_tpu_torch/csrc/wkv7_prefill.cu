// Prefill WKV-7: the sequential recurrence over a whole prompt chunk.
//
// Replaces the TPU kernels rwkv_tts_tpu/ops/wkv7.py:483 wkv7_seq_bt_pallas
// (body :450) and :1329 wkv7_pallas_packed (body :1278), both behind the
// entry point `wkv7_prefill`, and :103 wkv7_pallas (body :72, one block per
// (b, h) with the state resident, the design of this kernel) behind the
// entry point `wkv7_seq`: all three compute the function of the oracle
// wkv7_scan (:42), and both entry points launch the one kernel below, each
// under its own launch count. Per (batch b, head h), for t = 0 .. T-1:
//
//     S <- S * diag(exp(-exp(w_t))) + (S a_t) b_t^T + v_t k_t^T,  y_t = S r_t
//
// Inputs r, w, k, v, a, b are [B, T, H, N] f32 and the state [B, H, N, N]
// f32; outputs are y [B, T, H, N] f32 and the final state. The decay is
// computed here, exactly as wkv7_scan does (expf, not __expf: a masked
// position's w = -30 must give a decay of exactly 1.0f). Any T works, so
// prompt lengths with 4 not dividing T need no second kernel.
//
// Bound: bytes. The kernel reads the six sequence tensors and the state once
// and writes y and the state once; per element of the sequence tensors it
// does ~9 N flops, below the card's ops-per-byte balance at N = 64.
// Design: one block per (b, h) walks T with the 64 x 64 state in registers:
// each of 8 warps owns 8 rows, each lane the key columns lane and lane + 32
// (16 floats per thread). The step's vectors are read straight from global
// memory (all warps share them through L1), and the next step's are loaded
// before this step's arithmetic so the loads overlap it. S a and S r are
// warp-shuffle reductions. No shared memory, no block barrier.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 64;              // head size
constexpr int kWarps = 8;
constexpr int kRows = kN / kWarps;  // state rows per warp

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One position's inputs as one lane needs them: its two key columns of
// r, w, k, a, b and the v entries of its warp's rows.
struct Step {
  float r0, r1, w0, w1, k0, k1, a0, a1, b0, b1;
  float v[kRows];
};

__device__ __forceinline__ void load_step(
    Step& x, const float* __restrict__ r, const float* __restrict__ w,
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ a, const float* __restrict__ b, long long off,
    int lane, int row0) {
  x.r0 = r[off + lane];
  x.r1 = r[off + lane + 32];
  x.w0 = w[off + lane];
  x.w1 = w[off + lane + 32];
  x.k0 = k[off + lane];
  x.k1 = k[off + lane + 32];
  x.a0 = a[off + lane];
  x.a1 = a[off + lane + 32];
  x.b0 = b[off + lane];
  x.b1 = b[off + lane + 32];
#pragma unroll
  for (int q = 0; q < kRows; ++q) x.v[q] = v[off + row0 + q];
}

__global__ void __launch_bounds__(kWarps * 32)
wkv7_prefill_kernel(const float* __restrict__ r, const float* __restrict__ w,
                    const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ s_in, float* __restrict__ y,
                    float* __restrict__ s_out, int T, int H) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.x;
  const int bb = bh / H;
  const int h = bh - bb * H;
  const int row0 = warp * kRows;
  const long long tile = static_cast<long long>(bh) * kN * kN;

  float s0[kRows], s1[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    s0[q] = s_in[tile + (row0 + q) * kN + lane];
    s1[q] = s_in[tile + (row0 + q) * kN + lane + 32];
  }

  // element (bb, t, h, :) of a [B, T, H, N] tensor
  const long long stride_t = static_cast<long long>(H) * kN;
  long long off = (static_cast<long long>(bb) * T * H + h) * kN;
  Step cur{}, nxt{};
  if (T > 0) load_step(cur, r, w, k, v, a, b, off, lane, row0);
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) load_step(nxt, r, w, k, v, a, b, off + stride_t, lane, row0);
    const float d0 = expf(-expf(cur.w0));
    const float d1 = expf(-expf(cur.w1));
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const float sa = warp_sum(s0[q] * cur.a0 + s1[q] * cur.a1);
      s0[q] = s0[q] * d0 + sa * cur.b0 + cur.v[q] * cur.k0;
      s1[q] = s1[q] * d1 + sa * cur.b1 + cur.v[q] * cur.k1;
      const float yi = warp_sum(s0[q] * cur.r0 + s1[q] * cur.r1);
      if (lane == 0) y[off + row0 + q] = yi;
    }
    off += stride_t;
    cur = nxt;
  }

#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    s_out[tile + (row0 + q) * kN + lane] = s0[q];
    s_out[tile + (row0 + q) * kN + lane + 32] = s1[q];
  }
}

}  // namespace

// r, w, k, v, a, b, y: [B, T, H, 64] f32; state_in, state_out: [B, H, 64,
// 64] f32; all contiguous, state_out distinct from state_in. Launches on
// `stream` of card `device` and returns cudaGetLastError().
extern "C" int wkv7_prefill(const float* r, const float* w, const float* k,
                            const float* v, const float* a, const float* b,
                            const float* state_in, float* y, float* state_out,
                            int batch, int T, int H, int device,
                            void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(batch * H), block(kWarps * 32);
  wkv7_prefill_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      r, w, k, v, a, b, state_in, y, state_out, T, H);
  return static_cast<int>(cudaGetLastError());
}

// The same kernel and arguments as wkv7_prefill, launched through the entry
// point that stands for rwkv_tts_tpu/ops/wkv7.py:103 wkv7_pallas.
extern "C" int wkv7_seq(const float* r, const float* w, const float* k,
                        const float* v, const float* a, const float* b,
                        const float* state_in, float* y, float* state_out,
                        int batch, int T, int H, int device, void* stream) {
  return wkv7_prefill(r, w, k, v, a, b, state_in, y, state_out, batch, T, H,
                      device, stream);
}
