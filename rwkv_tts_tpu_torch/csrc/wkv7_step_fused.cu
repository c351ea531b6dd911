// Fused decode step of one layer: the per-head "soup" around the WKV-7
// update, in place on the state stack.
//
// Replaces the TPU kernel rwkv_tts_tpu/ops/wkv7.py:755
// wkv7_step_fused_bt_pallas (body _wkv7_step_fused_bt_kernel, :685), line
// for line. Per (batch b, head h), with j the key channel and i the value
// channel of the N x N state S:
//
//     w     = -softplus(-(w0 + lo_w)) - 0.5,     d = exp(-exp(w))
//     iclr  = sigmoid(a0 + lo_a)
//     gate  = sigmoid(v0 + lo_v) * notfirst,     v' = v + (v_first - v) gate
//     kk    = (k k_k) / sqrt(sum_j (k k_k)^2 + 1e-12)
//     k_in  = k (1 + (iclr - 1) k_a),            b = kk iclr
//     S    <- S diag(d) + (S (-kk)) b^T + v' k_in^T,     y = S r
//     out   = (GroupNorm_N(y; gn_eps) ln_x_w + ln_x_b + (sum_j r k_in r_k) v') g
//
// The TPU kernel keeps the batch in its 128 lanes ([H, N, N, B] state) and
// the JAX model takes it only from batch 8 up (wkv_bt_active), for those
// lanes. The port has no lanes: this kernel updates one layer's slab of the
// plain [L, B, H, N, N] stack in place, as csrc/wkv7_decode.cu does, and
// serves every batch. Its [B, H, N] operands may be row-strided views
// (the slices of the fused projections' outputs), so nothing is copied to
// feed it.
//
// Bound: bytes, as the decode kernel: the slab is read and written once
// (2 * B*H*N*N * elem) beside 9 [B, H, N] operand reads and one write, at
// ~10 flops per state element. Design: one block per (b, h), 8 warps; each
// warp owns 8 state rows and its lanes the key columns j = lane and
// lane + 32, so a row is one coalesced load. The key-side terms (decay,
// iclr, kk's norm, k_in, the rk bonus) are warp reductions every warp
// computes for itself; the 64 outputs y_i meet in shared memory for the
// GroupNorm. `expf`/`log1pf`/`sqrtf` without fast-math, as the other
// kernels: the f32 reference is the plain version.

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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// jax.nn.softplus: logaddexp(x, 0)
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// the eight [B, H, N] operands: base pointers and batch-row strides (in
// elements; the H * N values of a row are contiguous)
struct Operands {
  const void* r;
  const float* lo_w;
  const float* lo_a;
  const float* lo_v;
  const void* k;
  const void* v;
  const float* g;
  const float* v_first;
  long long s_r, s_lo_w, s_lo_a, s_lo_v, s_k, s_v, s_g, s_v_first;
};

template <typename S, typename In>
__global__ void __launch_bounds__(kWarps * 32)
wkv7_step_fused_kernel(Operands op, const float* __restrict__ pp,
                       S* __restrict__ slab, float* __restrict__ out, int H,
                       float notfirst, float gn_eps) {
  __shared__ float ys[kN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hn = h * kN;
  const In* r = static_cast<const In*>(op.r) + b * op.s_r + hn;
  const In* k = static_cast<const In*>(op.k) + b * op.s_k + hn;
  const In* v = static_cast<const In*>(op.v) + b * op.s_v + hn;
  const float* lo_w = op.lo_w + b * op.s_lo_w + hn;
  const float* lo_a = op.lo_a + b * op.s_lo_a + hn;
  const float* lo_v = op.lo_v + b * op.s_lo_v + hn;
  const float* g = op.g + b * op.s_g + hn;
  const float* vf = op.v_first + b * op.s_v_first + hn;
  // params8 rows: k_k, k_a, w0, a0, v0, r_k, ln_x_w, ln_x_b, each [H, N]
  const long long prow = static_cast<long long>(H) * kN;
  auto col = [&](int p, int n) { return pp[p * prow + hn + n]; };
  S* tile = slab + static_cast<long long>(blockIdx.x) * kN * kN;

  // key side, lanes own j = lane and lane + 32
  float d[2], kk[2], k_in[2], bb[2], rj[2], kk0[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = lane + 32 * u;
    const float w = -softplus(-(col(2, j) + lo_w[j])) - 0.5f;
    d[u] = expf(-expf(w));
    const float iclr = sigmoid(col(3, j) + lo_a[j]);
    const float kj = load_f32(k + j);
    kk0[u] = kj * col(0, j);
    k_in[u] = kj * (1.0f + (iclr - 1.0f) * col(1, j));
    bb[u] = iclr;
    rj[u] = load_f32(r + j);
  }
  const float inv =
      1.0f / sqrtf(warp_sum(kk0[0] * kk0[0] + kk0[1] * kk0[1]) + 1e-12f);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    kk[u] = kk0[u] * inv;
    bb[u] *= kk[u];               // b = kk * iclr
  }
  const float rk = warp_sum(rj[0] * k_in[0] * col(5, lane) +
                            rj[1] * k_in[1] * col(5, lane + 32));

  // value side: each warp's 8 rows, all lanes holding the row's v'
  const int row0 = warp * kRows;
  float s0[kRows], s1[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    s0[q] = load_f32(tile + (row0 + q) * kN + lane);
    s1[q] = load_f32(tile + (row0 + q) * kN + lane + 32);
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = row0 + q;
    const float vi = load_f32(v + i);
    const float gate = sigmoid(col(4, i) + lo_v[i]) * notfirst;
    const float ve = vi + (vf[i] - vi) * gate;
    const float sa = warp_sum(s0[q] * -kk[0] + s1[q] * -kk[1]);
    const float n0 = s0[q] * d[0] + sa * bb[0] + ve * k_in[0];
    const float n1 = s1[q] * d[1] + sa * bb[1] + ve * k_in[1];
    store_f32(tile + i * kN + lane, n0);
    store_f32(tile + i * kN + lane + 32, n1);
    const float yi = warp_sum(n0 * rj[0] + n1 * rj[1]);
    if (lane == 0) ys[i] = yi;
  }
  __syncthreads();

  // GroupNorm over the head's 64 outputs, then ln_x, the bonus and the gate
  if (warp < 2) {
    const float y0 = ys[lane], y1 = ys[lane + 32];
    const float mu = warp_sum(y0 + y1) * (1.0f / kN);
    const float c0 = y0 - mu, c1 = y1 - mu;
    const float var = warp_sum(c0 * c0 + c1 * c1) * (1.0f / kN);
    const float rstd = 1.0f / sqrtf(var + gn_eps);
    const int i = threadIdx.x;    // 0..63
    const float vi = load_f32(v + i);
    const float gate = sigmoid(col(4, i) + lo_v[i]) * notfirst;
    const float ve = vi + (vf[i] - vi) * gate;
    const float yn = (ys[i] - mu) * rstd * col(6, i) + col(7, i);
    out[static_cast<long long>(blockIdx.x) * kN + i] = (yn + rk * ve) * g[i];
  }
}

template <typename S>
void launch_for_state(const Operands& op, int in_is_bf16, const float* pp,
                      S* slab, float* out, int B, int H, float notfirst,
                      float gn_eps, cudaStream_t st) {
  const dim3 grid(B * H), block(kWarps * 32);
  if (in_is_bf16)
    wkv7_step_fused_kernel<S, __nv_bfloat16><<<grid, block, 0, st>>>(
        op, pp, slab, out, H, notfirst, gn_eps);
  else
    wkv7_step_fused_kernel<S, float><<<grid, block, 0, st>>>(
        op, pp, slab, out, H, notfirst, gn_eps);
}

}  // namespace

// r, k, v: [B, H, 64] f32 (rkv_is_bf16 == 0) or bf16; lo_w, lo_a, lo_v, g,
// v_first: [B, H, 64] f32. Each operand's batch rows lie `s_*` elements
// apart, the H * 64 values of a row contiguous. params8: [8, H, 64] f32
// contiguous (k_k, k_a, w0, a0, v0, r_k, ln_x_w, ln_x_b). state_stack:
// [L, B, H, 64, 64], f32 (state_is_bf16 == 0) or bf16, each layer's B * H
// tiles contiguous and the layers `layer_stride` elements apart; only layer
// `layer` is rewritten. out: [B, H, 64] f32 contiguous. Launches on
// `stream` of card `device` and returns cudaGetLastError().
extern "C" int wkv7_step_fused(
    const void* r, const float* lo_w, const float* lo_a, const float* lo_v,
    const void* k, const void* v, const float* g, const float* v_first,
    long long s_r, long long s_lo_w, long long s_lo_a, long long s_lo_v,
    long long s_k, long long s_v, long long s_g, long long s_v_first,
    int rkv_is_bf16, const float* params8, void* state_stack,
    int state_is_bf16, long long layer, long long layer_stride, float* out,
    int B, int H, float notfirst, float gn_eps, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Operands op{r,   lo_w,   lo_a,   lo_v,   k,   v,   g,   v_first,
                    s_r, s_lo_w, s_lo_a, s_lo_v, s_k, s_v, s_g, s_v_first};
  const long long slab = layer_stride;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (state_is_bf16)
    launch_for_state(op, rkv_is_bf16, params8,
                     static_cast<__nv_bfloat16*>(state_stack) + layer * slab,
                     out, B, H, notfirst, gn_eps, st);
  else
    launch_for_state(op, rkv_is_bf16, params8,
                     static_cast<float*>(state_stack) + layer * slab, out, B,
                     H, notfirst, gn_eps, st);
  return static_cast<int>(cudaGetLastError());
}
