// Paired phase A of the chunkwise WKV-7 prefill: both runs of each chunk in
// one pass.
//
// Replaces the TPU kernel rwkv_tts_tpu/ops/wkv7.py:851
// wkv7_chunk_pair_bt_pallas (body _wkv7_chunk_pair_bt_kernel, :804), the
// phase A of wkv7_chunked_fused (:896); its plain version is
// ops/wkv7.wkv7_chunk_pair. A [B, T, H, N] prompt is cut into M = B * T / L
// chunks of L positions ([M, L, H, N], the same memory). Per (chunk m,
// head h), for t = 0 .. L-1, with M_t = diag(exp(-exp(w_t))) + a_t b_t^T:
//
//     S <- S M_t + v_t k_t^T,  y_loc_t = S r_t        (S starts at zero)
//     P <- P M_t,              rho_t   = P r_t        (P starts at I)
//
// and s_loc = S, P at the end. P takes the state's update without the
// write, so its decay acts on the key (column) index as the state's does:
// _chunk_combine then forms S_next = S_in P + s_loc. P is built by forward
// products only, so any chunk length works (no exp(-lw) range cap, unlike
// the WY kernel).
//
// Inputs r, w, k, v, a, b are f32; outputs y_loc, rho [M, L, H, N] and
// s_loc, P [M, H, N, N], f32. The decay is expf(-expf(w)), not __expf: a
// masked position's w = -30 must give a decay of exactly 1.0f.
//
// Bound: bytes at the path's shapes. Each cell writes two N x N slabs once
// (2 * N^2 floats per chunk and head) besides reading six and writing two
// sequence tensors, against ~16 N^2 flops per position: at L = 16 bytes and
// operations take about the same time, at L = 4 the slabs dominate. Design:
// the sequential prefill kernel's, doubled. One block per (m, h); each of 8
// warps owns 8 rows, each lane the key columns lane and lane + 32, so both
// slabs live in registers (2 x 16 floats a thread) for the whole walk. The
// step's vectors are read from global memory (all warps share them through
// L1), the next step's loaded before this step's arithmetic. S a, S r, P a
// and P r are warp-shuffle reductions. No shared memory, no block barrier.
// B * n_c * H blocks, where the sequential kernel has B * H.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 64;              // head size
constexpr int kWarps = 8;
constexpr int kRows = kN / kWarps;  // slab rows per warp

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
wkv7_chunk_pair_kernel(const float* __restrict__ r,
                       const float* __restrict__ w,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ a,
                       const float* __restrict__ b,
                       float* __restrict__ y_loc, float* __restrict__ rho,
                       float* __restrict__ s_loc, float* __restrict__ p_out,
                       int L, int H) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int mh = blockIdx.x;
  const int m = mh / H;
  const int h = mh - m * H;
  const int row0 = warp * kRows;

  float s0[kRows], s1[kRows], p0[kRows], p1[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    s0[q] = 0.0f;
    s1[q] = 0.0f;
    p0[q] = (row0 + q == lane) ? 1.0f : 0.0f;
    p1[q] = (row0 + q == lane + 32) ? 1.0f : 0.0f;
  }

  // element (m, t, h, :) of an [M, L, H, N] tensor
  const long long stride_t = static_cast<long long>(H) * kN;
  long long off = (static_cast<long long>(m) * L * H + h) * kN;
  Step cur{}, nxt{};
  load_step(cur, r, w, k, v, a, b, off, lane, row0);
  for (int t = 0; t < L; ++t) {
    if (t + 1 < L) load_step(nxt, r, w, k, v, a, b, off + stride_t, lane, row0);
    const float d0 = expf(-expf(cur.w0));
    const float d1 = expf(-expf(cur.w1));
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const float sa = warp_sum(s0[q] * cur.a0 + s1[q] * cur.a1);
      s0[q] = s0[q] * d0 + sa * cur.b0 + cur.v[q] * cur.k0;
      s1[q] = s1[q] * d1 + sa * cur.b1 + cur.v[q] * cur.k1;
      const float yi = warp_sum(s0[q] * cur.r0 + s1[q] * cur.r1);
      const float pa = warp_sum(p0[q] * cur.a0 + p1[q] * cur.a1);
      p0[q] = p0[q] * d0 + pa * cur.b0;
      p1[q] = p1[q] * d1 + pa * cur.b1;
      const float ri = warp_sum(p0[q] * cur.r0 + p1[q] * cur.r1);
      if (lane == 0) {
        y_loc[off + row0 + q] = yi;
        rho[off + row0 + q] = ri;
      }
    }
    off += stride_t;
    cur = nxt;
  }

  const long long tile = static_cast<long long>(mh) * kN * kN;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const long long row = tile + (row0 + q) * kN;
    s_loc[row + lane] = s0[q];
    s_loc[row + lane + 32] = s1[q];
    p_out[row + lane] = p0[q];
    p_out[row + lane + 32] = p1[q];
  }
}

}  // namespace

// r, w, k, v, a, b, y_loc, rho: [M, L, H, 64] f32 (M = chunks, L >= 1);
// s_loc, P: [M, H, 64, 64] f32; all contiguous. Launches on `stream` of
// card `device` and returns cudaGetLastError().
extern "C" int wkv7_chunk_pair(const float* r, const float* w, const float* k,
                               const float* v, const float* a, const float* b,
                               float* y_loc, float* rho, float* s_loc,
                               float* P, int chunks, int L, int H, int device,
                               void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(chunks * H), block(kWarps * 32);
  wkv7_chunk_pair_kernel<<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      r, w, k, v, a, b, y_loc, rho, s_loc, P, L, H);
  return static_cast<int>(cudaGetLastError());
}
