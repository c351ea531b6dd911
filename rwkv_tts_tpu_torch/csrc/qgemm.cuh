// Tiled bf16 tensor-core GEMM with a dequantizing weight loader: the body
// shared by csrc/qmm4.cu (int4 weights) and csrc/qmm.cu (int8 weights).
//
//     out[M, N] (f32) = x[M, K] (bf16) @ W[K, N] (bf16, made from the
//                       quantized weight in shared memory) [* col_scale]
//
// A block computes a BM x 64 output tile (BM = 16 for decode rows, 64 for
// prefill rows) with 4 warps and WMMA 16x16x16 bf16 fragments, f32
// accumulators. Each K-step stages P pairs of tiles in shared memory: an
// x tile [BM, 64] and the weight tile [64, 64] that multiplies it. The
// loader turns its 64 x 64 weight bytes into bf16 there: int8 has one pair
// per step (rows k..k+63), int4 two (byte rows j..j+63 give the hi-nibble
// rows j.. and the lo-nibble rows j + K/2..), so each weight byte crosses
// device memory once.
//
// Decode products have few output tiles (N/64 of them at M <= 16), so the
// K-steps are cut across gridDim.z splits (ops/quant.gemm_plan). With more
// than one split, each writes its raw partial sums to partial[split] and a
// second kernel adds them in split order and applies the column scale:
// the result is the same whatever order the blocks finish in.
//
// No double buffering, no TMA, no wgmma: load, barrier, multiply, barrier.
// Simple and right first; ROADMAP D holds the redesign.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace qgemm {

constexpr int kBN = 64;          // output columns per block
constexpr int kBK = 64;          // weight (byte) rows per K-step
constexpr int kThreads = 128;    // 4 warps
constexpr int kLdA = kBK + 8;    // bf16 row pitch of the x tiles
constexpr int kLdB = kBN + 8;    // bf16 row pitch of the weight tiles
constexpr int kLdC = kBN + 4;    // f32 row pitch of the output staging

template <int BM, int P>
struct Tiles {
  __nv_bfloat16 a[P][BM][kLdA];
  __nv_bfloat16 b[P][kBK][kLdB];
};

// the operand tiles, and after the last K-step the f32 output staging, in
// the same shared bytes
template <int BM, int P>
struct Smem {
  static constexpr int kTiles = static_cast<int>(sizeof(Tiles<BM, P>));
  static constexpr int kStage = BM * kLdC * 4;
  static constexpr int kBytes = kTiles > kStage ? kTiles : kStage;
};

// 8 bf16 values packed for one 16-byte shared store
__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  return u;
}

template <int BM, class Loader>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const __nv_bfloat16* __restrict__ x, Loader ld,
            const float* __restrict__ col_scale, float* __restrict__ out,
            int M, int K, int N, int steps_per_split, int total_steps) {
  using namespace nvcuda;
  constexpr int P = Loader::kPairs;
  constexpr int kWarpsM = BM >= 32 ? 2 : 1;
  constexpr int kWarpsN = 4 / kWarpsM;
  constexpr int WM = BM / kWarpsM;
  constexpr int WN = kBN / kWarpsN;
  constexpr int FM = WM / 16;
  constexpr int FN = WN / 16;

  __shared__ __align__(128) unsigned char raw[Smem<BM, P>::kBytes];
  Tiles<BM, P>& t = *reinterpret_cast<Tiles<BM, P>*>(raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(total_steps, s_begin + steps_per_split);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int step = s_begin; step < s_end; ++step) {
    // x tiles, 8 bf16 (16 bytes) a thread a pass; rows past M read as 0
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int kc = ld.x_col(step, p);
      for (int idx = tid; idx < BM * kBK / 8; idx += kThreads) {
        const int r = idx / (kBK / 8), c = (idx % (kBK / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < M)
          v = *reinterpret_cast<const uint4*>(
              x + static_cast<long long>(m0 + r) * K + kc + c);
        *reinterpret_cast<uint4*>(&t.a[p][r][c]) = v;
      }
    }
    ld.load_b(step, n0, t.b, tid);
    __syncthreads();

#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(af[i], &t.a[p][wm * WM + i * 16][kk], kLdA);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(bf[j], &t.b[p][kk][wn * WN + j * 16], kLdB);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j)
            wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // stage the tile in shared memory (the operand tiles are free now), then
  // write the rows below M, scaled if this launch is the only split
  float* stage = reinterpret_cast<float*>(raw);
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(stage + (wm * WM + i * 16) * kLdC + wn * WN +
                                  j * 16,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();
  float* dst = out + static_cast<long long>(blockIdx.z) * M * N;
  for (int idx = tid; idx < BM * kBN; idx += kThreads) {
    const int r = idx / kBN, c = idx % kBN;
    if (m0 + r < M) {
      float v = stage[r * kLdC + c];
      if (col_scale) v *= col_scale[n0 + c];
      dst[static_cast<long long>(m0 + r) * N + n0 + c] = v;
    }
  }
}

// out[i] = (sum over splits of partial[s][i], in split order) [* scale].
// Internal to each library that includes this header: qmm4 and qmm load
// into one process, and their host stubs must not resolve to each other.
static __global__ void reduce_splits(const float* __restrict__ partial,
                              const float* __restrict__ col_scale,
                              float* __restrict__ out, int splits,
                              long long total, int N) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += partial[k * total + i];
  if (col_scale) s *= col_scale[i % N];
  out[i] = s;
}

// One product: the GEMM into `out` (one split) or into `partial` plus the
// ordered reduction. `col_scale` (or nullptr) multiplies each column once,
// after the whole sum. Returns cudaGetLastError().
template <class Loader>
int launch(const __nv_bfloat16* x, const Loader& ld, const float* col_scale,
           float* out, float* partial, int M, int K, int N, int block_m,
           int splits, int steps_per_split, int total_steps, int device,
           void* stream) {
  if (block_m != 16 && block_m != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / kBN, (M + block_m - 1) / block_m, splits);
  float* dst = splits > 1 ? partial : out;
  const float* scale = splits > 1 ? nullptr : col_scale;
  if (block_m == 16)
    gemm_kernel<16, Loader><<<grid, kThreads, 0, st>>>(
        x, ld, scale, dst, M, K, N, steps_per_split, total_steps);
  else
    gemm_kernel<64, Loader><<<grid, kThreads, 0, st>>>(
        x, ld, scale, dst, M, K, N, steps_per_split, total_steps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(M) * N;
  reduce_splits<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      partial, col_scale, out, splits, total, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace qgemm
