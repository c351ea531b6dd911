// Stride-1 dilated 1-D convolution as K accumulated tile products, with an
// optional snake prologue on the input and residual add in the epilogue.
//
// Replaces the TPU kernel rwkv_tts_tpu/ops/conv1d.py:112 conv1d_mxu (body
// _conv1d_windows_kernel, :45), the BiCodec wave generator's wide convs:
//
//     y[b, o, t] = bias[o] + sum_k sum_c W[o, c, k] * X'[b, c, t + k*dil - pad]
//                  (+ residual[b, o, t])
//     X' = x, or snake(x) = x + sin^2(alpha_c * x) / (alpha_c + 1e-9)
//
// with X' = 0 outside [0, T) (snake(0) = 0, so zero padding commutes with
// the prologue). The rounding is the contract (ops/conv1d.py:131-137,
// :64-70): with bf16 compute the input is rounded to bf16, the snake is
// evaluated in f32 on that value and rounded to bf16 again, the weights
// are rounded to bf16, and the products accumulate in f32; with f32
// compute nothing is rounded. Bias and residual are added to the f32
// accumulator, then one cast to the output type.
//
// Bound: operations for the k = 7 convs (2*K*Ci*O flops per output column
// against (Ci + O) elements moved: hundreds of flops per byte at the wave
// generator's widths), bytes for k = 1 at the narrow widths. Design: the
// TPU wrapper's overlapping window tensor, 128-lane rounding and VMEM block
// picking are not carried over. A block owns a 64 (O) x 128 (T) output tile
// of one batch row and loops over Ci in slabs of 32. Per slab it stages in
// shared memory the x slab with its halo of dil*(K-1) columns, transposed to
// [t][c] so that a tap is a row offset (which keeps every fragment pointer
// 32-byte aligned whatever the dilation), and the K weight slabs [k][o][c]
// read from the [O, Ci, K] tensor as it lies (rounded while staging, no
// repacked copy). The snake runs while staging: once per input element, not
// once per tap. 8 warps each accumulate a 32 x 32 sub-tile over the K
// shifted products: WMMA 16x16x16 bf16 fragments with f32 accumulators, or
// plain FFMA for f32 compute. The accumulator never leaves the block; the
// epilogue stages it in shared memory and writes y once, coalesced along t.
// No double buffering, no TMA, no wgmma: load, barrier, multiply, barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kBO = 64;        // output channels per block
constexpr int kBT = 128;       // output columns per block
constexpr int kCS = 32;        // input channels per slab
constexpr int kThreads = 256;  // 8 warps: 2 over O x 4 over T
constexpr int kSP = kBT + 4;   // f32 row pitch of the output staging
constexpr int kMaxSmem = 227 * 1024;

// shared-memory pitches, in elements of the compute type. bf16: rows of
// the x tile start 32 bytes apart-aligned for any tap offset (pitch 48),
// weight rows need a multiple of 8 (pitch 40) and each tap's plane is
// shifted by 16 elements so the taps of one channel fall in other banks.
// f32: odd pitches, conflict-free for the FFMA loop's column reads.
template <bool BF16> struct Lay;
template <> struct Lay<true> {
  using T = __nv_bfloat16;
  static constexpr int XP = 48, WP = 40, WPL = kBO * 40 + 16;
};
template <> struct Lay<false> {
  using T = float;
  static constexpr int XP = 33, WP = 33, WPL = kBO * 33;
};

struct Args {
  const void* x;        // [B, Ci, T] f32 or bf16
  const void* w;        // [O, Ci, K] f32 or bf16
  const float* bias;    // [O] or null
  const float* alpha;   // [Ci] or null: snake prologue
  const void* res;      // [B, O, T_out] f32 or bf16, or null
  void* y;              // [B, O, T_out] f32 or bf16
  int Ci, O, T, T_out, K, dil, pad;
  int x_bf16, w_bf16, res_bf16, y_bf16;
};

__device__ __forceinline__ float load_any(const void* p, long long i,
                                          int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads) conv1d_kernel(Args a) {
  using L = Lay<BF16>;
  using T = typename L::T;
  extern __shared__ __align__(128) unsigned char raw[];
  T* ws = reinterpret_cast<T*>(raw);          // [K][kBO][WP] (+ plane shift)
  T* xs = ws + a.K * L::WPL;                  // [kBT + halo][XP]
  float* stage = reinterpret_cast<float*>(raw);

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kBT;
  const int o0 = blockIdx.y * kBO;
  const int b = blockIdx.z;
  const int rows = kBT + a.dil * (a.K - 1);

  // accumulators: WMMA fragments (warp tile 32 x 32) or 8 x 4 scalars
  // (thread rows ty*8 + i, columns tx + 32*j)
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      frag[2][2];
  float acc[8][4];
  if (BF16) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(frag[i][j], 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  const long long x_row0 = static_cast<long long>(b) * a.Ci;
  for (int c0 = 0; c0 < a.Ci; c0 += kCS) {
    // x slab with its halo, transposed to [t][c]. A warp covers 8 columns
    // x 4 channel pairs a pass: 32-byte runs of each channel row from
    // device memory, each thread storing its pair side by side.
    const int units = ((rows + 7) / 8) * 8 * (kCS / 2);
    for (int u = tid; u < units; u += kThreads) {
      const int blk = u >> 5;
      const int j = (blk >> 2) * 8 + (u & 7);
      const int cl = ((blk & 3) * 4 + ((u >> 3) & 3)) * 2;
      if (j >= rows) continue;
      const int t_in = t0 - a.pad + j;
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = c0 + cl + q;
        float e = 0.0f;
        if (t_in >= 0 && t_in < a.T && c < a.Ci) {
          e = load_any(a.x, (x_row0 + c) * a.T + t_in, a.x_bf16);
          if (BF16) e = round_bf16(e);
          if (a.alpha) {
            const float al = a.alpha[c];
            const float s = sinf(al * e);
            e = e + (s * s) / (al + 1e-9f);
          }
        }
        v[q] = e;
      }
      put(xs + j * L::XP + cl, v[0]);
      put(xs + j * L::XP + cl + 1, v[1]);
    }
    // the K weight slabs [k][o][c] from w[o, c0 : c0 + 32, :], a run of
    // 32*K contiguous elements per output channel
    const int run = kCS * a.K;
    for (int idx = tid; idx < kBO * run; idx += kThreads) {
      const int ol = idx / run, e = idx - ol * run;
      const int cl = e / a.K, k = e - cl * a.K;
      float v = 0.0f;
      if (o0 + ol < a.O && c0 + cl < a.Ci)
        v = load_any(a.w,
                     (static_cast<long long>(o0 + ol) * a.Ci + c0) * a.K + e,
                     a.w_bf16);
      put(ws + k * L::WPL + ol * L::WP + cl, v);
    }
    __syncthreads();

    if (BF16) {
      using namespace nvcuda;
      const __nv_bfloat16* wsb = reinterpret_cast<const __nv_bfloat16*>(ws);
      const __nv_bfloat16* xsb = reinterpret_cast<const __nv_bfloat16*>(xs);
      for (int k = 0; k < a.K; ++k) {
#pragma unroll
        for (int kk = 0; kk < kCS; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> af[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bf[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(
                af[i], wsb + k * L::WPL + (wm * 32 + i * 16) * L::WP + kk,
                L::WP);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(
                bf[j],
                xsb + (wn * 32 + j * 16 + k * a.dil) * L::XP + kk, L::XP);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::mma_sync(frag[i][j], af[i], bf[j], frag[i][j]);
        }
      }
    } else {
      const float* wsf = reinterpret_cast<const float*>(ws);
      const float* xsf = reinterpret_cast<const float*>(xs);
      for (int k = 0; k < a.K; ++k) {
        const float* wk = wsf + k * L::WPL + warp * 8 * L::WP;
        const float* xk = xsf + (lane + k * a.dil) * L::XP;
#pragma unroll 4
        for (int c = 0; c < kCS; ++c) {
          float wv[8], xv[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) wv[i] = wk[i * L::WP + c];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = xk[j * 32 * L::XP + c];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += wv[i] * xv[j];
        }
      }
    }
    __syncthreads();
  }

  // epilogue: the tile through shared memory (the operand tiles are free
  // now), bias and residual added in f32, one cast, rows written along t
  if (BF16) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(
            stage + (wm * 32 + i * 16) * kSP + wn * 32 + j * 16, frag[i][j],
            kSP, nvcuda::wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        stage[(warp * 8 + i) * kSP + lane + 32 * j] = acc[i][j];
  }
  __syncthreads();
  for (int idx = tid; idx < kBO * kBT; idx += kThreads) {
    const int r = idx / kBT, c = idx - r * kBT;
    const int o = o0 + r, t = t0 + c;
    if (o >= a.O || t >= a.T_out) continue;
    float v = stage[r * kSP + c];
    if (a.bias) v += a.bias[o];
    const long long at = (static_cast<long long>(b) * a.O + o) * a.T_out + t;
    if (a.res) v += load_any(a.res, at, a.res_bf16);
    if (a.y_bf16)
      static_cast<__nv_bfloat16*>(a.y)[at] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(a.y)[at] = v;
  }
}

template <bool BF16>
int launch(const Args& a, int B, cudaStream_t st) {
  using L = Lay<BF16>;
  const int rows = kBT + a.dil * (a.K - 1);
  const long long operands =
      (static_cast<long long>(a.K) * L::WPL + static_cast<long long>(rows) *
       L::XP) * static_cast<long long>(sizeof(typename L::T));
  const long long staging = static_cast<long long>(kBO) * kSP * 4;
  const long long bytes = operands > staging ? operands : staging;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv1d_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.T_out + kBT - 1) / kBT, (a.O + kBO - 1) / kBO, B);
  conv1d_kernel<BF16><<<grid, kThreads, static_cast<size_t>(bytes), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [B, Ci, T], w: [O, Ci, K], y and res: [B, O, T_out], all contiguous,
// each f32 or bf16 as its flag says; bias [O] and alpha [Ci] f32 or null;
// T_out = T + 2*pad - dil*(K - 1) >= 1. compute_bf16 picks the tensor-core
// path (bf16 operands) or the f32 FFMA path; both accumulate in f32.
// Launches on `stream` of card `device` and returns cudaGetLastError().
extern "C" int conv1d(const void* x, const void* w, const float* bias,
                      const float* alpha, const void* res, void* y, int B,
                      int Ci, int O, int T, int T_out, int K, int dil,
                      int pad, int x_bf16, int w_bf16, int res_bf16,
                      int y_bf16, int compute_bf16, int device,
                      void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (B < 1 || Ci < 1 || O < 1 || K < 1 || dil < 1 || pad < 0 ||
      T_out != T + 2 * pad - dil * (K - 1) || T_out < 1 || B > 65535 ||
      (O + kBO - 1) / kBO > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w, bias, alpha, res, y, Ci, O, T, T_out, K, dil, pad,
               x_bf16, w_bf16, res_bf16, y_bf16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return compute_bf16 ? launch<true>(a, B, st) : launch<false>(a, B, st);
}
