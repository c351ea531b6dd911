// int8-weight GEMM: out[M, N] f32 = (x[M, K] bf16 @ wq[K, N] int8) * ws[N].
//
// Replaces the TPU kernel rwkv_tts_tpu/ops/quant.py:367 qmm_pallas (body
// _qmm_kernel, :361): the int8 weight is upcast to bf16 (exact for
// |q| <= 127), the product takes bf16 operands and accumulates in f32, and
// the per-output-channel scale multiplies the whole sum once. Activations
// stay bf16: unlike the default int8 path (per-row activation quantization
// and an s8 x s8 product) this computes x @ dequant(w) at bf16 input
// precision.
//
// Bound: bytes. It serves decode rows (M <= 512, in practice the batch of
// 8), where the K * N weight bytes are nearly all of the traffic at
// 2 * M = 16 operations per byte. Design (csrc/qgemm.cuh): each K-step
// reads 64 weight rows x 64 columns once, 16 bytes a thread, upcasts them
// into a bf16 shared tile beside the x tile, and WMMA bf16 tiles do the
// product; K is cut across blocks so that enough bytes are in flight.

#include "qgemm.cuh"

namespace {

using qgemm::kBK;
using qgemm::kLdB;

struct Int8Loader {
  static constexpr int kPairs = 1;
  const int8_t* wq;  // [K, N] at row stride ldw
  int ldw;

  __device__ int x_col(int step, int) const { return step * kBK; }

  // 64 rows x 64 columns: 4 threads a row, 16 bytes each, two passes
  __device__ void load_b(int step, int n0, __nv_bfloat16 (*b)[kBK][kLdB],
                         int tid) const {
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int r = pass * 32 + (tid >> 2);
      const int c = (tid & 3) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          wq + static_cast<long long>(step * kBK + r) * ldw + n0 + c);
      const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
      float v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = static_cast<float>(q[i]);
      *reinterpret_cast<uint4*>(&b[0][r][c]) = qgemm::pack8(v);
      *reinterpret_cast<uint4*>(&b[0][r][c + 8]) = qgemm::pack8(v + 8);
    }
  }
};

}  // namespace

// x: [M, K] bf16, contiguous, 16-byte aligned. wq: [K, N] int8 at row
// stride ldw (a multiple of 16). ws: [1, N] f32 (scale_rows == 1; lds is
// not read). out: [M, N] f32. partial: [splits, M, N] f32 scratch when
// splits > 1. K and N are multiples of 64; block_m is 16 or 64;
// splits * steps_per_split covers the K / 64 steps. Launches on `stream` of
// card `device` and returns cudaGetLastError().
extern "C" int qmm(const void* x, const void* wq, const void* ws, float* out,
                   float* partial, int M, int K, int N, int ldw,
                   int scale_rows, int lds, int block_m, int splits,
                   int steps_per_split, int device, void* stream) {
  (void)lds;
  if (scale_rows != 1) return static_cast<int>(cudaErrorInvalidValue);
  Int8Loader ld;
  ld.wq = static_cast<const int8_t*>(wq);
  ld.ldw = ldw;
  return qgemm::launch(static_cast<const __nv_bfloat16*>(x), ld,
                       static_cast<const float*>(ws), out, partial, M, K, N,
                       block_m, splits, steps_per_split, K / kBK, device,
                       stream);
}
