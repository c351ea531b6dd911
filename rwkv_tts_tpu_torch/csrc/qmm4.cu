// int4 dequant-GEMM (w4a16): out[M, N] f32 = x[M, K] bf16 @ dequant(wq, ws).
//
// Replaces the TPU kernel rwkv_tts_tpu/ops/quant.py:296 qmm4_pallas (body
// _qmm4_kernel, :273). The weight is int4 packed two codes a byte: byte row
// j holds row j in its high nibble and row j + K/2 in its low nibble, each a
// two's-complement code in [-7, 7] (sign-extended as (q ^ 8) - 8, `_nib`);
// ws[K/group, N] f32 holds one scale per group of rows and column. As the
// TPU kernel's `half()` does, each weight is (code * scale) in f32 rounded
// to bf16, the product takes bf16 operands and accumulates in f32.
//
// Bound: bytes at decode rows (M = 8: the packed weight, K/2 * N bytes, is
// nearly all of the traffic, 32 operations per byte), operations at prefill
// rows (M = 512..2048: 2 * M * K * N on the bf16 tensor cores). Design
// (csrc/qgemm.cuh): each K-step reads 64 byte rows x 64 columns once,
// 16 bytes a thread, and writes both nibble halves into shared memory as
// bf16, beside the two x tiles they multiply (columns j.. and K/2 + j..);
// WMMA bf16 tiles do the product. Decode shapes cut K across blocks so
// that enough bytes are in flight.

#include "qgemm.cuh"

namespace {

using qgemm::kBK;
using qgemm::kLdB;

struct Int4Loader {
  static constexpr int kPairs = 2;
  const uint8_t* wq;  // [K/2, N] at row stride ldw
  const float* ws;    // [K/group, N] at row stride lds
  int K2, ldw, lds, group;

  __device__ int x_col(int step, int p) const { return step * kBK + p * K2; }

  // 64 byte rows x 64 columns: 4 threads a row, 16 bytes each, two passes
  __device__ void load_b(int step, int n0, __nv_bfloat16 (*b)[kBK][kLdB],
                         int tid) const {
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int r = pass * 32 + (tid >> 2);
      const int c = (tid & 3) * 16;
      const int j = step * kBK + r;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          wq + static_cast<long long>(j) * ldw + n0 + c);
      const uint8_t* q = reinterpret_cast<const uint8_t*>(&raw);
      const float* s_hi = ws + static_cast<long long>(j / group) * lds + n0 + c;
      const float* s_lo =
          ws + static_cast<long long>((j + K2) / group) * lds + n0 + c;
      float hi[16], lo[16];
#pragma unroll
      for (int i = 0; i < 16; i += 4) {
        const float4 sh = *reinterpret_cast<const float4*>(s_hi + i);
        const float4 sl = *reinterpret_cast<const float4*>(s_lo + i);
        const float shv[4] = {sh.x, sh.y, sh.z, sh.w};
        const float slv[4] = {sl.x, sl.y, sl.z, sl.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int byte = q[i + u];
          hi[i + u] = static_cast<float>(((byte >> 4) ^ 8) - 8) * shv[u];
          lo[i + u] = static_cast<float>(((byte & 15) ^ 8) - 8) * slv[u];
        }
      }
      *reinterpret_cast<uint4*>(&b[0][r][c]) = qgemm::pack8(hi);
      *reinterpret_cast<uint4*>(&b[0][r][c + 8]) = qgemm::pack8(hi + 8);
      *reinterpret_cast<uint4*>(&b[1][r][c]) = qgemm::pack8(lo);
      *reinterpret_cast<uint4*>(&b[1][r][c + 8]) = qgemm::pack8(lo + 8);
    }
  }
};

}  // namespace

// x: [M, K] bf16, contiguous, 16-byte aligned. wq: [K/2, N] uint8 at row
// stride ldw (a multiple of 16); ws: [scale_rows, N] f32 at row stride lds
// (a multiple of 4), one row per group of K / scale_rows weight rows, the
// group dividing K/2. out: [M, N] f32. partial: [splits, M, N] f32 scratch
// when splits > 1. K/2 and N are multiples of 64; block_m is 16 or 64;
// splits * steps_per_split covers the K/2 / 64 steps. Launches on `stream`
// of card `device` and returns cudaGetLastError().
extern "C" int qmm4(const void* x, const void* wq, const void* ws, float* out,
                    float* partial, int M, int K, int N, int ldw,
                    int scale_rows, int lds, int block_m, int splits,
                    int steps_per_split, int device, void* stream) {
  const int K2 = K / 2;
  if (scale_rows < 2 || K % scale_rows || K2 % (K / scale_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  Int4Loader ld;
  ld.wq = static_cast<const uint8_t*>(wq);
  ld.ws = static_cast<const float*>(ws);
  ld.K2 = K2;
  ld.ldw = ldw;
  ld.lds = lds;
  ld.group = K / scale_rows;
  return qgemm::launch(static_cast<const __nv_bfloat16*>(x), ld, nullptr, out,
                       partial, M, K, N, block_m, splits, steps_per_split,
                       K2 / kBK, device, stream);
}
