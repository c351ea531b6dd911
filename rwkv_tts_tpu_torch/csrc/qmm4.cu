// int4 dequant-GEMM (w4a16): out[M, N] f32 = x[M, K] bf16 @ dequant(wq, ws).
//
// Replaces the TPU kernel rwkv_tts_tpu/ops/quant.py:296 qmm4_pallas (body
// _qmm4_kernel, :273). The weight is int4 packed two codes a byte: byte row
// j holds row j in its high nibble and row j + K/2 in its low nibble, each a
// two's-complement code in [-8, 7] (sign-extended as (q ^ 8) - 8, `_nib`);
// ws[K/128, N] f32 holds one scale per group of 128 rows and column. As the
// TPU kernel's `half()` does, each weight is (code * scale) in f32 rounded
// once to bf16; products take bf16 operands and sum in f32.
//
// The body is csrc/qgemm.cuh in the int4 format (`qmm4_int4`): a decode
// regime for M <= 64, bound by bytes (one layer's six products at M = 8
// move ~27 MB and do 0.2 GFLOP), and a TMA + wgmma prefill regime, bound
// by operations, chosen by ops/quant.qmm4_plan; one launch per product.

#include "qgemm.cuh"

// x: [M, K] bf16, contiguous, 16-byte aligned. wq: [K/2, N] uint8 at row
// stride ldw (a multiple of 16, 16-byte aligned); ws: [K/128, N] f32 at row
// stride lds (a multiple of 4, 16-byte aligned). out: [M, N] f32. K/2 a
// multiple of 64 and N of 128. regime 0 (decode): m_tiles of 8 rows in
// {1, 2, 4, 8} per block, a cluster of `splits` <= 8 blocks along K, each
// walking `per` stages of 64 byte rows; regime 1 (prefill): 256 x 128
// tiles, m_tiles, splits and per unused. Launches on `stream` of card
// `device` and returns a CUDA error code (0 on success).
extern "C" int qmm4(const void* x, const void* wq, const void* ws, float* out,
                    int M, int K, int N, int ldw, int scale_rows, int lds,
                    int regime, int m_tiles, int splits, int per, int device,
                    void* stream) {
  return run<qmm4_int4>(x, wq, ws, out, M, K, N, ldw, scale_rows, lds,
                        regime, m_tiles, splits, per, device, stream);
}
