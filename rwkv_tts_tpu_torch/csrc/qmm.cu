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
// The body is csrc/qgemm.cuh in the int8 format (`qmm_int8`): a decode
// regime for M <= 64, bound by bytes (one fused layer's four products at
// M = 8 move ~63 MB of weights at 16 operations a byte), and a TMA + wgmma
// prefill regime, bound by operations, chosen by ops/quant.qmm_plan; one
// launch per product, the column scale applied in its epilogue.

#include "qgemm.cuh"

// x: [M, K] bf16, contiguous, 16-byte aligned. wq: [K, N] int8 at row
// stride ldw (a multiple of 16, 16-byte aligned); ws: [1, N] f32
// (scale_rows == 1; lds is not read), 16-byte aligned. out: [M, N] f32. K a
// multiple of 64 and N of 128. regime 0 (decode): m_tiles of 8 rows in
// {1, 2, 4, 8} per block, a cluster of `splits` <= 8 blocks along K, each
// walking `per` stages of 64 rows; regime 1 (prefill): 256 x 128 tiles,
// m_tiles, splits and per unused. Launches on `stream` of card `device` and
// returns a CUDA error code (0 on success).
extern "C" int qmm(const void* x, const void* wq, const void* ws, float* out,
                   int M, int K, int N, int ldw, int scale_rows, int lds,
                   int regime, int m_tiles, int splits, int per, int device,
                   void* stream) {
  return run<qmm_int8>(x, wq, ws, out, M, K, N, ldw, scale_rows, lds, regime,
                       m_tiles, splits, per, device, stream);
}
