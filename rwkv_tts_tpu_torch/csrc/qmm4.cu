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
// Two regimes in one source, chosen by the wrapper from M
// (ops/quant.qmm4_plan), each one launch per product:
//
// * decode rows (M <= 64), bound by bytes: one layer's six products at
//   M = 8 move ~27 MB and do 0.2 GFLOP. outT = WT . xT on mma.sync
//   m16n8k16, so weight columns fill the instruction's 16-row side and the
//   batch rows its 8-wide side. A 256-thread block owns 128 columns and a
//   range of K; a 4-stage cp.async ring brings 64 byte rows of the weight,
//   their two scale rows and the matching x columns per stage. Each thread
//   turns a 32-bit word of packed bytes (4 columns of one byte row) straight
//   into A fragments of two k-chunks (j and j + K/2): no bf16 tile in shared
//   memory. The K ranges of one column tile form a thread-block cluster of
//   up to 8 blocks; their partial tiles are added through distributed shared
//   memory in rank order, so the sum does not depend on which block
//   finishes first, and no second kernel runs.
// * prefill rows, bound by operations: a 256 x 128 output tile, 4
//   warpgroups joined by mbarriers. One thread of warpgroup 0 brings each
//   stage by TMA: the x tile (a tensor map encoded per call, in the 64-byte
//   swizzle that wgmma reads; rows past M arrive as zeros) and the packed
//   weight tile with its two scale rows. Warpgroup 1 dequantizes the packed
//   tile into a bf16 weight tile (K-major, the same swizzle); warpgroups 2
//   and 3 each run wgmma m64n128k16 on 128 rows (two 64-row halves) and
//   release the stage's tiles once its products are done. setmaxnreg moves
//   registers from the loader and the dequantizer to the 128 accumulators
//   of each wgmma thread. A stage is 32 byte rows: k = j.. (high nibbles)
//   and k = K/2 + j.. (low nibbles) as two 32-wide halves of one 64-deep K
//   tile. The dequantizing warpgroup, one warp per scheduler, is the
//   critical path (PERF.md).
//
// The dequantization is exact to the contract: a nibble placed under the
// exponent of 2^23 gives 2^23 + (q ^ 8) as an f32, one subtraction gives the
// code (times 16 for the high nibble, whose scale is taken / 16, exact), one
// f32 product gives code * scale rounded once, cvt.rn gives bf16.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 128;  // rows per scale

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// code * scale of byte b's low nibble: 2^23 + (q ^ 8) - (2^23 + 8)
__device__ __forceinline__ float lo_val(uint32_t w, int b, float s) {
  const uint32_t v = ((w >> (8 * b)) & 0xFu) ^ 0x4B000008u;
  return (__uint_as_float(v) - 8388616.0f) * s;
}

// 16 * code of byte b's high nibble, times s16 = scale / 16
__device__ __forceinline__ float hi_val(uint32_t w, int b, float s16) {
  const uint32_t v = ((w >> (8 * b)) & 0xF0u) ^ 0x4B000080u;
  return (__uint_as_float(v) - 8388736.0f) * s16;
}

// --------------------------------------------------------------------------
// decode regime
// --------------------------------------------------------------------------

constexpr int kDBN = 128;            // output columns per block
constexpr int kDBK = 64;             // byte rows per stage
constexpr int kDStages = 4;
constexpr int kDThreads = 256;       // 4 column slabs x 2 halves of K
constexpr int kDXPitch = 4 * kDBK + 32;  // bytes an x row: hi, lo, pad
constexpr int kDPPitch = kDBN + 4;   // floats a partial-sum row

template <int MT>
struct DecodeSmem {
  static constexpr int kW = kDBK * kDBN;               // packed weight
  static constexpr int kS = 2 * kDBN * 4;              // hi, lo scales
  static constexpr int kX = MT * 8 * kDXPitch;         // x, hi then lo
  static constexpr int kStage = kW + kS + kX;
  static constexpr int kRing = kDStages * kStage;
  static constexpr int kPart = MT * 8 * kDPPitch * 4;
  static constexpr int kBytes = kRing > kPart ? kRing : kPart;
};

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (splits, N / 128, ceil(M / (8 MT))), cluster (splits, 1, 1): block
// x of a cluster walks the stages [x * per, (x + 1) * per) of 64 byte rows.
template <int MT>
__global__ void __launch_bounds__(kDThreads)
qmm4_decode(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wq,
            const float* __restrict__ ws, float* __restrict__ out, int M,
            int K2, int N, int ldw, int lds, int per) {
  using Sm = DecodeSmem<MT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & 3, wk = tid >> 7;  // column slab, K half
  const int g = lane >> 2, t = lane & 3;
  const int K = 2 * K2;
  const int n0 = blockIdx.y * kDBN;
  const int m0 = blockIdx.z * MT * 8;
  const int total = K2 / kDBK;
  const int s_begin = blockIdx.x * per;
  const int steps = max(0, min(total, s_begin + per) - s_begin);

  auto issue = [&](int step, int slot) {
    unsigned char* st = smem + slot * Sm::kStage;
    const int j0 = (s_begin + step) * kDBK;
#pragma unroll
    for (int idx = tid; idx < kDBK * 8; idx += kDThreads) {  // packed rows:
      const int r = idx >> 3, c = idx & 7;  // chunk c ^ 2 ((r / 4) % 4)
      cp16(st + r * kDBN + ((c ^ (((r >> 2) & 3) << 1)) << 4),
           wq + static_cast<long long>(j0 + r) * ldw + n0 + c * 16, true);
    }
    if (tid < 64) {                         // 2 scale rows x 32 chunks
      const int h = tid >> 5, c = tid & 31;
      const int row = (j0 + h * K2) / kGroup;
      cp16(st + Sm::kW + h * kDBN * 4 + c * 16,
           ws + static_cast<long long>(row) * lds + n0 + c * 4, true);
    }
    constexpr int kXC = kDBK / 4;           // 16-byte chunks an x row
    for (int idx = tid; idx < MT * 8 * kXC; idx += kDThreads) {  // x rows
      const int r = idx / kXC, c = idx % kXC;
      const int col = (c / (kXC / 2)) * K2 + j0 + (c % (kXC / 2)) * 8;
      const bool ok = m0 + r < M;
      cp16(st + Sm::kW + Sm::kS + r * kDXPitch + c * 16,
           x + (ok ? static_cast<long long>(m0 + r) * K + col : 0), ok);
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < kDStages - 1; ++s) {
    if (s < steps) issue(s, s);
    cp_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_wait<kDStages - 2>();
    __syncthreads();
    const int nxt = step + kDStages - 1;
    if (nxt < steps) issue(nxt, nxt % kDStages);
    cp_commit();

    const unsigned char* st = smem + (step % kDStages) * Sm::kStage;
    const float4 shv = *reinterpret_cast<const float4*>(
        st + Sm::kW + (warp * 32 + 4 * g) * 4);
    const float4 slv = *reinterpret_cast<const float4*>(
        st + Sm::kW + kDBN * 4 + (warp * 32 + 4 * g) * 4);
    const float sh16[4] = {shv.x * 0.0625f, shv.y * 0.0625f, shv.z * 0.0625f,
                           shv.w * 0.0625f};
    const float sl[4] = {slv.x, slv.y, slv.z, slv.w};
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(st + Sm::kW + Sm::kS);
#pragma unroll
    for (int uu = 0; uu < kDBK / 32; ++uu) {
      // the warps of K half wk take the 16-row units u = wk, wk + 2, ..:
      // thread (g, t) holds rows u*16 + 4t + s, columns 4g..4g+3 of its
      // warp's 32 (the fragment's k slots 2t, 2t+1, 2t+8, 2t+9 are rows
      // s = 0..3)
      const int u = wk + 2 * uu;
      uint32_t w[4];
      const int wc = (((warp * 2 + (g >> 2)) ^ (t << 1)) << 4) + (g & 3) * 4;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        w[s] = *reinterpret_cast<const uint32_t*>(
            st + (u * 16 + 4 * t + s) * kDBN + wc);
      uint32_t a[2][2][4];  // [half][n-tile][reg]
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int b0 = 2 * nt, b1 = 2 * nt + 1;
        a[0][nt][0] = pack_bf16(hi_val(w[0], b0, sh16[b0]),
                                hi_val(w[1], b0, sh16[b0]));
        a[0][nt][1] = pack_bf16(hi_val(w[0], b1, sh16[b1]),
                                hi_val(w[1], b1, sh16[b1]));
        a[0][nt][2] = pack_bf16(hi_val(w[2], b0, sh16[b0]),
                                hi_val(w[3], b0, sh16[b0]));
        a[0][nt][3] = pack_bf16(hi_val(w[2], b1, sh16[b1]),
                                hi_val(w[3], b1, sh16[b1]));
        a[1][nt][0] = pack_bf16(lo_val(w[0], b0, sl[b0]),
                                lo_val(w[1], b0, sl[b0]));
        a[1][nt][1] = pack_bf16(lo_val(w[0], b1, sl[b1]),
                                lo_val(w[1], b1, sl[b1]));
        a[1][nt][2] = pack_bf16(lo_val(w[2], b0, sl[b0]),
                                lo_val(w[3], b0, sl[b0]));
        a[1][nt][3] = pack_bf16(lo_val(w[2], b1, sl[b1]),
                                lo_val(w[3], b1, sl[b1]));
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* xr = xs + (mt * 8 + g) * (kDXPitch / 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint2 bb = *reinterpret_cast<const uint2*>(
              xr + h * kDBK + u * 16 + 4 * t);
          mma16816(acc[mt][0], a[h][0], bb.x, bb.y);
          mma16816(acc[mt][1], a[h][1], bb.x, bb.y);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  // this block's partial tile (the first K half's sums, then the
  // second's added); then the cluster adds the tiles in rank order
  float* part = reinterpret_cast<float*>(smem);
  for (int pass = 0; pass < 2; ++pass) {
    if (wk == pass) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = warp * 32 + 4 * g + 2 * nt;
          const int row = mt * 8 + 2 * t;
          float* p0 = part + row * kDPPitch + col;
          float* p1 = p0 + kDPPitch;
          if (pass == 0) {
            p0[0] = acc[mt][nt][0];
            p1[0] = acc[mt][nt][1];
            p0[1] = acc[mt][nt][2];
            p1[1] = acc[mt][nt][3];
          } else {
            p0[0] += acc[mt][nt][0];
            p1[0] += acc[mt][nt][1];
            p0[1] += acc[mt][nt][2];
            p1[1] += acc[mt][nt][3];
          }
        }
    }
    __syncthreads();
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  for (int e = rank * kDThreads + tid; e < MT * 8 * kDBN;
       e += ranks * kDThreads) {
    const int r = e / kDBN, c = e % kDBN;
    if (m0 + r >= M) continue;
    float v = 0.0f;
    for (int q = 0; q < ranks; ++q)
      v += cluster.map_shared_rank(part, q)[r * kDPPitch + c];
    out[static_cast<long long>(m0 + r) * N + n0 + c] = v;
  }
  cluster.sync();  // keep this block's tile alive until the others are done
}

// --------------------------------------------------------------------------
// prefill regime
// --------------------------------------------------------------------------

constexpr int kPBM = 256;
constexpr int kPBN = 128;
constexpr int kPBK = 32;             // byte rows per stage: K tile of 64
// rings deep enough that no warp waits for a stage still in flight
constexpr int kPXSlots = 4;          // x tiles (TMA), read by wgmma
constexpr int kPBSlots = 4;          // bf16 weight tiles, read by wgmma
constexpr int kPRaw = 4;             // packed weight + scales (TMA)
constexpr int kPThreads = 512;       // loading, dequantizing and 2 wgmma
constexpr int kPProducers = 128;     // warpgroups
// setmaxnreg: each SM sub-partition holds one warp of each warpgroup,
// 40 + 88 + 2 x 192 = 512 registers a lane, its 16384
constexpr int kPLoaderRegs = 40;
constexpr int kPProducerRegs = 88;
constexpr int kPConsumerRegs = 192;
// an operand tile is two halves, k = j.. (high nibbles) and k = K/2 + j..
// (low nibbles), each rows of 32 bf16 (64 bytes) in the 64-byte swizzle
constexpr int kPXHalf = kPBM * 64;
constexpr int kPBHalf = kPBN * 64;
constexpr int kPXTile = 2 * kPXHalf;
constexpr int kPBTile = 2 * kPBHalf;
constexpr int kPPacked = kPBK * kPBN;          // 128-byte swizzle, by TMA
constexpr int kPRawBytes = kPPacked + 2 * kPBN * 4;
constexpr int kPSmem = kPXSlots * kPXTile + kPBSlots * kPBTile +
                       kPRaw * kPRawBytes +
                       2 * (kPXSlots + kPBSlots + kPRaw) * 8 +
                       1024;  // + barriers, alignment

// byte offset of 16-byte chunk c of row r in a 64-byte-swizzled half tile
__device__ __forceinline__ int swz64(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

// arrive, and expect `bytes` more from asynchronous copies
__device__ __forceinline__ void mbar_expect(uint64_t* b, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// a box of the 2-D tensor map at (col, row) into shared memory, completing
// on mbarrier `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// K-major operand half tile with the 64-byte swizzle: rows of 64 bytes,
// 8-row groups 512 bytes apart
__device__ __forceinline__ uint64_t tile_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

// d = a . b (+ d where accumulate is nonzero)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// grid (N / 128, ceil(M / 256)); the whole K walk in one block. Thread 0
// brings each stage by TMA: the x tile (rows past M read as zeros) and the
// packed weight with its two scale rows. Warpgroup 1 dequantizes the
// packed tile into a bf16 weight tile; warpgroups 2 and 3 run wgmma on
// rows 128 (w - 2).. and release both tiles once their products are done.
// Every hand-over is an mbarrier.
__global__ void __launch_bounds__(kPThreads, 1)
qmm4_prefill(const __grid_constant__ CUtensorMap x_map,
             const __grid_constant__ CUtensorMap w_map,
             const __grid_constant__ CUtensorMap s_map, float* __restrict__ out,
             int M, int K2, int N) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* xt = smem;                         // x tile ring
  unsigned char* bt = xt + kPXSlots * kPXTile;      // bf16 weight tile ring
  unsigned char* raw = bt + kPBSlots * kPBTile;     // packed + scales ring
  uint64_t* x_full = reinterpret_cast<uint64_t*>(raw + kPRaw * kPRawBytes);
  uint64_t* x_empty = x_full + kPXSlots;
  uint64_t* b_full = x_empty + kPXSlots;
  uint64_t* b_empty = b_full + kPBSlots;
  uint64_t* r_full = b_empty + kPBSlots;
  uint64_t* r_empty = r_full + kPRaw;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n0 = blockIdx.x * kPBN;
  const int m0 = blockIdx.y * kPBM;
  const int steps = K2 / kPBK;

  if (tid == 0) {
    for (int s = 0; s < kPXSlots; ++s) {
      mbar_init(&x_full[s], 1);    // the loader, plus the bytes
      mbar_init(&x_empty[s], 2);   // one thread a wgmma warpgroup
    }
    for (int s = 0; s < kPBSlots; ++s) {
      mbar_init(&b_full[s], kPProducers);  // every dequantizing thread
      mbar_init(&b_empty[s], 2);
    }
    for (int s = 0; s < kPRaw; ++s) {
      mbar_init(&r_full[s], 1);
      mbar_init(&r_empty[s], kPProducers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- the loader: one thread ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kPLoaderRegs));
    if (tid == 0) {
      for (int step = 0; step < steps; ++step) {
        const int j0 = step * kPBK;
        const int xs = step % kPXSlots, rs = step % kPRaw;
        if (step >= kPXSlots)
          mbar_wait(&x_empty[xs], ((step / kPXSlots) + 1) & 1);
        unsigned char* a = xt + xs * kPXTile;
        mbar_expect(&x_full[xs], kPXTile);
        tma_load(a, &x_map, j0, m0, &x_full[xs]);
        tma_load(a + kPXHalf, &x_map, K2 + j0, m0, &x_full[xs]);
        if (step >= kPRaw)
          mbar_wait(&r_empty[rs], ((step / kPRaw) + 1) & 1);
        unsigned char* rw = raw + rs * kPRawBytes;
        mbar_expect(&r_full[rs], kPRawBytes);
        tma_load(rw, &w_map, n0, j0, &r_full[rs]);
        tma_load(rw + kPPacked, &s_map, n0, j0 / kGroup, &r_full[rs]);
        tma_load(rw + kPPacked + kPBN * 4, &s_map, n0, (K2 + j0) / kGroup,
                 &r_full[rs]);
      }
    }
  } else if (wg == 1) {
    // ---- dequantization: byte rows 8rg..8rg+7 (rg the warp), columns
    // 2cp, 2cp + 1 for cp = lane and lane + 32: one 16-byte store a column
    // and half ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kPProducerRegs));
    const int lane = tid & 31, rg = (tid >> 5) & 3;
    for (int step = 0; step < steps; ++step) {
      const int rs = step % kPRaw, bs = step % kPBSlots;
      mbar_wait(&r_full[rs], (step / kPRaw) & 1);
      const unsigned char* rw = raw + rs * kPRawBytes;
      uint32_t w[2][8];
      float sh16[2][2], sl[2][2];
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        const int cp = lane + 32 * hc;
        const float2 shv = *reinterpret_cast<const float2*>(
            rw + kPPacked + cp * 8);
        const float2 slv = *reinterpret_cast<const float2*>(
            rw + kPPacked + kPBN * 4 + cp * 8);
        sh16[hc][0] = shv.x * 0.0625f;
        sh16[hc][1] = shv.y * 0.0625f;
        sl[hc][0] = slv.x;
        sl[hc][1] = slv.y;
#pragma unroll
        for (int i = 0; i < 8; ++i)  // the 128-byte swizzle: chunk ^ row % 8
          w[hc][i] = *reinterpret_cast<const uint16_t*>(
              rw + (rg * 8 + i) * kPBN + (((cp >> 3) ^ i) << 4) +
              (cp & 7) * 2);
      }
      mbar_arrive(&r_empty[rs]);
      if (step >= kPBSlots)  // the products of stage step - kPBSlots
        mbar_wait(&b_empty[bs], ((step / kPBSlots) + 1) & 1);
      unsigned char* b = bt + bs * kPBTile;
#pragma unroll
      for (int hc = 0; hc < 2; ++hc)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const int n = (lane + 32 * hc) * 2 + bb;
          const uint32_t* v = w[hc];
          const float s16 = sh16[hc][bb], s = sl[hc][bb];
          uint4 hv, lv;
          hv.x = pack_bf16(hi_val(v[0], bb, s16), hi_val(v[1], bb, s16));
          hv.y = pack_bf16(hi_val(v[2], bb, s16), hi_val(v[3], bb, s16));
          hv.z = pack_bf16(hi_val(v[4], bb, s16), hi_val(v[5], bb, s16));
          hv.w = pack_bf16(hi_val(v[6], bb, s16), hi_val(v[7], bb, s16));
          lv.x = pack_bf16(lo_val(v[0], bb, s), lo_val(v[1], bb, s));
          lv.y = pack_bf16(lo_val(v[2], bb, s), lo_val(v[3], bb, s));
          lv.z = pack_bf16(lo_val(v[4], bb, s), lo_val(v[5], bb, s));
          lv.w = pack_bf16(lo_val(v[6], bb, s), lo_val(v[7], bb, s));
          // k = 8rg..8rg+7 of column n: chunk rg of each half tile
          *reinterpret_cast<uint4*>(b + swz64(n, rg)) = hv;
          *reinterpret_cast<uint4*>(b + kPBHalf + swz64(n, rg)) = lv;
        }
      // the weight tile (st.shared) is read by wgmma, through the async
      // proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&b_full[bs]);
    }
  } else {
    // ---- consumers: rows 128 (wg - 2).. of the tile, two 64-row halves ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kPConsumerRegs));
    const int ltid = tid & 127;
    // set by the first wgmma (no accumulate): an instruction other than
    // wgmma writing them would serialize the wgmma pipeline
    float d[2][64];
    for (int step = 0; step < steps; ++step) {
      const int xslot = step % kPXSlots, bslot = step % kPBSlots;
      mbar_wait(&x_full[xslot], (step / kPXSlots) & 1);
      mbar_wait(&b_full[bslot], (step / kPBSlots) & 1);
      const unsigned char* a = xt + xslot * kPXTile + (wg - 2) * 128 * 64;
      const unsigned char* b = bt + bslot * kPBTile;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // kk 0, 1: the high half tiles; 2, 3: the low
          const int off = (kk >> 1) * kPXHalf + h * 64 * 64 + (kk & 1) * 32;
          wgmma_m64n128k16(d[h], tile_desc(a + off),
                           tile_desc(b + (kk >> 1) * kPBHalf + (kk & 1) * 32),
                           step | kk);
        }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // stage step - 1's products are done: release its slots
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (step > 0 && ltid == 0) {
        mbar_arrive(&x_empty[(step - 1) % kPXSlots]);
        mbar_arrive(&b_empty[(step - 1) % kPBSlots]);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

    // accumulator layout: warp w of the warpgroup holds rows 16w + g (+ 8)
    // of each 64-row half h, columns 8i + 2t (+ 1)
    const int warp = (ltid >> 5), lane = ltid & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + (wg - 2) * 128 + h * 64 + warp * 16 + g + half * 8;
        if (r < M) {
          float* o = out + static_cast<long long>(r) * N + n0 + 2 * t;
#pragma unroll
          for (int i = 0; i < 16; ++i)
            *reinterpret_cast<float2*>(o + 8 * i) = make_float2(
                d[h][4 * i + 2 * half], d[h][4 * i + 2 * half + 1]);
        }
      }
  }
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  return encode;
}

// a 2-D tensor map over rows x cols elements at `ptr`, rows `pitch` bytes
// apart, in boxes of box_rows x box_cols
int encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
               long long rows, long long cols,
               long long pitch, int box_rows, int box_cols,
               CUtensorMapSwizzle swizzle) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims,
                            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int MT>
int launch_decode(const __nv_bfloat16* x, const uint8_t* wq, const float* ws,
                  float* out, int M, int K2, int N, int ldw, int lds,
                  int splits, int per, cudaStream_t st) {
  const int bytes = DecodeSmem<MT>::kBytes;
  static const cudaError_t set = cudaFuncSetAttribute(
      qmm4_decode<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaError_t err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, N / kDBN, (M + MT * 8 - 1) / (MT * 8));
  cfg.blockDim = dim3(kDThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, qmm4_decode<MT>, x, wq, ws, out, M, K2, N,
                           ldw, lds, per);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// x: [M, K] bf16, contiguous, 16-byte aligned. wq: [K/2, N] uint8 at row
// stride ldw (a multiple of 16, 16-byte aligned); ws: [K/128, N] f32 at row
// stride lds (a multiple of 4, 16-byte aligned). out: [M, N] f32. K/2 a
// multiple of 32 and N of 128. regime 0 (decode): m_tiles of 8 rows in
// {1, 2, 4, 8} per block, a cluster of `splits` <= 8 blocks along K, each
// walking `per` stages of 32 byte rows; regime 1 (prefill): 128 x 128
// tiles, splits and per unused. Launches on `stream` of card `device` and
// returns a CUDA error code (0 on success).
extern "C" int qmm4(const void* x, const void* wq, const void* ws, float* out,
                    int M, int K, int N, int ldw, int scale_rows, int lds,
                    int regime, int m_tiles, int splits, int per, int device,
                    void* stream) {
  const int K2 = K / 2;
  if (M < 1 || K2 % kDBK || N % kDBN || scale_rows * kGroup != K ||
      ldw % 16 || lds % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* w = static_cast<const uint8_t*>(wq);
  const auto* s = static_cast<const float*>(ws);
  if (regime == 1) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        qmm4_prefill, cudaFuncAttributeMaxDynamicSharedMemorySize, kPSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    CUtensorMap x_map, w_map, s_map;
    int err = encode_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K,
                         2LL * K, kPBM, kPBK, CU_TENSOR_MAP_SWIZZLE_64B);
    if (!err)
      err = encode_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, K2, N, ldw,
                       kPBK, kPBN, CU_TENSOR_MAP_SWIZZLE_128B);
    if (!err)
      err = encode_map(&s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws,
                       scale_rows, N, 4LL * lds, 1, kPBN,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err) return err;
    const dim3 grid(N / kPBN, (M + kPBM - 1) / kPBM);
    qmm4_prefill<<<grid, kPThreads, kPSmem, st>>>(x_map, w_map, s_map, out,
                                                  M, K2, N);
    return static_cast<int>(cudaGetLastError());
  }
  if (regime != 0 || splits < 1 || splits > 8 || per < 1 ||
      (splits - 1) * per >= K2 / kDBK || splits * per < K2 / kDBK)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (m_tiles) {
    case 1:
      return launch_decode<1>(xb, w, s, out, M, K2, N, ldw, lds, splits, per,
                              st);
    case 2:
      return launch_decode<2>(xb, w, s, out, M, K2, N, ldw, lds, splits, per,
                              st);
    case 4:
      return launch_decode<4>(xb, w, s, out, M, K2, N, ldw, lds, splits, per,
                              st);
    case 8:
      return launch_decode<8>(xb, w, s, out, M, K2, N, ldw, lds, splits, per,
                              st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
