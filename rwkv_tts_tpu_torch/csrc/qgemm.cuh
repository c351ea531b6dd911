// The quantized-weight GEMM body shared by csrc/qmm4.cu (int4 weights) and
// csrc/qmm.cu (int8 weights):
//
//     out[M, N] f32 = x[M, K] bf16 @ W[K, N]   (W made in bf16 from the
//                     quantized weight on the card; products take bf16
//                     operands and sum in f32)
//
// Two regimes, chosen by the wrapper from M (ops/quant.qmm4_plan,
// ops/quant.qmm_plan), each one launch per product:
//
// * decode rows (M <= 64), bound by bytes: outT = WT . xT on mma.sync
//   m16n8k16, so weight columns fill the instruction's 16-row side and the
//   batch rows its 8-wide side. A 256-thread block owns 128 columns and a
//   range of K; a 4-stage cp.async ring brings 64 weight byte rows
//   (8 KB, in an XOR swizzle that keeps the fragment loads conflict-free),
//   the format's scale rows and the matching x columns per stage. Each
//   thread reads one 32-bit word (4 columns of one byte row) of each of 4
//   rows of a 16-row unit and turns the words straight into A fragments:
//   no bf16 tile in shared memory. The K ranges of one column tile form a
//   thread-block cluster of up to 8 blocks; their partial tiles are added
//   through distributed shared memory in rank order, so the sum does not
//   depend on which block finishes first, and no second kernel runs.
// * prefill rows, bound by operations: a 256 x 128 output tile, 4
//   warpgroups joined by mbarriers. One thread of warpgroup 0 brings each
//   stage by TMA: the x tile (a tensor map encoded per call, in the 64-byte
//   swizzle that wgmma reads; rows past M arrive as zeros) and the weight
//   tile with the format's scale rows. Warpgroup 1 dequantizes the tile
//   into a bf16 weight tile (K-major, the same swizzle); warpgroups 2 and 3
//   each run wgmma m64n128k16 on 128 rows (two 64-row halves) and release
//   the stage's tiles once its products are done. setmaxnreg moves
//   registers from the loader and the dequantizer to the 128 accumulators
//   of each wgmma thread (40 / 88 / 192 / 192: keep every warpgroup whole;
//   a 13th warp caps every thread at 128 registers and the accumulators
//   spill). The dequantizing warpgroup, one warp per scheduler, is the
//   critical path (PERF.md).
//
// A weight format (qmm4_int4, qmm_int8 below) says how a stage's bytes
// become A fragments (decode) or the bf16 weight tile (prefill), how many
// k rows a byte row holds (int4 two: j and j + K/2; int8 one), and whether
// scales enter per stage (int4 groups) or once in the epilogue (int8
// columns). The formats' names appear in the kernels' names, which the
// profiler readings of chip_smoke.py key on.
//
// Everything sits in an unnamed namespace: qmm4 and qmm load into one
// process, and their kernels and host stubs must not resolve to each
// other's.

#pragma once

#include "sm90.cuh"

namespace {

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

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --------------------------------------------------------------------------
// the two regimes' geometry
// --------------------------------------------------------------------------

constexpr int kDBN = 128;            // output columns per block
constexpr int kDBK = 64;             // weight byte rows per stage (8 KB)
constexpr int kDStages = 4;
constexpr int kDThreads = 256;       // 4 column slabs x 2 halves of K
constexpr int kDPPitch = kDBN + 4;   // floats a partial-sum row

constexpr int kPBM = 256;
constexpr int kPBN = 128;
// rings deep enough that no warp waits for a stage still in flight
constexpr int kPXSlots = 4;          // x tiles (TMA), read by wgmma
constexpr int kPBSlots = 4;          // bf16 weight tiles, read by wgmma
constexpr int kPRaw = 4;             // quantized weight + scales (TMA)
constexpr int kPThreads = 512;       // loading, dequantizing and 2 wgmma
constexpr int kPProducers = 128;     // warpgroups
// setmaxnreg: each SM sub-partition holds one warp of each warpgroup,
// 40 + 88 + 2 x 192 = 512 registers a lane, its 16384
constexpr int kPLoaderRegs = 40;
constexpr int kPProducerRegs = 88;
constexpr int kPConsumerRegs = 192;
// a stage's K tile of 64 is two halves of 32, each rows of 32 bf16 (64
// bytes) in the 64-byte swizzle
constexpr int kPXHalf = kPBM * 64;
constexpr int kPBHalf = kPBN * 64;
constexpr int kPXTile = 2 * kPXHalf;
constexpr int kPBTile = 2 * kPBHalf;

// byte offset of 16-byte chunk c of row r in a 64-byte-swizzled half tile
__device__ __forceinline__ int swz64(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// --------------------------------------------------------------------------
// the weight formats
// --------------------------------------------------------------------------

// int4 (w4a16): byte row j holds row j in its high nibble and row j + K/2
// in its low nibble, each a two's-complement code in [-8, 7]; ws[K/128, N]
// f32 holds one scale per group of 128 rows and column. Each weight is
// (code * scale) in f32 rounded once to bf16, exactly: a nibble placed
// under the exponent of 2^23 gives 2^23 + (q ^ 8) as an f32, one
// subtraction gives the code (times 16 for the high nibble, whose scale is
// taken / 16, exact), one f32 product gives code * scale rounded once,
// cvt.rn gives bf16.
struct qmm4_int4 {
  static constexpr int kGroup = 128;   // rows per scale
  static constexpr bool kColumnScale = false;

  // code * scale of byte b's low nibble: 2^23 + (q ^ 8) - (2^23 + 8)
  __device__ static __forceinline__ float lo_val(uint32_t w, int b, float s) {
    const uint32_t v = ((w >> (8 * b)) & 0xFu) ^ 0x4B000008u;
    return (__uint_as_float(v) - 8388616.0f) * s;
  }

  // 16 * code of byte b's high nibble, times s16 = scale / 16
  __device__ static __forceinline__ float hi_val(uint32_t w, int b,
                                                 float s16) {
    const uint32_t v = ((w >> (8 * b)) & 0xF0u) ^ 0x4B000080u;
    return (__uint_as_float(v) - 8388736.0f) * s16;
  }

  static __host__ __device__ int rows(int K) { return K / 2; }
  static bool scales_fit(int K, int scale_rows, int lds) {
    return scale_rows * kGroup == K && lds % 4 == 0;
  }

  // ---- decode regime: a stage is 64 byte rows, k = j.. and K/2 + j..;
  // its x rows are the hi columns then the lo columns ----
  static constexpr int kDScaleBytes = 2 * kDBN * 4;    // hi, lo scales
  static constexpr int kDXPitch = 4 * kDBK + 32;       // bytes an x row
  static constexpr int kDXChunks = kDBK / 4;           // 16-byte chunks

  __device__ static __forceinline__ int x_col(int c, int j0, int K2) {
    return (c / (kDXChunks / 2)) * K2 + j0 + (c % (kDXChunks / 2)) * 8;
  }

  // 2 scale rows x 32 chunks
  __device__ static __forceinline__ void issue_scales(
      unsigned char* dst, const float* __restrict__ ws, int lds, int j0,
      int K2, int n0, int tid) {
    if (tid < 64) {
      const int h = tid >> 5, c = tid & 31;
      const int row = (j0 + h * K2) / kGroup;
      cp16(dst + h * kDBN * 4 + c * 16,
           ws + static_cast<long long>(row) * lds + n0 + c * 4, true);
    }
  }

  struct Scales {
    float sh16[4], sl[4];
  };

  __device__ static __forceinline__ Scales stage_scales(
      const unsigned char* s, int warp, int g) {
    const float4 shv =
        *reinterpret_cast<const float4*>(s + (warp * 32 + 4 * g) * 4);
    const float4 slv = *reinterpret_cast<const float4*>(
        s + kDBN * 4 + (warp * 32 + 4 * g) * 4);
    return {{shv.x * 0.0625f, shv.y * 0.0625f, shv.z * 0.0625f,
             shv.w * 0.0625f},
            {slv.x, slv.y, slv.z, slv.w}};
  }

  // the A fragments of two k-chunks (j and j + K/2) from the words, and
  // their products with the matching x columns of every m-tile
  template <int MT>
  __device__ static __forceinline__ void unit(
      float (&acc)[MT][2][4], const uint32_t (&w)[4], const Scales& sc,
      const __nv_bfloat16* xs, int u, int g, int t) {
    const float* sh16 = sc.sh16;
    const float* sl = sc.sl;
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

  // ---- prefill regime: a stage is 32 byte rows, k = j.. (high nibbles)
  // and k = K/2 + j.. (low nibbles) as the two halves of one 64-deep K
  // tile; the packed tile arrives in the 128-byte swizzle with its two
  // scale rows ----
  static constexpr int kPRows = 32;                  // byte rows a stage
  static constexpr int kPRawBytes = kPRows * kPBN + 2 * kPBN * 4;

  // the x columns j0.. and K2 + j0..
  __device__ static __forceinline__ void load_x(
      unsigned char* a, const CUtensorMap* x_map, int step, int m0, int K2,
      uint64_t* bar) {
    const int j0 = step * kPRows;
    tma_load(a, x_map, j0, m0, bar);
    tma_load(a + kPXHalf, x_map, K2 + j0, m0, bar);
  }

  // the packed rows j0.. and their two scale rows
  __device__ static __forceinline__ void load_raw(
      unsigned char* rw, const CUtensorMap* w_map, const CUtensorMap* s_map,
      int step, int n0, int K2, uint64_t* bar) {
    const int j0 = step * kPRows;
    tma_load(rw, w_map, n0, j0, bar);
    tma_load(rw + kPRows * kPBN, s_map, n0, j0 / kGroup, bar);
    tma_load(rw + kPRows * kPBN + kPBN * 4, s_map, n0, (K2 + j0) / kGroup,
             bar);
  }

  // byte rows 8rg..8rg+7 (rg the warp), columns 2cp, 2cp + 1 for cp =
  // lane and lane + 32
  struct Raw {
    uint32_t w[2][8];
    float sh16[2][2], sl[2][2];
  };

  __device__ static __forceinline__ Raw read_raw(const unsigned char* rw,
                                                 int lane, int rg) {
    Raw r;
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      const int cp = lane + 32 * hc;
      const float2 shv = *reinterpret_cast<const float2*>(
          rw + kPRows * kPBN + cp * 8);
      const float2 slv = *reinterpret_cast<const float2*>(
          rw + kPRows * kPBN + kPBN * 4 + cp * 8);
      r.sh16[hc][0] = shv.x * 0.0625f;
      r.sh16[hc][1] = shv.y * 0.0625f;
      r.sl[hc][0] = slv.x;
      r.sl[hc][1] = slv.y;
#pragma unroll
      for (int i = 0; i < 8; ++i)  // the 128-byte swizzle: chunk ^ row % 8
        r.w[hc][i] = *reinterpret_cast<const uint16_t*>(
            rw + (rg * 8 + i) * kPBN + (((cp >> 3) ^ i) << 4) +
            (cp & 7) * 2);
    }
    return r;
  }

  // one 16-byte store a column and half
  __device__ static __forceinline__ void write_tile(const Raw& r,
                                                    unsigned char* b,
                                                    int lane, int rg) {
#pragma unroll
    for (int hc = 0; hc < 2; ++hc)
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const int n = (lane + 32 * hc) * 2 + bb;
        const uint32_t* v = r.w[hc];
        const float s16 = r.sh16[hc][bb], s = r.sl[hc][bb];
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
  }
};

// int8: wq[K, N] int8, one k row a byte row; ws[1, N] f32 holds one scale
// a column, which multiplies the whole sum once, in the epilogue (as
// qmm_plain and the TPU body do). A byte becomes bf16 exactly (|q| <= 127
// has at most 8 significant bits) and without a scale: the word's bytes
// are flipped to q + 128 once (w ^ 0x80808080), a prmt puts one byte under
// the exponent of 2^23, giving 2^23 + q + 128 as an f32, and one
// subtraction gives q.
struct qmm_int8 {
  static constexpr bool kColumnScale = true;
  // prmt selector of byte b (| b): 0x4B, 0, 0, byte b of the word
  static constexpr uint32_t kSel = 0x7650u;

  // q of the byte that sel picks from the flipped word v
  __device__ static __forceinline__ float val(uint32_t v, uint32_t sel) {
    return __uint_as_float(__byte_perm(v, 0x4B000000u, sel)) - 8388736.0f;
  }

  static __host__ __device__ int rows(int K) { return K; }
  static bool scales_fit(int, int scale_rows, int) { return scale_rows == 1; }

  // ---- decode regime: a stage is 64 rows, k = j0..; its x rows are 64
  // columns, 160 bytes apart (32 mod 128: conflict-free fragment loads) ----
  static constexpr int kDScaleBytes = 0;
  static constexpr int kDXPitch = 2 * kDBK + 32;
  static constexpr int kDXChunks = kDBK / 8;

  __device__ static __forceinline__ int x_col(int c, int j0, int) {
    return j0 + c * 8;
  }

  __device__ static __forceinline__ void issue_scales(
      unsigned char*, const float* __restrict__, int, int, int, int, int) {}

  struct Scales {};

  __device__ static __forceinline__ Scales stage_scales(const unsigned char*,
                                                        int, int) {
    return {};
  }

  // the A fragments of one k-chunk from the words (the words' k slots
  // 2t, 2t+1, 2t+8, 2t+9 are rows 4t + s, and so are the x columns
  // u*16 + 4t + s), and their products with every m-tile
  template <int MT>
  __device__ static __forceinline__ void unit(
      float (&acc)[MT][2][4], const uint32_t (&w)[4], const Scales&,
      const __nv_bfloat16* xs, int u, int g, int t) {
    uint32_t v[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) v[s] = w[s] ^ 0x80808080u;
    uint32_t a[2][4];  // [n-tile][reg]
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const uint32_t s0 = kSel | (2 * nt), s1 = kSel | (2 * nt + 1);
      a[nt][0] = pack_bf16(val(v[0], s0), val(v[1], s0));
      a[nt][1] = pack_bf16(val(v[0], s1), val(v[1], s1));
      a[nt][2] = pack_bf16(val(v[2], s0), val(v[3], s0));
      a[nt][3] = pack_bf16(val(v[2], s1), val(v[3], s1));
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint2 bb = *reinterpret_cast<const uint2*>(
          xs + (mt * 8 + g) * (kDXPitch / 2) + u * 16 + 4 * t);
      mma16816(acc[mt][0], a[0], bb.x, bb.y);
      mma16816(acc[mt][1], a[1], bb.x, bb.y);
    }
  }

  // ---- prefill regime: a stage is 64 rows, one K tile, whose two halves
  // are k0.. and k0 + 32..; the tile arrives in the 128-byte swizzle ----
  static constexpr int kPRows = 64;
  static constexpr int kPRawBytes = kPRows * kPBN;

  __device__ static __forceinline__ void load_x(
      unsigned char* a, const CUtensorMap* x_map, int step, int m0, int,
      uint64_t* bar) {
    const int k0 = step * kPRows;
    tma_load(a, x_map, k0, m0, bar);
    tma_load(a + kPXHalf, x_map, k0 + 32, m0, bar);
  }

  __device__ static __forceinline__ void load_raw(
      unsigned char* rw, const CUtensorMap* w_map, const CUtensorMap*,
      int step, int n0, int, uint64_t* bar) {
    tma_load(rw, w_map, n0, step * kPRows, bar);
  }

  // rows 16rg..16rg+15 (rg the warp), one word (columns 4 lane..) of each
  struct Raw {
    uint32_t w[16];
  };

  __device__ static __forceinline__ Raw read_raw(const unsigned char* rw,
                                                 int lane, int rg) {
    Raw r;
#pragma unroll
    for (int i = 0; i < 16; ++i)  // the 128-byte swizzle: chunk ^ row % 8
      r.w[i] = *reinterpret_cast<const uint32_t*>(
          rw + (rg * 16 + i) * kPBN + (((lane >> 2) ^ (i & 7)) << 4) +
          (lane & 3) * 4);
    return r;
  }

  // k = 16rg.. of the tile: half rg / 2, chunks 2 (rg % 2) and the next;
  // one 16-byte store a column and chunk. Store j of lane l takes byte
  // (j + l + l / 4) % 4 of its words, so the 8 lanes of a quarter warp
  // write 8 different 16-byte bank groups.
  __device__ static __forceinline__ void write_tile(const Raw& r,
                                                    unsigned char* b,
                                                    int lane, int rg) {
    uint32_t v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = r.w[i] ^ 0x80808080u;
    unsigned char* half = b + (rg >> 1) * kPBHalf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int byte = (j + lane + (lane >> 2)) & 3;
      const int n = 4 * lane + byte;
      const uint32_t sel = kSel | byte;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t* e = v + 8 * q;
        uint4 o;
        o.x = pack_bf16(val(e[0], sel), val(e[1], sel));
        o.y = pack_bf16(val(e[2], sel), val(e[3], sel));
        o.z = pack_bf16(val(e[4], sel), val(e[5], sel));
        o.w = pack_bf16(val(e[6], sel), val(e[7], sel));
        *reinterpret_cast<uint4*>(half + swz64(n, 2 * (rg & 1) + q)) = o;
      }
    }
  }
};

// --------------------------------------------------------------------------
// decode regime
// --------------------------------------------------------------------------

template <class F, int MT>
struct DecodeSmem {
  static constexpr int kW = kDBK * kDBN;               // weight bytes
  static constexpr int kS = F::kDScaleBytes;
  static constexpr int kX = MT * 8 * F::kDXPitch;
  static constexpr int kStage = kW + kS + kX;
  static constexpr int kRing = kDStages * kStage;
  static constexpr int kPart = MT * 8 * kDPPitch * 4;
  static constexpr int kBytes = kRing > kPart ? kRing : kPart;
};

// grid (splits, N / 128, ceil(M / (8 MT))), cluster (splits, 1, 1): block
// x of a cluster walks the stages [x * per, (x + 1) * per) of 64 byte rows
// of the `rows` the weight has.
template <class F, int MT>
__global__ void __launch_bounds__(kDThreads)
qgemm_decode(const __nv_bfloat16* __restrict__ x,
             const uint8_t* __restrict__ wq, const float* __restrict__ ws,
             float* __restrict__ out, int M, int rows, int K, int N, int ldw,
             int lds, int per) {
  using Sm = DecodeSmem<F, MT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & 3, wk = tid >> 7;  // column slab, K half
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * kDBN;
  const int m0 = blockIdx.z * MT * 8;
  const int total = rows / kDBK;
  const int s_begin = blockIdx.x * per;
  const int steps = max(0, min(total, s_begin + per) - s_begin);

  auto issue = [&](int step, int slot) {
    unsigned char* st = smem + slot * Sm::kStage;
    const int j0 = (s_begin + step) * kDBK;
#pragma unroll
    for (int idx = tid; idx < kDBK * 8; idx += kDThreads) {  // weight rows:
      const int r = idx >> 3, c = idx & 7;  // chunk c ^ 2 ((r / 4) % 4)
      cp16(st + r * kDBN + ((c ^ (((r >> 2) & 3) << 1)) << 4),
           wq + static_cast<long long>(j0 + r) * ldw + n0 + c * 16, true);
    }
    F::issue_scales(st + Sm::kW, ws, lds, j0, rows, n0, tid);
    constexpr int kXC = F::kDXChunks;       // 16-byte chunks an x row
    for (int idx = tid; idx < MT * 8 * kXC; idx += kDThreads) {  // x rows
      const int r = idx / kXC, c = idx % kXC;
      const int col = F::x_col(c, j0, rows);
      const bool ok = m0 + r < M;
      cp16(st + Sm::kW + Sm::kS + r * F::kDXPitch + c * 16,
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
    const typename F::Scales sc = F::stage_scales(st + Sm::kW, warp, g);
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(st + Sm::kW + Sm::kS);
#pragma unroll
    for (int uu = 0; uu < kDBK / 32; ++uu) {
      // the warps of K half wk take the 16-row units u = wk, wk + 2, ..:
      // thread (g, t) holds rows u*16 + 4t + s, columns 4g..4g+3 of its
      // warp's 32 (the fragment's k slots 2t, 2t+1, 2t+8, 2t+9 are rows
      // s = 0..3, and the x columns u*16 + 4t + s match them)
      const int u = wk + 2 * uu;
      uint32_t w[4];
      const int wc = (((warp * 2 + (g >> 2)) ^ (t << 1)) << 4) + (g & 3) * 4;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        w[s] = *reinterpret_cast<const uint32_t*>(
            st + (u * 16 + 4 * t + s) * kDBN + wc);
      F::template unit<MT>(acc, w, sc, xs, u, g, t);
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
    // a column scale multiplies the whole sum once
    if constexpr (F::kColumnScale) v *= ws[n0 + c];
    out[static_cast<long long>(m0 + r) * N + n0 + c] = v;
  }
  cluster.sync();  // keep this block's tile alive until the others are done
}

// --------------------------------------------------------------------------
// prefill regime
// --------------------------------------------------------------------------

template <class F>
struct PrefillSmem {
  static constexpr int kBytes = kPXSlots * kPXTile + kPBSlots * kPBTile +
                                kPRaw * F::kPRawBytes +
                                2 * (kPXSlots + kPBSlots + kPRaw) * 8 +
                                1024;  // + barriers, alignment
};

// grid (N / 128, ceil(M / 256)); the whole K walk in one block. Thread 0
// brings each stage by TMA: the x tile (rows past M read as zeros) and the
// quantized weight tile with its scale rows. Warpgroup 1 dequantizes it
// into a bf16 weight tile; warpgroups 2 and 3 run wgmma on rows
// 128 (w - 2).. and release both tiles once their products are done.
// Every hand-over is an mbarrier. `ws` is read by a format with a column
// scale (its epilogue), `s_map` by one with group scales.
template <class F>
__global__ void __launch_bounds__(kPThreads, 1)
qgemm_prefill(const __grid_constant__ CUtensorMap x_map,
              const __grid_constant__ CUtensorMap w_map,
              const __grid_constant__ CUtensorMap s_map,
              const float* __restrict__ ws, float* __restrict__ out, int M,
              int rows, int N) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* xt = smem;                         // x tile ring
  unsigned char* bt = xt + kPXSlots * kPXTile;      // bf16 weight tile ring
  unsigned char* raw = bt + kPBSlots * kPBTile;     // quantized ring
  uint64_t* x_full =
      reinterpret_cast<uint64_t*>(raw + kPRaw * F::kPRawBytes);
  uint64_t* x_empty = x_full + kPXSlots;
  uint64_t* b_full = x_empty + kPXSlots;
  uint64_t* b_empty = b_full + kPBSlots;
  uint64_t* r_full = b_empty + kPBSlots;
  uint64_t* r_empty = r_full + kPRaw;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n0 = blockIdx.x * kPBN;
  const int m0 = blockIdx.y * kPBM;
  const int steps = rows / F::kPRows;

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
        const int xs = step % kPXSlots, rs = step % kPRaw;
        if (step >= kPXSlots)
          mbar_wait(&x_empty[xs], ((step / kPXSlots) + 1) & 1);
        unsigned char* a = xt + xs * kPXTile;
        mbar_expect(&x_full[xs], kPXTile);
        F::load_x(a, &x_map, step, m0, rows, &x_full[xs]);
        if (step >= kPRaw)
          mbar_wait(&r_empty[rs], ((step / kPRaw) + 1) & 1);
        unsigned char* rw = raw + rs * F::kPRawBytes;
        mbar_expect(&r_full[rs], F::kPRawBytes);
        F::load_raw(rw, &w_map, &s_map, step, n0, rows, &r_full[rs]);
      }
    }
  } else if (wg == 1) {
    // ---- dequantization ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kPProducerRegs));
    const int lane = tid & 31, rg = (tid >> 5) & 3;
    for (int step = 0; step < steps; ++step) {
      const int rs = step % kPRaw, bs = step % kPBSlots;
      mbar_wait(&r_full[rs], (step / kPRaw) & 1);
      const typename F::Raw r =
          F::read_raw(raw + rs * F::kPRawBytes, lane, rg);
      mbar_arrive(&r_empty[rs]);
      if (step >= kPBSlots)  // the products of stage step - kPBSlots
        mbar_wait(&b_empty[bs], ((step / kPBSlots) + 1) & 1);
      F::write_tile(r, bt + bs * kPBTile, lane, rg);
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
    // wgmma writing them would serialize the wgmma pipeline (ptxas C7515)
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
          // kk 0, 1: the first half tiles; 2, 3: the second
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
          for (int i = 0; i < 16; ++i) {
            float2 v = make_float2(d[h][4 * i + 2 * half],
                                   d[h][4 * i + 2 * half + 1]);
            if constexpr (F::kColumnScale) {  // once, after the whole sum
              const float2 s = *reinterpret_cast<const float2*>(
                  ws + n0 + 2 * t + 8 * i);
              v.x *= s.x;
              v.y *= s.y;
            }
            *reinterpret_cast<float2*>(o + 8 * i) = v;
          }
        }
      }
  }
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

// the format's scale map: int4's group scales, one box of 128 columns a
// row; none for a column scale, which the epilogue reads from `ws`
template <class F>
int encode_scales(CUtensorMap* map, const void* ws, int scale_rows, int N,
                  int lds) {
  if constexpr (F::kColumnScale) {
    *map = CUtensorMap{};
    return 0;
  } else {
    return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws, scale_rows,
                      N, 4LL * lds, 1, kPBN, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
}

template <class F, int MT>
int launch_decode(const __nv_bfloat16* x, const uint8_t* wq, const float* ws,
                  float* out, int M, int rows, int K, int N, int ldw, int lds,
                  int splits, int per, cudaStream_t st) {
  const int bytes = DecodeSmem<F, MT>::kBytes;
  static const cudaError_t set = cudaFuncSetAttribute(
      qgemm_decode<F, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
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
  err = cudaLaunchKernelEx(&cfg, qgemm_decode<F, MT>, x, wq, ws, out, M,
                           rows, K, N, ldw, lds, per);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// One product in format F: the C entry points' common body. x: [M, K]
// bf16, contiguous, 16-byte aligned. wq: [F::rows(K), N] bytes at row
// stride ldw (a multiple of 16, 16-byte aligned); ws: the format's scales,
// scale_rows rows at row stride lds (a multiple of 4, 16-byte aligned).
// out: [M, N] f32. F::rows(K) a multiple of 64 and N of 128. regime 0
// (decode): m_tiles of 8 rows in {1, 2, 4, 8} per block, a cluster of
// `splits` <= 8 blocks along K, each walking `per` stages of 64 byte rows;
// regime 1 (prefill): 256 x 128 tiles, m_tiles, splits and per unused.
// Launches on `stream` of card `device` and returns a CUDA error code (0
// on success).
template <class F>
int run(const void* x, const void* wq, const void* ws, float* out, int M,
        int K, int N, int ldw, int scale_rows, int lds, int regime,
        int m_tiles, int splits, int per, int device, void* stream) {
  const int rows = F::rows(K);
  if (M < 1 || rows < kDBK || rows % kDBK || N < kDBN || N % kDBN ||
      ldw % 16 || !F::scales_fit(K, scale_rows, lds))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* w = static_cast<const uint8_t*>(wq);
  const auto* s = static_cast<const float*>(ws);
  if (regime == 1) {
    constexpr int smem = PrefillSmem<F>::kBytes;
    static const cudaError_t attr = cudaFuncSetAttribute(
        qgemm_prefill<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    CUtensorMap x_map, w_map, s_map;
    int err = encode_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K,
                         2LL * K, kPBM, 32, CU_TENSOR_MAP_SWIZZLE_64B);
    if (!err)
      err = encode_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, rows, N,
                       ldw, F::kPRows, kPBN, CU_TENSOR_MAP_SWIZZLE_128B);
    if (!err) err = encode_scales<F>(&s_map, ws, scale_rows, N, lds);
    if (err) return err;
    const dim3 grid(N / kPBN, (M + kPBM - 1) / kPBM);
    qgemm_prefill<F><<<grid, kPThreads, smem, st>>>(x_map, w_map, s_map, s,
                                                    out, M, rows, N);
    return static_cast<int>(cudaGetLastError());
  }
  if (regime != 0 || splits < 1 || splits > 8 || per < 1 ||
      (splits - 1) * per >= rows / kDBK || splits * per < rows / kDBK)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (m_tiles) {
    case 1:
      return launch_decode<F, 1>(xb, w, s, out, M, rows, K, N, ldw, lds,
                                 splits, per, st);
    case 2:
      return launch_decode<F, 2>(xb, w, s, out, M, rows, K, N, ldw, lds,
                                 splits, per, st);
    case 4:
      return launch_decode<F, 4>(xb, w, s, out, M, rows, K, N, ldw, lds,
                                 splits, per, st);
    case 8:
      return launch_decode<F, 8>(xb, w, s, out, M, rows, K, N, ldw, lds,
                                 splits, per, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
