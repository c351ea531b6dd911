// Stride-1 dilated 1-D convolution with an optional snake prologue on the
// input and a residual add in the epilogue.
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
// generator's widths), bytes for k = 1 and for the short windows' input
// conv (its 1024 x 1536 x 7 weights, 22 MB in bf16, against 202 columns).
//
// bf16 compute takes the weights packed once, at load, as bf16 [K, O, Ci_p]
// (tap-major, Ci contiguous, padded with zeros to a multiple of 32;
// ops/conv1d.pack_weight), and runs two entries, each one launch a call:
//
// * conv1d_prologue writes xs = X' in bf16, chunk-planar [B, Ci_p / 8, T8,
//   8] (channel c of column t at [b, c / 8, t, c % 8]; T8 = T rounded up to
//   a multiple of 8, the columns past T zero), through a shared-memory
//   transpose: one read of x in 512-byte runs (16 bytes a lane), 512-byte
//   runs of writes, the snake evaluated once an element (sinf, no
//   fast-math). Bound by bytes.
// * conv1d, the implicit GEMM out[t, o] = sum_(k, c) xs[b, t + k*dil - pad,
//   c] . Wk[o, c]: T on the 64-row side of wgmma, O on its N side (96 or
//   192, so the wave generator's widths tile exactly). A block walks its
//   32-channel slabs; one thread of the loader warp brings each slab's x
//   once by TMA, with the halo its K taps need: a box of 4 chunks x (bm +
//   dil*(K - 1), from a multiple of 8, rounded up to 8) rows of the 3-D map
//   (64 elements = 8 columns x 8 channels, T8 / 8, B * Ci_p / 8), 128-byte
//   rows that TMA moves whole, rows before 0 and past T8 zero-filled (the
//   conv's padding, never the next batch row), landing as 4 planes of
//   16-byte rows: wgmma's K-major layout without swizzle, so tap k reads
//   the same slab at row lead + k*dil, a 16-byte offset, and no tap
//   reloads x. Then the slab's K weight tiles Wk[o0.., c0..]
//   (64-byte swizzle), each its own ring slot. mbarriers hand slots over;
//   one or two consumer warpgroups run wgmma m64nNk16 on 64 rows of t each
//   and release a slot once its products are done. The epilogue stages the
//   f32 tile in shared memory as [o][t], adds the bias and the residual in
//   f32, casts once and stores along t, 4 columns a thread where rows are
//   16-byte aligned. A tile's slabs may be split over a thread-block
//   cluster of up to 8 blocks (ops/conv1d.conv1d_plan: short T, few
//   tiles); their partial tiles are added through distributed shared
//   memory in rank order, so the sum does not depend on which block
//   finishes first, and no atomics and no second kernel run. What bounds
//   it on the card (PERF.md): at k = 7 the weight tiles' traffic from L2
//   to the SMs (every block reads its weight slice whole: ~280 MB in
//   0.040 ms at 384 channels, T 8080), at k = 1 the epilogue's bytes.
//
// f32 compute (off the serving paths), conv1d_f32: a block owns a 64 (O) x
// 128 (T) output tile and loops over Ci in slabs of 32, staging the x slab
// with its halo transposed to [t][c] (the snake runs while staging) and
// the K weight slabs from the [O, Ci, K] tensor as it lies; 8 warps of
// plain FFMA, the tile staged in shared memory and written along t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float load_any(const void* p, long long i,
                                          int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store_any(void* p, long long i, float v,
                                          int is_bf16) {
  if (is_bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4 consecutive elements from index i (a multiple of 4, 16-byte aligned)
__device__ __forceinline__ float4 load4(const void* p, long long i,
                                        int is_bf16) {
  if (!is_bf16) return *reinterpret_cast<const float4*>(
      static_cast<const float*>(p) + i);
  const uint2 u = *reinterpret_cast<const uint2*>(
      static_cast<const __nv_bfloat16*>(p) + i);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const
                                       __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const
                                       __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(void* p, long long i, float4 v,
                                       int is_bf16) {
  if (!is_bf16) {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = v;
    return;
  }
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) =
      make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// --------------------------------------------------------------------------
// the prologue: xs = bf16(X'), chunk-planar [B, Ci_p / 8, T8, 8] (T8 = T
// rounded up to a multiple of 8), zero for Ci <= c < Ci_p and T <= t < T8
// --------------------------------------------------------------------------

constexpr int kPC = 32;        // channels a block: 4 chunks of 8
constexpr int kPT = 128;       // columns a block
constexpr int kPThreads = 256;
constexpr int kPPitch = kPT + 4;  // floats a channel row of the tile

__device__ __forceinline__ float snake_bf16(float v, float al, bool snaked) {
  float e = round_bf16(v);
  if (snaked) {
    const float s = sinf(al * e);
    e = e + (s * s) / (al + 1e-9f);
  }
  return e;
}

__global__ void __launch_bounds__(kPThreads)
conv1d_prologue_kernel(const void* __restrict__ x,
                       const float* __restrict__ alpha,
                       __nv_bfloat16* __restrict__ xs, int Ci, int Ci_p,
                       int T, int T8, int x_bf16, int vec) {
  __shared__ __align__(16) float tile[kPC][kPPitch];  // [c][t]
  const int t0 = blockIdx.x * kPT, c0 = blockIdx.y * kPC, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool snaked = alpha != nullptr;
  // warp w reads channel rows w, w + 8, .. along t: 4 columns a lane
  // (16-byte loads, 512 bytes a row) where rows are 16-byte aligned
#pragma unroll
  for (int j = 0; j < kPC / 8; ++j) {
    const int cl = warp + 8 * j, c = c0 + cl;
    const float al = snaked && c < Ci ? alpha[c] : 0.0f;
    const long long row = (static_cast<long long>(b) * Ci + c) * T;
    const int tl = 4 * lane, t = t0 + tl;
    float4 e = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c < Ci && vec && t < T) {
      const float4 v = load4(x, row + t, x_bf16);
      e = make_float4(snake_bf16(v.x, al, snaked), snake_bf16(v.y, al, snaked),
                      snake_bf16(v.z, al, snaked), snake_bf16(v.w, al, snaked));
    } else if (c < Ci && !vec) {
      auto at = [&](int i) {
        return t + i < T
                   ? snake_bf16(load_any(x, row + t + i, x_bf16), al, snaked)
                   : 0.0f;
      };
      e = make_float4(at(0), at(1), at(2), at(3));
    }
    *reinterpret_cast<float4*>(&tile[cl][tl]) = e;
  }
  __syncthreads();
  // and writes chunk c0 / 8 + (w % 4) of xs, columns 32 (w / 4) + 64 h..:
  // 16 bytes a lane, 512 along t
  const int chunk = c0 / 8 + (warp & 3);
  if (chunk * 8 >= Ci_p) return;
  __nv_bfloat16* plane =
      xs + (static_cast<long long>(b) * (Ci_p / 8) + chunk) * T8 * 8;
#pragma unroll
  for (int h = 0; h < kPT / 64; ++h) {
    const int tl = 32 * (warp >> 2) + 64 * h + lane, t = t0 + tl;
    if (t >= T8) break;
    const float* v = &tile[8 * (warp & 3)][tl];
    uint4 u;
    u.x = pack_bf16(v[0], v[kPPitch]);
    u.y = pack_bf16(v[2 * kPPitch], v[3 * kPPitch]);
    u.z = pack_bf16(v[4 * kPPitch], v[5 * kPPitch]);
    u.w = pack_bf16(v[6 * kPPitch], v[7 * kPPitch]);
    *reinterpret_cast<uint4*>(plane + static_cast<long long>(t) * 8) = u;
  }
}

// --------------------------------------------------------------------------
// the implicit GEMM: TMA + wgmma
// --------------------------------------------------------------------------

constexpr int kStageC = 32;          // input channels a slab
constexpr int kMaxRows = 256;        // x rows a slab: a TMA box's limit
constexpr int kXBytes = 48 * 1024;   // the x ring: as many slabs as fit
constexpr int kRingBytes = 110 * 1024;  // both rings: two blocks fit an SM
constexpr int kMaxRing = 8;          // slots a ring at most

// a BM (t) x BN (o) output tile: BM / 64 consumer warpgroups and one
// loader warp. Two rings: x slabs (each 32 channels of the R = BM +
// dil * (K - 1) rows the K taps read, as 4 planes of 8 channels, R rows of
// 16 bytes: wgmma's K-major layout without swizzle, which a tap reads at
// any row offset; kXBytes / (64 R) of them, at most 8) and weight tiles
// (BN rows of 32 channels, 64 bytes in the 64-byte swizzle), one a (slab,
// tap); the f32 tile staged as [o][t] in the rings' memory once every
// stage is consumed (ops/conv1d._smem mirrors this)
template <int BM, int BN>
struct Conv {
  static constexpr int kWG = BM / 64;
  static constexpr int kThreads = 128 * kWG + 32;
  static constexpr int kB = BN * 64;
  static constexpr int kWRing = (kRingBytes - kXBytes) / kB < kMaxRing
                                    ? (kRingBytes - kXBytes) / kB
                                    : kMaxRing;
  static constexpr int kRings = kXBytes + kWRing * kB;
  static constexpr int kPitch = BM + 4;  // floats a staged o row
  static constexpr int kPart = BN * kPitch * 4;
  static constexpr int kBody = kRings > kPart ? kRings : kPart;
  static constexpr int kSmem =
      kBody + 2 * (kMaxRing + kWRing) * 8 + 1024;  // + barriers, alignment
  static_assert(kSmem <= kMaxSmem, "conv1d tile does not fit");
};

template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da,
                                    uint64_t db, int accumulate) {
  if constexpr (BN == 96)
    wgmma_m64n96k16(d, da, db, accumulate);
  else
    wgmma_m64n192k16(d, da, db, accumulate);
}

// K-major operand without swizzle: core matrices of 8 rows x 16 bytes,
// rows 16 bytes apart (8-row groups 128 bytes apart), the next 8 channels
// `plane` bytes on
__device__ __forceinline__ uint64_t plane_desc(const void* p, int plane) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(plane >> 4) << 16) | (8ull << 32);
}

// grid (t tiles x cluster, o tiles, B), cluster (cluster, 1, 1): block
// rank r of a cluster walks the slabs [r * per, (r + 1) * per) of
// `slabs`, each with its K taps
template <int BM, int BN>
__global__ void __launch_bounds__(Conv<BM, BN>::kThreads)
conv1d_wgmma(const __grid_constant__ CUtensorMap x_map,
             const __grid_constant__ CUtensorMap w_map,
             const float* __restrict__ bias, const void* __restrict__ res,
             void* __restrict__ y, int O, int T_out, int K, int dil, int pad,
             int slabs, int per, int res_bf16, int y_bf16, int vec4) {
  using G = Conv<BM, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* xring = smem;
  unsigned char* wring = smem + kXBytes;
  uint64_t* x_full = reinterpret_cast<uint64_t*>(smem + G::kBody);
  uint64_t* x_empty = x_full + kMaxRing;
  uint64_t* w_full = x_empty + kMaxRing;
  uint64_t* w_empty = w_full + G::kWRing;
  float* part = reinterpret_cast<float*>(smem);

  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, wg = tid >> 7;
  const int t0 = (blockIdx.x / ranks) * BM;
  const int o0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int s0 = rank * per;
  const int nslabs = max(0, min(slabs, s0 + per) - s0);
  // the slab's rows start at a multiple of 8 (the map's 128-byte rows of
  // 8 columns), `lead` rows before the first one a tap reads
  const int lead = (((t0 - pad) % 8) + 8) % 8;
  const int rows = (lead + BM + dil * (K - 1) + 7) / 8 * 8;
  const int plane = rows * 16;                 // one chunk of a slab
  const int x_slots = min(kMaxRing, kXBytes / (4 * plane));

  if (tid == 0) {
    for (int s = 0; s < x_slots; ++s) {
      mbar_init(&x_full[s], 1);        // the loader, plus the bytes
      mbar_init(&x_empty[s], G::kWG);  // one thread a consumer warpgroup
    }
    for (int s = 0; s < G::kWRing; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], G::kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // set by the first wgmma (no accumulate): an instruction other than
  // wgmma writing them would serialize the wgmma pipeline (ptxas C7515)
  float d[BN / 2];
  if (wg == G::kWG) {
    // ---- the loader: one thread; a slab's x, then its K weight tiles ----
    if (tid == 128 * G::kWG) {
      for (int j = 0, i = 0; j < nslabs; ++j) {
        const int xs = j % x_slots, c0 = (s0 + j) * kStageC;
        if (j >= x_slots) mbar_wait(&x_empty[xs], ((j / x_slots) + 1) & 1);
        mbar_expect(&x_full[xs], 4 * plane);
        tma_load_3d(xring + xs * 4 * plane, &x_map, 0,
                    (t0 - pad - lead) / 8, b * (slabs * 4) + c0 / 8,
                    &x_full[xs]);
        for (int k = 0; k < K; ++k, ++i) {
          const int ws = i % G::kWRing;
          if (i >= G::kWRing)
            mbar_wait(&w_empty[ws], ((i / G::kWRing) + 1) & 1);
          mbar_expect(&w_full[ws], G::kB);
          tma_load_3d(wring + ws * G::kB, &w_map, c0, o0, k, &w_full[ws]);
        }
      }
    }
  } else {
    // ---- consumers: rows 64 wg.. of the tile ----
    for (int j = 0, i = 0; j < nslabs; ++j) {
      const int xs = j % x_slots;
      mbar_wait(&x_full[xs], (j / x_slots) & 1);
      for (int k = 0; k < K; ++k, ++i) {
        const int ws = i % G::kWRing;
        mbar_wait(&w_full[ws], (i / G::kWRing) & 1);
        // tap k reads the slab from row lead + k * dil on
        const unsigned char* a =
            xring + xs * 4 * plane + (lead + k * dil + wg * 64) * 16;
        const unsigned char* w = wring + ws * G::kB;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)  // channels 16 kk..: planes 2 kk, +1
          mma<BN>(d, plane_desc(a + 2 * kk * plane, plane),
                  tile_desc(w + kk * 32), i | kk);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the products of stage i - 1 are done: release its weight tile,
        // and its x slab when it was that slab's last tap
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (i > 0 && (tid & 127) == 0) {
          mbar_arrive(&w_empty[(i - 1) % G::kWRing]);
          if (k == 0) mbar_arrive(&x_empty[(j - 1) % x_slots]);
        }
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  __syncthreads();  // every stage consumed: the ring's memory is free

  // this block's partial tile as [o][t]. Accumulator layout: warp w of the
  // warpgroup holds rows 16w + g (+ 8) of its 64, columns 8i + 2q (+ 1)
  if (wg < G::kWG) {
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          part[(8 * i + 2 * q + c) * G::kPitch + wg * 64 + warp * 16 + g +
               8 * h] = d[4 * i + 2 * h + c];
  }
  // then the cluster adds the tiles in rank order, each block a share of
  // the elements, and writes y along t: 4 columns a thread where rows of y
  // (and of the residual) start 16-byte aligned, the loads of 4 groups
  // issued before their stores
  cluster.sync();
  if (vec4) {
    constexpr int kGroups = BN * BM / 4, kUnroll = 4;
    const int stride = ranks * G::kThreads;
    for (int e0 = rank * G::kThreads + tid; e0 < kGroups;
         e0 += kUnroll * stride) {
      float4 v[kUnroll], rv[kUnroll];
      long long at[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * stride;
        const int ol = e / (BM / 4), tl = 4 * (e % (BM / 4));
        const int o = o0 + ol, t = t0 + tl;
        ok[u] = e < kGroups && o < O && t < T_out;
        at[u] = (static_cast<long long>(b) * O + o) * T_out + t;
        v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        rv[u] = v[u];
        if (!ok[u]) continue;
        for (int r = 0; r < ranks; ++r) {
          const float4 p = *reinterpret_cast<const float4*>(
              (r == rank ? part : cluster.map_shared_rank(part, r)) +
              ol * G::kPitch + tl);
          v[u].x += p.x;
          v[u].y += p.y;
          v[u].z += p.z;
          v[u].w += p.w;
        }
        if (bias) {
          const float bo = bias[o];
          v[u].x += bo;
          v[u].y += bo;
          v[u].z += bo;
          v[u].w += bo;
        }
        if (res) rv[u] = load4(res, at[u], res_bf16);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!ok[u]) continue;
        if (res) {
          v[u].x += rv[u].x;
          v[u].y += rv[u].y;
          v[u].z += rv[u].z;
          v[u].w += rv[u].w;
        }
        store4(y, at[u], v[u], y_bf16);
      }
    }
  } else {
    for (int e = rank * G::kThreads + tid; e < BN * BM;
         e += ranks * G::kThreads) {
      const int ol = e / BM, tl = e % BM;
      const int o = o0 + ol, t = t0 + tl;
      if (o >= O || t >= T_out) continue;
      float v = 0.0f;
      for (int r = 0; r < ranks; ++r)
        v += (r == rank ? part : cluster.map_shared_rank(part, r))
            [ol * G::kPitch + tl];
      if (bias) v += bias[o];
      const long long at = (static_cast<long long>(b) * O + o) * T_out + t;
      if (res) v += load_any(res, at, res_bf16);
      store_any(y, at, v, y_bf16);
    }
  }
  cluster.sync();  // keep this block's tile alive until the others are done
}

template <int BM, int BN>
int launch_wgmma(const CUtensorMap& x_map, const CUtensorMap& w_map,
                 const float* bias, const void* res, void* y, int B, int O,
                 int T_out, int K, int dil, int pad, int slabs, int cluster,
                 int per, int res_bf16, int y_bf16, int vec4, int smem,
                 cudaStream_t st) {
  using G = Conv<BM, BN>;
  if (smem != G::kSmem) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t set = cudaFuncSetAttribute(
      conv1d_wgmma<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::kSmem);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((T_out + BM - 1) / BM) * cluster, (O + BN - 1) / BN, B);
  cfg.blockDim = dim3(G::kThreads);
  cfg.dynamicSmemBytes = G::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, conv1d_wgmma<BM, BN>, x_map, w_map, bias, res, y, O, T_out, K,
      dil, pad, slabs, per, res_bf16, y_bf16, vec4);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// --------------------------------------------------------------------------
// f32 compute: plain FFMA
// --------------------------------------------------------------------------

constexpr int kBO = 64;        // output channels per block
constexpr int kBT = 128;       // output columns per block
constexpr int kCS = 32;        // input channels per slab
constexpr int kThreads = 256;  // 8 warps of 8 output channels x 128 columns
constexpr int kSP = kBT + 4;   // f32 row pitch of the output staging
// odd pitches: conflict-free for the FFMA loop's column reads
constexpr int kXP = 33, kWP = 33, kWPL = kBO * 33;

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

__global__ void __launch_bounds__(kThreads) conv1d_f32_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char raw[];
  float* ws = reinterpret_cast<float*>(raw);  // [K][kBO][kWP]
  float* xs = ws + a.K * kWPL;                // [kBT + halo][kXP]
  float* stage = reinterpret_cast<float*>(raw);

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kBT;
  const int o0 = blockIdx.y * kBO;
  const int b = blockIdx.z;
  const int rows = kBT + a.dil * (a.K - 1);

  // thread rows warp*8 + i, columns lane + 32*j
  const int warp = tid >> 5, lane = tid & 31;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const long long x_row0 = static_cast<long long>(b) * a.Ci;
  for (int c0 = 0; c0 < a.Ci; c0 += kCS) {
    // x slab with its halo, transposed to [t][c]. A warp covers 8 columns
    // x 4 channel pairs a pass: 32-byte runs of each channel row from
    // device memory
    const int units = ((rows + 7) / 8) * 8 * (kCS / 2);
    for (int u = tid; u < units; u += kThreads) {
      const int blk = u >> 5;
      const int j = (blk >> 2) * 8 + (u & 7);
      const int cl = ((blk & 3) * 4 + ((u >> 3) & 3)) * 2;
      if (j >= rows) continue;
      const int t_in = t0 - a.pad + j;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = c0 + cl + q;
        float e = 0.0f;
        if (t_in >= 0 && t_in < a.T && c < a.Ci) {
          e = load_any(a.x, (x_row0 + c) * a.T + t_in, a.x_bf16);
          if (a.alpha) {
            const float al = a.alpha[c];
            const float s = sinf(al * e);
            e = e + (s * s) / (al + 1e-9f);
          }
        }
        xs[j * kXP + cl + q] = e;
      }
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
      ws[k * kWPL + ol * kWP + cl] = v;
    }
    __syncthreads();

    for (int k = 0; k < a.K; ++k) {
      const float* wk = ws + k * kWPL + warp * 8 * kWP;
      const float* xk = xs + (lane + k * a.dil) * kXP;
#pragma unroll 4
      for (int c = 0; c < kCS; ++c) {
        float wv[8], xv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) wv[i] = wk[i * kWP + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xk[j * 32 * kXP + c];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += wv[i] * xv[j];
      }
    }
    __syncthreads();
  }

  // epilogue: the tile through shared memory (the operand tiles are free
  // now), bias and residual added in f32, one cast, rows written along t
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      stage[(warp * 8 + i) * kSP + lane + 32 * j] = acc[i][j];
  __syncthreads();
  for (int idx = tid; idx < kBO * kBT; idx += kThreads) {
    const int r = idx / kBT, c = idx - r * kBT;
    const int o = o0 + r, t = t0 + c;
    if (o >= a.O || t >= a.T_out) continue;
    float v = stage[r * kSP + c];
    if (a.bias) v += a.bias[o];
    const long long at = (static_cast<long long>(b) * a.O + o) * a.T_out + t;
    if (a.res) v += load_any(a.res, at, a.res_bf16);
    store_any(a.y, at, v, a.y_bf16);
  }
}

bool shape_ok(int B, int O, int T, int T_out, int K, int dil, int pad,
              int o_tile) {
  return B >= 1 && B <= 65535 && O >= 1 && K >= 1 && dil >= 1 && pad >= 0 &&
         T >= 1 && T_out >= 1 && T_out == T + 2 * pad - dil * (K - 1) &&
         (O + o_tile - 1) / o_tile <= 65535;
}

}  // namespace

// xs[b, c / 8, t, c % 8] = X'(x)[b, c, t] in bf16, c < Ci_p, t < T8 = T
// rounded up to a multiple of 8 (zeros for c >= Ci or t >= T): x [B, Ci, T]
// f32 or bf16 (x_bf16), alpha [Ci] f32 or null (no snake), xs [B, Ci_p / 8,
// T8, 8] bf16, Ci_p a multiple of 32 and >= Ci, all contiguous, xs 16-byte
// aligned.
// Launches on `stream` of card `device` and returns a CUDA error code.
extern "C" int conv1d_prologue(const void* x, const float* alpha, void* xs,
                               int B, int Ci, int Ci_p, int T, int x_bf16,
                               int device, void* stream) {
  const int T8 = (T + 7) / 8 * 8;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (B < 1 || B > 65535 || Ci < 1 || Ci_p < Ci || Ci_p % kStageC || T < 1 ||
      (Ci_p + kPC - 1) / kPC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads of 4 columns where x's rows start 16-byte aligned
  const int vec = T % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((T8 + kPT - 1) / kPT, (Ci_p + kPC - 1) / kPC, B);
  conv1d_prologue_kernel<<<grid, kPThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, alpha, static_cast<__nv_bfloat16*>(xs), Ci, Ci_p, T, T8, x_bf16,
      vec);
  return static_cast<int>(cudaGetLastError());
}

// y[b, o, t] = bias[o] + sum_k sum_c wk[k, o, c] . xs[b, t + k*dil - pad, c]
// (+ res[b, o, t]): xs the prologue's chunk-planar [B, Ci_p / 8, T8, 8] bf16,
// wk [K, O, Ci_p] bf16 (the packed weight), both contiguous and 16-byte
// aligned, Ci_p a multiple of 32; bias [O] f32 or null; res and y [B, O,
// T_out], f32 or bf16 as their flags say. The plan (ops/conv1d.conv1d_plan):
// tiles of bm (64 or 128) columns x bn (96 or 192) channels, a slab's rows
// (pad % 8 + bm + dil * (K - 1), rounded up to 8) <= 256, each tile's Ci_p / 32 slabs split over a cluster of
// `cluster` <= 8 blocks of `per` slabs, `smem` the dynamic shared memory the
// plan expects. Launches on `stream` of card `device` and returns a CUDA
// error code (0 on success).
extern "C" int conv1d(const void* xs, const void* wk, const float* bias,
                      const void* res, void* y, int B, int Ci_p, int O,
                      int T, int T_out, int K, int dil, int pad,
                      int res_bf16, int y_bf16, int bm, int bn, int cluster,
                      int per, int smem, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int slabs = Ci_p / kStageC;
  const int lead = ((-pad % 8) + 8) % 8;  // t0 is a multiple of 8
  const int rows = (lead + bm + dil * (K - 1) + 7) / 8 * 8;
  const int T8 = (T + 7) / 8 * 8;
  if (!shape_ok(B, O, T, T_out, K, dil, pad, bn) || Ci_p < kStageC ||
      Ci_p % kStageC || rows > kMaxRows || cluster < 1 || cluster > 8 ||
      per < 1 || (cluster - 1) * per >= slabs || cluster * per < slabs)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, w_map;
  // x as (64 elements: 8 columns of 8 channels, T8 / 8, B * Ci_p / 8
  // chunks): a box of 4 chunks' planes, 128-byte rows
  const long long x_dims[3] = {64, T8 / 8,
                               static_cast<long long>(B) * (Ci_p / 8)};
  const long long x_strides[2] = {128, 16LL * T8};
  const int x_box[3] = {64, rows / 8, 4};
  int err = encode_tiled(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, xs,
                         x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  const long long w_dims[3] = {Ci_p, O, K};
  const long long w_strides[2] = {2LL * Ci_p, 2LL * Ci_p * O};
  const int w_box[3] = {kStageC, bn, 1};
  if (!err)
    err = encode_tiled(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, wk,
                       w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the epilogue's 4-column path: rows of y and of the residual start
  // 16-byte aligned
  const int vec4 = T_out % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(res) % 16 == 0;
#define CONV1D_TILE(BM, BN)                                                 \
  if (bm == BM && bn == BN)                                                 \
    return launch_wgmma<BM, BN>(x_map, w_map, bias, res, y, B, O, T_out, K, \
                                dil, pad, slabs, cluster, per, res_bf16,    \
                                y_bf16, vec4, smem, st);
  CONV1D_TILE(64, 96)
  CONV1D_TILE(64, 192)
  CONV1D_TILE(128, 96)
  CONV1D_TILE(128, 192)
#undef CONV1D_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The f32-compute conv (products and sums in f32, nothing rounded): x
// [B, Ci, T], w [O, Ci, K], y and res [B, O, T_out], all contiguous, each
// f32 or bf16 as its flag says; bias [O] and alpha [Ci] f32 or null.
// Launches on `stream` of card `device` and returns cudaGetLastError().
extern "C" int conv1d_f32(const void* x, const void* w, const float* bias,
                          const float* alpha, const void* res, void* y,
                          int B, int Ci, int O, int T, int T_out, int K,
                          int dil, int pad, int x_bf16, int w_bf16,
                          int res_bf16, int y_bf16, int device,
                          void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (Ci < 1 || !shape_ok(B, O, T, T_out, K, dil, pad, kBO))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w, bias, alpha, res, y, Ci, O, T, T_out, K, dil, pad,
               x_bf16, w_bf16, res_bf16, y_bf16};
  const int rows = kBT + dil * (K - 1);
  const long long operands =
      (static_cast<long long>(K) * kWPL + static_cast<long long>(rows) * kXP) *
      4LL;
  const long long staging = static_cast<long long>(kBO) * kSP * 4;
  const long long bytes = operands > staging ? operands : staging;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // once, at the largest size any call asks for (as the bf16 entry sets
  // its own): no attribute call runs while a CUDA graph captures the call
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv1d_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((T_out + kBT - 1) / kBT, (O + kBO - 1) / kBO, B);
  conv1d_f32_kernel<<<grid, kThreads, static_cast<size_t>(bytes),
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
