// Fused decode step of one layer: the per-head "soup" around the WKV-7
// update, in place on the state stack.
//
// Replaces the TPU kernel rwkv_tts_tpu/ops/wkv7.py:755
// wkv7_step_fused_bt_pallas (body _wkv7_step_fused_bt_kernel, :685). Per
// (batch b, head h), with j the key channel and i the value channel of the
// N x N state S:
//
//     w     = -softplus(-(w0 + lo_w)) - 0.5,     d = exp(-exp(w))
//     iclr  = sigmoid(a0 + lo_a)
//     gate  = sigmoid(v0 + lo_v) * notfirst,     v' = v + (v_first - v) gate
//     kk    = (k k_k) / sqrt(sum_j (k k_k)^2 + 1e-12)
//     k_in  = k (1 + (iclr - 1) k_a),            b = kk iclr
//     S    <- S diag(d) + (S (-kk)) b^T + v' k_in^T,     y = S r
//     out   = (GroupNorm_N(y; gn_eps) ln_x_w + ln_x_b + (sum_j r k_in r_k) v') g
//
// The TPU kernel keeps the batch in its 128 lanes ([H, N, N, B] state) and
// the JAX model takes it only from batch 8 up (wkv_bt_active), for those
// lanes. The port has no lanes: this kernel updates one layer's slab of the
// plain [L, B, H, N, N] stack in place, as csrc/wkv7_decode.cu does, and
// serves every batch. Its [B, H, N] operands may be row-strided views
// (the slices of the fused projections' outputs), so nothing is copied to
// feed it.
//
// Bound: bytes. The slab is read and written once (2 * B*H*N*N * elem)
// beside 9 [B, H, N] operand reads and one write, at ~9 flops per state
// element. At the decode batches the card holds every block at once, so
// the time is the operands' and the slab's load latency, the slab's bytes
// each way and what a block does after its bytes land. The design (each
// choice timed against the others with tools/profile_step_fused.py and
// cut variants; the numbers are in PERF.md):
//
// - Order. Each warp first loads its soup operands, then lane 0 starts one
//   bulk copy (TMA, cp.async.bulk on an mbarrier) of the warp's 16
//   contiguous state rows into shared memory. The soup waits on its
//   operands and the update on the state; the operands first is what
//   counts (the state first, by TMA or by loads into registers, was
//   slower: the operands then queue behind the slab).
// - The soup once a block, one element a thread: warps 0-1 own the key
//   columns (decay, iclr, k k_k, k_in, the r k_in r_k terms; the sums of
//   (k k_k)^2 and of the bonus terms as a 5-round butterfly a warp, the
//   two warps' partials added), warps 2-3 the value rows (the gate and
//   v'). All of it goes to shared memory behind one barrier; each thread
//   of the update forms the l2 norm's 1 / sqrt itself (the same bits in
//   every thread), and v' is read again by the epilogue.
// - Rows. kLanes = 8 lanes share a state row, each holding 8 key columns
//   as two float4 chunks (chunk m of lane q: columns 4 (8 m + q) .. + 3, so
//   a row's lanes read one contiguous run), and a thread holds kR = 4 rows
//   (2 and 1 measured slower at every batch): S a and y = S r are 8
//   products and 3 shuffle rounds a row, the 4 rows' rounds interleaved
//   (csrc/wkv7_prefill.cu's layout). A warp's rows leave for device memory
//   as soon as they are updated.
// - Epilogue. Each warp reduces its 16 y's to a mean and a centred sum of
//   squares before the barrier (2 shuffle rounds each); warp 0 merges the
//   four (Chan's formula) and writes the outputs. That is the GroupNorm's
//   mean and variance without a 5-round butterfly after the barrier.
//
// A head cut over a cluster of 2 or 4 blocks (the y's meeting in
// distributed shared memory) was measured slower at every batch from 1
// to 128, and is not kept.
//
// Batch invariance: a row's arithmetic, sum orders included, depends only
// on the lane's place in its row and the warp's in its head, never on B;
// explicit fmaf / __fmul_rn / __fadd_rn leave the compiler no contraction
// to choose. One request gets the same bits alone as in a batch.
// `expf`/`log1pf`/`sqrtf` without fast-math, as the other kernels: a
// masked decay stays 1.0f.

#include "sm90.cuh"

namespace {

constexpr int kN = 64;               // head size
constexpr int kLanes = 8;            // lanes that share a state row
constexpr int kCols = kN / kLanes;   // key columns a lane holds
constexpr int kChunks = kCols / 4;   // ... as float4 chunks
constexpr int kR = 4;                // state rows a thread
constexpr int kThreads = kN * kLanes / kR;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = kN / kWarps;   // rows a warp holds
static_assert(kThreads == 2 * kN,
              "the soup takes one key column or one value row a thread");

// first key column of lane q's chunk m
__device__ __forceinline__ int col(int m, int q) {
  return 4 * (kLanes * m + q);
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// four consecutive floats, or state elements as floats (shared memory)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// ... and back to device memory, rounded once (to nearest even) for bf16
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// `bytes` (a multiple of 16) from device to shared memory, completing on
// mbarrier `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the sum over a warp by xor butterflies (16, 8, 4, 2, 1): every lane ends
// with the same bits
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// the rows' sums from their 8 lanes' shares (xor 1, 2, 4), all kR rows'
// shuffles in flight at once
__device__ __forceinline__ void row_sums(float (&x)[kR]) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    float t[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
      t[i] = __shfl_xor_sync(0xffffffffu, x[i], o);
#pragma unroll
    for (int i = 0; i < kR; ++i) x[i] = __fadd_rn(x[i], t[i]);
  }
}

// the sum over a warp's 4 row groups (lanes 8 apart, xor 8, 16)
__device__ __forceinline__ float group_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 16));
}

// the lane's share of a row sum: 8 products in two chains (x and z
// components in one, y and w in the other), the chains added
__device__ __forceinline__ float dot(const float (&s)[kCols],
                                     const float4 (&x)[kChunks]) {
  float e = __fmul_rn(s[0], x[0].x);
  float o = __fmul_rn(s[1], x[0].y);
  e = fmaf(s[2], x[0].z, e);
  o = fmaf(s[3], x[0].w, o);
#pragma unroll
  for (int m = 1; m < kChunks; ++m) {
    e = fmaf(s[4 * m], x[m].x, e);
    o = fmaf(s[4 * m + 1], x[m].y, o);
    e = fmaf(s[4 * m + 2], x[m].z, e);
    o = fmaf(s[4 * m + 3], x[m].w, o);
  }
  return __fadd_rn(e, o);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / __fadd_rn(1.0f, expf(-x));
}

// jax.nn.softplus: logaddexp(x, 0)
__device__ __forceinline__ float softplus(float x) {
  return __fadd_rn(fmaxf(x, 0.0f), log1pf(expf(-fabsf(x))));
}

// the eight [B, H, N] operands: base pointers and batch-row strides (in
// elements; the H * N values of a row are contiguous)
struct Operands {
  const void* r;
  const float* lo_w;
  const float* lo_a;
  const float* lo_v;
  const void* k;
  const void* v;
  const float* g;
  const float* v_first;
  long long s_r, s_lo_w, s_lo_a, s_lo_v, s_k, s_v, s_g, s_v_first;
};

// one block a head (b, h) = blockIdx.x
template <typename S, typename In>
__global__ void __launch_bounds__(kThreads)
wkv7_step_fused_kernel(Operands op, const float* __restrict__ pp,
                       S* __restrict__ slab, float* __restrict__ out, int H,
                       float notfirst, float gn_eps) {
  __shared__ __align__(128) S stage[kN * kN];     // the tile, as stored
  __shared__ __align__(16) float sd[kN];          // decay
  __shared__ __align__(16) float skk[kN];         // k k_k
  __shared__ __align__(16) float sic[kN];         // iclr
  __shared__ __align__(16) float sk[kN];          // k_in
  __shared__ __align__(16) float sr[kN];          // r
  __shared__ float sv[kN];                        // v'
  __shared__ float ys[kN];
  __shared__ float part[2][2];                    // [warp][sum kk^2, bonus]
  __shared__ float ystat[kWarps][2];              // [warp][mean, sum c^2]
  __shared__ __align__(8) uint64_t bar[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x;
  S* tile = slab + static_cast<long long>(bh) * kN * kN;

  const int b = bh / H, h = bh - b * H;
  const int hn = h * kN;
  // params8 rows: k_k, k_a, w0, a0, v0, r_k, ln_x_w, ln_x_b, each [H, N]
  const long long prow = static_cast<long long>(H) * kN;
  const float* p8 = pp + hn;

  // 1. the operands of the thread's soup element: key column j = tid
  // (warps 0-1: w0, lo_w, a0, lo_a, k, r, k_k, k_a, r_k), value row
  // i = tid - 64 (warps 2-3: v, v_first, v0, lo_v); warp 0 also the
  // epilogue's of rows lane and lane + 32
  float x[9], eg[2], elw[2], elb[2];
  if (tid < kN) {
    const int j = tid;
    x[0] = p8[2 * prow + j];
    x[1] = op.lo_w[b * op.s_lo_w + hn + j];
    x[2] = p8[3 * prow + j];
    x[3] = op.lo_a[b * op.s_lo_a + hn + j];
    x[4] = load_f32(static_cast<const In*>(op.k) + b * op.s_k + hn + j);
    x[5] = load_f32(static_cast<const In*>(op.r) + b * op.s_r + hn + j);
    x[6] = p8[j];
    x[7] = p8[prow + j];
    x[8] = p8[5 * prow + j];
    if (warp == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = lane + 32 * u;
        eg[u] = op.g[b * op.s_g + hn + i];
        elw[u] = p8[6 * prow + i];
        elb[u] = p8[7 * prow + i];
      }
    }
  } else {
    const int i = tid - kN;
    x[0] = load_f32(static_cast<const In*>(op.v) + b * op.s_v + hn + i);
    x[1] = op.v_first[b * op.s_v_first + hn + i];
    x[2] = p8[4 * prow + i];
    x[3] = op.lo_v[b * op.s_lo_v + hn + i];
  }

  // 2. the warp's rows start moving, behind its operands' loads
  if (lane == 0) {
    constexpr int kBytes = kWarpRows * kN * static_cast<int>(sizeof(S));
    mbar_init(&bar[warp], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bar[warp], kBytes);
    bulk_load(stage + warp * kWarpRows * kN, tile + warp * kWarpRows * kN,
              kBytes, &bar[warp]);
  }

  // 3. the soup, one element a thread
  if (tid < kN) {
    const int j = tid;
    const float w = __fsub_rn(-softplus(-__fadd_rn(x[0], x[1])), 0.5f);
    const float ic = sigmoid(__fadd_rn(x[2], x[3]));
    const float kk0 = __fmul_rn(x[4], x[6]);
    const float kin = __fmul_rn(
        x[4], __fadd_rn(1.0f, __fmul_rn(__fsub_rn(ic, 1.0f), x[7])));
    const float ss = warp_sum(__fmul_rn(kk0, kk0));
    const float bonus = warp_sum(__fmul_rn(__fmul_rn(x[5], kin), x[8]));
    sd[j] = expf(-expf(w));
    skk[j] = kk0;
    sic[j] = ic;
    sk[j] = kin;
    sr[j] = x[5];
    if (lane == 0) {
      part[warp][0] = ss;
      part[warp][1] = bonus;
    }
  } else {
    const float gate =
        __fmul_rn(sigmoid(__fadd_rn(x[2], x[3])), notfirst);
    sv[tid - kN] = __fadd_rn(x[0], __fmul_rn(__fsub_rn(x[1], x[0]), gate));
  }
  __syncthreads();

  // 4. the update and y = S r: 8 lanes a row, kR rows a thread
  const int q = tid % kLanes;
  const int row0 = (tid / kLanes) * kR;
  const float inv =
      1.0f / sqrtf(__fadd_rn(__fadd_rn(part[0][0], part[1][0]), 1e-12f));
  float4 fa[kChunks], fb[kChunks], fr[kChunks];
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    const float4 kk0 = load4(skk + col(m, q));
    const float4 ic = load4(sic + col(m, q));
    const float4 kk =
        make_float4(__fmul_rn(kk0.x, inv), __fmul_rn(kk0.y, inv),
                    __fmul_rn(kk0.z, inv), __fmul_rn(kk0.w, inv));
    fa[m] = make_float4(-kk.x, -kk.y, -kk.z, -kk.w);
    fb[m] = make_float4(__fmul_rn(kk.x, ic.x), __fmul_rn(kk.y, ic.y),
                        __fmul_rn(kk.z, ic.z), __fmul_rn(kk.w, ic.w));
    fr[m] = load4(sr + col(m, q));
  }
  mbar_wait(&bar[warp], 0);
  float s[kR][kCols];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int m = 0; m < kChunks; ++m) {
      const float4 e = load4(stage + (row0 + i) * kN + col(m, q));
      s[i][4 * m] = e.x;
      s[i][4 * m + 1] = e.y;
      s[i][4 * m + 2] = e.z;
      s[i][4 * m + 3] = e.w;
    }
  float sums[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) sums[i] = dot(s[i], fa);
  row_sums(sums);
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    const float4 d = load4(sd + col(m, q));
    const float4 kin = load4(sk + col(m, q));
    const float4 bb = fb[m];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float ve = sv[row0 + i];
      const float sa = sums[i];
      const int c = 4 * m;
      s[i][c] = fmaf(s[i][c], d.x, fmaf(sa, bb.x, __fmul_rn(ve, kin.x)));
      s[i][c + 1] =
          fmaf(s[i][c + 1], d.y, fmaf(sa, bb.y, __fmul_rn(ve, kin.y)));
      s[i][c + 2] =
          fmaf(s[i][c + 2], d.z, fmaf(sa, bb.z, __fmul_rn(ve, kin.z)));
      s[i][c + 3] =
          fmaf(s[i][c + 3], d.w, fmaf(sa, bb.w, __fmul_rn(ve, kin.w)));
    }
  }
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int m = 0; m < kChunks; ++m)
      store4(tile + (row0 + i) * kN + col(m, q), s[i][4 * m],
             s[i][4 * m + 1], s[i][4 * m + 2], s[i][4 * m + 3]);
  float y[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) y[i] = dot(s[i], fr);
  row_sums(y);

  // 5. the GroupNorm's statistics: the warp's 16 y's (its lanes' 4 in
  // order, then the 4 row groups) to a mean and a centred sum of squares
  {
    float t = y[0];
#pragma unroll
    for (int i = 1; i < kR; ++i) t = __fadd_rn(t, y[i]);
    const float mw = __fmul_rn(group_sum(t), 1.0f / kWarpRows);
    float c2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float c = __fsub_rn(y[i], mw);
      c2 = fmaf(c, c, c2);
    }
    c2 = group_sum(c2);
    if (lane == 0) {
      ystat[warp][0] = mw;
      ystat[warp][1] = c2;
    }
  }
  if (q == 0) {
#pragma unroll
    for (int i = 0; i < kR; ++i) ys[row0 + i] = y[i];
  }
  __syncthreads();

  // 6. the head's mean and variance from the warps' (Chan's merge of
  // equal counts), then ln_x, the bonus and the gate
  if (warp == 0) {
    float mu = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mu = __fadd_rn(mu, ystat[w][0]);
    mu = __fmul_rn(mu, 1.0f / kWarps);
    float m2 = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float dm = __fsub_rn(ystat[w][0], mu);
      m2 = __fadd_rn(
          m2, fmaf(__fmul_rn(dm, dm), static_cast<float>(kWarpRows),
                   ystat[w][1]));
    }
    const float rstd =
        1.0f / sqrtf(__fadd_rn(__fmul_rn(m2, 1.0f / kN), gn_eps));
    const float rk = __fadd_rn(part[0][1], part[1][1]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = lane + 32 * u;
      const float yn = __fmul_rn(__fsub_rn(ys[i], mu), rstd);
      const float o = __fadd_rn(__fadd_rn(__fmul_rn(yn, elw[u]), elb[u]),
                                __fmul_rn(rk, sv[i]));
      out[static_cast<long long>(bh) * kN + i] = __fmul_rn(o, eg[u]);
    }
  }
}

template <typename S, typename In>
void launch_in(const Operands& op, const float* pp, S* slab, float* out,
               int B, int H, float notfirst, float gn_eps, cudaStream_t st) {
  wkv7_step_fused_kernel<S, In><<<B * H, kThreads, 0, st>>>(
      op, pp, slab, out, H, notfirst, gn_eps);
}

}  // namespace

// r, k, v: [B, H, 64] f32 (rkv_is_bf16 == 0) or bf16; lo_w, lo_a, lo_v, g,
// v_first: [B, H, 64] f32. Each operand's batch rows lie `s_*` elements
// apart, the H * 64 values of a row contiguous. params8: [8, H, 64] f32
// contiguous (k_k, k_a, w0, a0, v0, r_k, ln_x_w, ln_x_b). state_stack:
// [L, B, H, 64, 64], f32 (state_is_bf16 == 0) or bf16, each layer's B * H
// tiles contiguous and the layers `layer_stride` elements apart; only layer
// `layer` is rewritten. out: [B, H, 64] f32 contiguous. Launches on
// `stream` of card `device` and returns cudaGetLastError().
extern "C" int wkv7_step_fused(
    const void* r, const float* lo_w, const float* lo_a, const float* lo_v,
    const void* k, const void* v, const float* g, const float* v_first,
    long long s_r, long long s_lo_w, long long s_lo_a, long long s_lo_v,
    long long s_k, long long s_v, long long s_g, long long s_v_first,
    int rkv_is_bf16, const float* params8, void* state_stack,
    int state_is_bf16, long long layer, long long layer_stride, float* out,
    int B, int H, float notfirst, float gn_eps, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Operands op{r,   lo_w,   lo_a,   lo_v,   k,   v,   g,   v_first,
                    s_r, s_lo_w, s_lo_a, s_lo_v, s_k, s_v, s_g, s_v_first};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (state_is_bf16) {
    __nv_bfloat16* slab =
        static_cast<__nv_bfloat16*>(state_stack) + layer * layer_stride;
    if (rkv_is_bf16)
      launch_in<__nv_bfloat16, __nv_bfloat16>(op, params8, slab, out, B, H,
                                              notfirst, gn_eps, st);
    else
      launch_in<__nv_bfloat16, float>(op, params8, slab, out, B, H, notfirst,
                                      gn_eps, st);
  } else {
    float* slab = static_cast<float*>(state_stack) + layer * layer_stride;
    if (rkv_is_bf16)
      launch_in<float, __nv_bfloat16>(op, params8, slab, out, B, H, notfirst,
                                      gn_eps, st);
    else
      launch_in<float, float>(op, params8, slab, out, B, H, notfirst, gn_eps,
                              st);
  }
  return static_cast<int>(cudaGetLastError());
}
