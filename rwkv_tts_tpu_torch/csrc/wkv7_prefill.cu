// Prefill WKV-7: the sequential recurrence over a whole prompt chunk.
//
// Replaces the TPU kernels rwkv_tts_tpu/ops/wkv7.py:483 wkv7_seq_bt_pallas
// (body :450) and :1329 wkv7_pallas_packed (body :1278), both behind the
// entry point `wkv7_prefill`, and :103 wkv7_pallas (body :72, one block per
// (b, h) with the state resident) behind the entry point `wkv7_seq`: all
// three compute the function of the oracle wkv7_scan (:42), and both entry
// points launch the one kernel below, each under its own launch count. Per
// (batch b, head h), for t = 0 .. T-1:
//
//     S <- S * diag(exp(-exp(w_t))) + (S a_t) b_t^T + v_t k_t^T,  y_t = S r_t
//
// Inputs r, w, k, v, a, b are [B, T, H, N] f32 and the state [B, H, N, N]
// f32; outputs are y [B, T, H, N] f32 and the final state. The decay is
// computed here, exactly as wkv7_scan does (expf, not __expf: a masked
// position's w = -30 must give a decay of exactly 1.0f). Any T works, so
// prompt lengths with 4 not dividing T need no second kernel.
//
// Bound: bytes, with the FP32 pipe close behind. The kernel reads the six
// sequence tensors and the state once and writes y and the state once; per
// state element and token it issues 5 FP32 instructions (S a, the update's
// three, S r), which at N = 64 takes about as long as the bytes. On the
// H100 it reaches 30-45% of the byte bound: the FP32 pipe issues about
// half the time, and removing shared-memory reads does not move it (the
// measurements are in PERF.md). So the design spends as little as it can
// beside those FMAs:
//
// - Lanes. kLanes = 8 lanes share a state row, each holding kCols = 8 key
//   columns of it for each of the R rows it holds: a row sum is 8 FMAs in
//   two chains and 3 shuffles (xor 1, 2, 4). 8 lanes measured faster than
//   4 (16 columns) and 2 (32 columns) at B = 8 and level at B = 128.
// - Rows. A thread holds R rows (the plan's thread_rows): the columns'
//   decay, a, b, k and r it reads serve all R of them.
// - Steps. Token t's S a_t and token t-1's S r_(t-1) read the same S, so
//   one pass computes both and their 2 R sums share the shuffles.
// - Staging. A block walks T in runs of `tc` tokens. Thread 0 brings each
//   run's six [tc, 64] vectors into shared memory as TMA boxes of a 2-D map
//   over [B*T rows, H*64 columns] (row pitch H*64*4 bytes), double-buffered
//   behind mbarriers, so the next run arrives while this one is computed.
//   Box rows past the (b, h)'s T tokens belong to the next batch row (or
//   lie past the tensor and arrive as zeros); they are never used.
// - Decays. The block computes each run's exp(-exp(w)) once per element
//   into shared memory, not once per row.
// - Reads. A lane reads its columns as float4 broadcasts: chunk m of lane
//   q is columns 4 (kLanes m + q) .. + 3, so a row's lanes read one
//   contiguous run and the warp's rows the same run.
// - Writes. y gathers in shared memory and leaves once a run, in float4
//   stores of whole rows; the state is read and written as float4.
// - Grid. A block owns `rows` of the 64 state rows of one (b, h); below 128
//   (b, h) pairs the plan (plan_for) cuts a (b, h) over 4 blocks of one row
//   a thread, so that every SM has warps. Rows are independent, so this
//   changes no result.
//
// Batch invariance: a row's arithmetic, summation order included, depends
// only on the lane's place in its row, never on B, T, the plan or the other
// rows, and explicit fmaf / __fmul_rn / __fadd_rn leave the compiler no
// contraction to choose. A request's prefill is the same alone or batched.
//
// The paired mode (entry wkv7_chunk_pair) is the same body, instantiated
// with kPair. It replaces the TPU kernel rwkv_tts_tpu/ops/wkv7.py:851
// wkv7_chunk_pair_bt_pallas (body :804), the phase A of wkv7_chunked_fused
// (:896); its plain version is ops/wkv7.wkv7_chunk_pair. A [B, T, H, N]
// prompt is cut into M = B * T / L chunks of L positions, which is the same
// memory as [M, L, H, N]: the kernel walks it as M "batch rows" of L
// tokens, so the grid covers M * H chunk-heads and the TMA boxes, decays,
// lanes and rows are the sequential mode's. Per (chunk m, head h), for
// t = 0 .. L-1, with M_t = diag(exp(-exp(w_t))) + a_t b_t^T:
//
//     S <- S M_t + v_t k_t^T,  y_loc_t = S r_t        (S starts at zero)
//     P <- P M_t,              rho_t   = P r_t        (P starts at I)
//
// and s_loc = S, P at the end (ops/wkv7._chunk_combine joins the chunks).
// A thread holds a second slab, P's R rows beside S's, whose row sums share
// the shuffle rounds with S's (4 R sums a step); rho gathers beside y. P
// takes the state's update without the write, so its decay acts on the key
// (column) index as the state's does. Bound: bytes; per chunk-head the two
// N x N slabs written at the end weigh as much as 2 N^2 / (8 N) = 16
// positions of the eight sequence tensors.

#include "sm90.cuh"

namespace {

constexpr int kN = 64;               // head size
constexpr int kLanes = 8;            // lanes that share a state row
constexpr int kCols = kN / kLanes;   // key columns a lane holds
constexpr int kChunks = kCols / 4;   // ... as float4 chunks
constexpr int kVecs = 6;             // r, w, k, v, a, b: the maps' order
constexpr int kMaxTc = 64;           // tokens a run at most
constexpr int kMaxPairTc = 32;       // ... in the paired mode (two y buffers)
constexpr int kAlign = 128;          // TMA destinations' alignment

struct Maps {
  CUtensorMap m[kVecs];
};

// the shared memory a block of `rows` rows needs for runs of `tc` tokens:
// two stages of the six vectors, the decays, the gathered y (and rho in
// the paired mode), the two barriers, and slack to align the stages
__host__ __device__ constexpr int smem_bytes(int rows, int tc,
                                             bool pair = false) {
  return (2 * kVecs + 1) * tc * kN * 4 + (pair ? 2 : 1) * tc * rows * 4 +
         16 + kAlign;
}

// first key column of lane q's chunk m
__device__ __forceinline__ int col(int m, int q) {
  return 4 * (kLanes * m + q);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the lane's share of a row sum: kCols products in two chains (x and z
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

// the rows' sums from their lanes' shares, by xor butterflies (all R
// rows' shuffles in flight at once): every lane of a row ends with the
// same bits
template <int R>
__device__ __forceinline__ void row_sums(float (&x)[R]) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    float t[R];
#pragma unroll
    for (int i = 0; i < R; ++i) t[i] = __shfl_xor_sync(0xffffffffu, x[i], o);
#pragma unroll
    for (int i = 0; i < R; ++i) x[i] = __fadd_rn(x[i], t[i]);
  }
}

__device__ __forceinline__ float upd(float s, float d, float sa, float b,
                                     float v, float k) {
  return fmaf(s, d, fmaf(sa, b, __fmul_rn(v, k)));
}

// the transition's update: the state's without the write
__device__ __forceinline__ float upd_t(float p, float d, float pa, float b) {
  return fmaf(p, d, __fmul_rn(pa, b));
}

// R state rows a thread: a block of `rows` rows has rows * kLanes / R
// threads. With kPair: the paired mode (s_in unused; rho and p_out
// written).
template <int R, bool kPair>
__global__ void __launch_bounds__(kN * kLanes / R)
wkv7_prefill_kernel(const __grid_constant__ Maps maps,
                    const float* __restrict__ s_in, float* __restrict__ y,
                    float* __restrict__ s_out, float* __restrict__ rho,
                    float* __restrict__ p_out, int T, int H, int rows,
                    int tc) {
  // pointer arithmetic on the shared array (not integer casts) keeps the
  // compiler's knowledge that these are shared-memory addresses
  extern __shared__ unsigned char smem_raw[];
  float* stage = reinterpret_cast<float*>(
      smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) &
                  (kAlign - 1)));                // [2][6][tc][64]
  const int run = tc * kN;                       // floats a vector
  float* dec = stage + 2 * kVecs * run;          // [tc][64]
  float* ybuf = dec + run;                       // [tc][rows]
  float* rbuf = ybuf + tc * rows;                // [tc][rows], kPair only
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ybuf + (kPair ? 2 : 1) * tc * rows);

  const int split = kN / rows;
  const int bh = blockIdx.x / split;
  const int part = blockIdx.x - bh * split;
  const int bb = bh / H;
  const int h = bh - bb * H;
  const int tid = threadIdx.x;
  const int q = tid % kLanes;
  const int lrow = (tid / kLanes) * R;    // the thread's first row, local
  const int row0 = part * rows + lrow;    // ... and in the head
  const int nrun = (T + tc - 1) / tc;

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int c) {
    const int s = c & 1;
    mbar_expect(&full[s], kVecs * run * 4);
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      tma_load(stage + (s * kVecs + j) * run, &maps.m[j], h * kN,
               bb * T + c * tc, &full[s]);
  };
  if (tid == 0) {
    issue(0);
    if (nrun > 1) issue(1);
  }

  const long long tile = static_cast<long long>(bh) * kN * kN;
  float S[R][kCols];
  float Pm[R][kCols];  // the paired mode's transition rows
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int m = 0; m < kChunks; ++m) {
      if constexpr (kPair) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          S[i][4 * m + e] = 0.0f;
          Pm[i][4 * m + e] = col(m, q) + e == row0 + i ? 1.0f : 0.0f;
        }
      } else {
        const float4 x = ld4(s_in + tile + (row0 + i) * kN + col(m, q));
        S[i][4 * m] = x.x;
        S[i][4 * m + 1] = x.y;
        S[i][4 * m + 2] = x.z;
        S[i][4 * m + 3] = x.w;
      }
    }

  for (int c = 0; c < nrun; ++c) {
    const int s = c & 1;
    const int n = min(tc, T - c * tc);
    const float* xr = stage + (s * kVecs + 0) * run;
    const float* xw = stage + (s * kVecs + 1) * run;
    const float* xk = stage + (s * kVecs + 2) * run;
    const float* xv = stage + (s * kVecs + 3) * run;
    const float* xa = stage + (s * kVecs + 4) * run;
    const float* xb = stage + (s * kVecs + 5) * run;
    mbar_wait(&full[s], (c >> 1) & 1);
    for (int e = tid; e < n * kN; e += blockDim.x) dec[e] = expf(-expf(xw[e]));
    __syncthreads();

    // Token tt's S a_tt and token tt - 1's S r_(tt-1) both read S after
    // token tt - 1: one pass computes the two, and their row sums go
    // through the shuffles together (2 R sums in flight). Token tt - 1's
    // y thus leaves in step tt; the run's last y after the loop. a and r
    // of the next step are read during this step's update.
    float4 fa[kChunks], fr[kChunks];
#pragma unroll
    for (int m = 0; m < kChunks; ++m) {
      fa[m] = ld4(xa + col(m, q));
      fr[m] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    // the paired mode adds P a_tt and P r_(tt-1) as sums 2R .. 4R-1
    constexpr int kSums = kPair ? 4 * R : 2 * R;
    for (int tt = 0; tt < n; ++tt) {
      const int o = tt * kN;
      float sums[kSums], v[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        sums[i] = dot(S[i], fa);
        sums[R + i] = dot(S[i], fr);
        v[i] = xv[o + row0 + i];
        if constexpr (kPair) {
          sums[2 * R + i] = dot(Pm[i], fa);
          sums[3 * R + i] = dot(Pm[i], fr);
        }
      }
      row_sums<kSums>(sums);
      if (q == 0 && tt > 0) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          ybuf[(tt - 1) * rows + lrow + i] = sums[R + i];
          if constexpr (kPair)
            rbuf[(tt - 1) * rows + lrow + i] = sums[3 * R + i];
        }
      }
#pragma unroll
      for (int m = 0; m < kChunks; ++m) {
        fr[m] = ld4(xr + o + col(m, q));
        if (tt + 1 < n) fa[m] = ld4(xa + o + kN + col(m, q));
      }
#pragma unroll
      for (int m = 0; m < kChunks; ++m) {
        const float4 d = ld4(dec + o + col(m, q));
        const float4 b = ld4(xb + o + col(m, q));
        const float4 k = ld4(xk + o + col(m, q));
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float sa = sums[i];
          S[i][4 * m] = upd(S[i][4 * m], d.x, sa, b.x, v[i], k.x);
          S[i][4 * m + 1] = upd(S[i][4 * m + 1], d.y, sa, b.y, v[i], k.y);
          S[i][4 * m + 2] = upd(S[i][4 * m + 2], d.z, sa, b.z, v[i], k.z);
          S[i][4 * m + 3] = upd(S[i][4 * m + 3], d.w, sa, b.w, v[i], k.w);
          if constexpr (kPair) {
            const float pa = sums[2 * R + i];
            Pm[i][4 * m] = upd_t(Pm[i][4 * m], d.x, pa, b.x);
            Pm[i][4 * m + 1] = upd_t(Pm[i][4 * m + 1], d.y, pa, b.y);
            Pm[i][4 * m + 2] = upd_t(Pm[i][4 * m + 2], d.z, pa, b.z);
            Pm[i][4 * m + 3] = upd_t(Pm[i][4 * m + 3], d.w, pa, b.w);
          }
        }
      }
    }
    if constexpr (kPair) {
      float yl[2 * R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        yl[i] = dot(S[i], fr);
        yl[R + i] = dot(Pm[i], fr);
      }
      row_sums<2 * R>(yl);
      if (q == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          ybuf[(n - 1) * rows + lrow + i] = yl[i];
          rbuf[(n - 1) * rows + lrow + i] = yl[R + i];
        }
      }
    } else {
      float yl[R];
#pragma unroll
      for (int i = 0; i < R; ++i) yl[i] = dot(S[i], fr);
      row_sums<R>(yl);
      if (q == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i) ybuf[(n - 1) * rows + lrow + i] = yl[i];
      }
    }
    __syncthreads();  // stage s and ybuf are complete
    if (tid == 0 && c + 2 < nrun) issue(c + 2);
    // y of the run: n rows of `rows` values, 16-byte stores
    const int per = rows / 4;
    for (int u = tid; u < n * per; u += blockDim.x) {
      const int tt = u / per;
      const int j = (u - tt * per) * 4;
      const long long at =
          (static_cast<long long>(bb * T + c * tc + tt) * H + h) * kN +
          part * rows + j;
      *reinterpret_cast<float4*>(y + at) = ld4(ybuf + tt * rows + j);
      if constexpr (kPair)
        *reinterpret_cast<float4*>(rho + at) = ld4(rbuf + tt * rows + j);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int m = 0; m < kChunks; ++m) {
      *reinterpret_cast<float4*>(s_out + tile + (row0 + i) * kN +
                                 col(m, q)) =
          make_float4(S[i][4 * m], S[i][4 * m + 1], S[i][4 * m + 2],
                      S[i][4 * m + 3]);
      if constexpr (kPair)
        *reinterpret_cast<float4*>(p_out + tile + (row0 + i) * kN +
                                   col(m, q)) =
            make_float4(Pm[i][4 * m], Pm[i][4 * m + 1], Pm[i][4 * m + 2],
                        Pm[i][4 * m + 3]);
    }
}

// A launch plan: state rows of a (b, h) per block, tokens per staged run,
// state rows per thread.
struct Plan {
  int rows, tc, thread_rows;
};

// ops/wkv7.prefill_plan's rule (the card checks that the two agree)
Plan plan_for(int batch, int T, int H) {
  const long long heads = static_cast<long long>(batch) * H;
  if (heads < 128) return {16, 16, 1};
  if (heads < 512) return {64, T >= 512 ? 32 : 16, 4};
  return {64, 8, 4};
}

// the paired mode's plan for M chunks of L positions: ops/wkv7.pair_plan's
// rule, plan_for's with M chunk-heads walking L tokens, runs no longer
// than L
Plan pair_plan_for(int chunks, int L, int H) {
  Plan p = plan_for(chunks, L, H);
  if (p.tc > L) p.tc = L;
  return p;
}

// the paired mode's outputs
struct PairOut {
  float* rho;
  float* p_out;
};

template <int R, bool kPair>
int launch_r(const Maps& maps, const float* state_in, float* y,
             float* state_out, PairOut po, int batch, int T, int H, int rows,
             int tc, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv7_prefill_kernel<R, kPair>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      kPair ? smem_bytes(kN, kMaxPairTc, true) : smem_bytes(kN, kMaxTc));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(batch * H * (kN / rows)), block(rows * kLanes / R);
  wkv7_prefill_kernel<R, kPair>
      <<<grid, block, smem_bytes(rows, tc, kPair), st>>>(
          maps, state_in, y, state_out, po.rho, po.p_out, T, H, rows, tc);
  return static_cast<int>(cudaGetLastError());
}

// the sequential mode (po.rho null) or the paired mode over `batch` chunks
// of T positions
int launch(const float* r, const float* w, const float* k, const float* v,
           const float* a, const float* b, const float* state_in, float* y,
           float* state_out, int batch, int T, int H, Plan p, int device,
           void* stream, PairOut po = {nullptr, nullptr}) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const bool pair = po.rho != nullptr;
  if (batch < 1 || T < 1 || H < 1 || p.tc < 1 ||
      p.tc > (pair ? kMaxPairTc : kMaxTc) ||
      (p.rows != 16 && p.rows != 32 && p.rows != 64) ||
      (p.thread_rows != 1 && p.thread_rows != 4) ||
      (p.rows * kLanes / p.thread_rows) % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  const float* src[kVecs] = {r, w, k, v, a, b};
  for (int j = 0; j < kVecs; ++j) {
    const int err = encode_map(
        &maps.m[j], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, src[j],
        static_cast<long long>(batch) * T, static_cast<long long>(H) * kN,
        static_cast<long long>(H) * kN * 4, p.tc, kN,
        CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err) return err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pair) {
    if (p.thread_rows == 4)
      return launch_r<4, true>(maps, state_in, y, state_out, po, batch, T, H,
                               p.rows, p.tc, st);
    return launch_r<1, true>(maps, state_in, y, state_out, po, batch, T, H,
                             p.rows, p.tc, st);
  }
  if (p.thread_rows == 4)
    return launch_r<4, false>(maps, state_in, y, state_out, po, batch, T, H,
                              p.rows, p.tc, st);
  return launch_r<1, false>(maps, state_in, y, state_out, po, batch, T, H,
                            p.rows, p.tc, st);
}

}  // namespace

// r, w, k, v, a, b, y: [B, T, H, 64] f32; state_in, state_out: [B, H, 64,
// 64] f32; all contiguous, state_out distinct from state_in. Launches on
// `stream` of card `device` under plan_for's plan and returns a CUDA error
// code (0 on success).
extern "C" int wkv7_prefill(const float* r, const float* w, const float* k,
                            const float* v, const float* a, const float* b,
                            const float* state_in, float* y, float* state_out,
                            int batch, int T, int H, int device,
                            void* stream) {
  return launch(r, w, k, v, a, b, state_in, y, state_out, batch, T, H,
                plan_for(batch, T, H), device, stream);
}

// The same kernel and arguments as wkv7_prefill, launched through the entry
// point that stands for rwkv_tts_tpu/ops/wkv7.py:103 wkv7_pallas.
extern "C" int wkv7_seq(const float* r, const float* w, const float* k,
                        const float* v, const float* a, const float* b,
                        const float* state_in, float* y, float* state_out,
                        int batch, int T, int H, int device, void* stream) {
  return wkv7_prefill(r, w, k, v, a, b, state_in, y, state_out, batch, T, H,
                      device, stream);
}

// The same kernel under a given plan (`rows` of 16, 32 or 64 state rows a
// block, runs of `tc` <= 64 tokens, `thread_rows` of 1 or 4 rows a
// thread), for measuring the plans.
extern "C" int wkv7_prefill_planned(const float* r, const float* w,
                                    const float* k, const float* v,
                                    const float* a, const float* b,
                                    const float* state_in, float* y,
                                    float* state_out, int batch, int T, int H,
                                    int rows, int tc, int thread_rows,
                                    int device, void* stream) {
  return launch(r, w, k, v, a, b, state_in, y, state_out, batch, T, H,
                {rows, tc, thread_rows}, device, stream);
}

// plan_for's plan, for the check that it is ops/wkv7.prefill_plan's.
extern "C" int wkv7_prefill_plan(int batch, int T, int H, int* rows, int* tc,
                                 int* thread_rows) {
  const Plan p = plan_for(batch, T, H);
  *rows = p.rows;
  *tc = p.tc;
  *thread_rows = p.thread_rows;
  return 0;
}

// The paired phase A: r, w, k, v, a, b, y_loc, rho: [M, L, H, 64] f32
// (M = chunks, L >= 1); s_loc, P: [M, H, 64, 64] f32; all contiguous.
// Launches on `stream` of card `device` under pair_plan_for's plan and
// returns a CUDA error code (0 on success).
extern "C" int wkv7_chunk_pair(const float* r, const float* w, const float* k,
                               const float* v, const float* a, const float* b,
                               float* y_loc, float* rho, float* s_loc,
                               float* P, int chunks, int L, int H, int device,
                               void* stream) {
  return launch(r, w, k, v, a, b, nullptr, y_loc, s_loc, chunks, L, H,
                pair_plan_for(chunks, L, H), device, stream, {rho, P});
}

// The paired phase A under a given plan (`rows` of 16, 32 or 64 state rows
// a block, runs of `tc` <= 32 tokens, `thread_rows` of 1 or 4), for
// measuring the plans.
extern "C" int wkv7_chunk_pair_planned(const float* r, const float* w,
                                       const float* k, const float* v,
                                       const float* a, const float* b,
                                       float* y_loc, float* rho,
                                       float* s_loc, float* P, int chunks,
                                       int L, int H, int rows, int tc,
                                       int thread_rows, int device,
                                       void* stream) {
  return launch(r, w, k, v, a, b, nullptr, y_loc, s_loc, chunks, L, H,
                {rows, tc, thread_rows}, device, stream, {rho, P});
}

// pair_plan_for's plan, for the check that it is ops/wkv7.pair_plan's.
extern "C" int wkv7_chunk_pair_plan(int chunks, int L, int H, int* rows,
                                    int* tc, int* thread_rows) {
  const Plan p = pair_plan_for(chunks, L, H);
  *rows = p.rows;
  *tc = p.tc;
  *thread_rows = p.thread_rows;
  return 0;
}
