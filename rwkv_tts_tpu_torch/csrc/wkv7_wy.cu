// WY chunked prefill WKV-7, phase A: every (batch, chunk, head) cell of a
// prompt at once.
//
// Replaces the TPU kernel rwkv_tts_tpu/ops/wkv7.py:1120
// wkv7_chunked_wy_pallas (body _wkv7_chunk_wy_kernel, :1041-1116). It
// computes what the plain version wkv7_chunk_wy computes, per cell of L
// positions and one head (N = 64):
//
//   ld = -exp(w), lw = cumsum_t(ld), e = exp(lw), e_L = e[L-1]
//   a^ = a * exp(lw - ld), b* = b * exp(-lw), k* = k * exp(-lw), r^ = r * e
//   G  = (a^ b*^T) strict-lower,   K  = (a^ k*^T) strict-lower
//   R1 = (r^ b*^T) lower,          R2 = (r^ k*^T) lower
//   (I - G) [h | xa] = [K v | a^]
//   y_loc = R1 h + R2 v,   rho = r^ + R1 xa
//   P     = xa^T b~ + diag(e_L),   s_loc = h^T b~ + v^T k~
//   (b~ = b* e_L, k~ = k* e_L)
//
// Phases B and C (the scan over chunks and the inter-chunk term) are batched
// matrix products in PyTorch (ops/wkv7.py _chunk_combine), as the JAX package
// left them to XLA.
//
// Inputs r, w, k, v, a, b are [B, T, H, N] f32 (w is the log-log decay) and
// are read as [B*n_c, L, H, N]; outputs y_loc and rho are [B, T, H, N] f32,
// s_loc and P [B*n_c, H, N, N] f32 (P with its diagonal). L is a power of two
// from 4 to 64 and divides T. Cells are numbered along the flattened B*T
// axis, so consecutive cells of a head are consecutive rows of it.
//
// Bound: bytes. A cell reads six [L, 64] tiles and writes two [L, 64] tiles
// and two 64 x 64 summaries once (160 KB at L = 64). The function needs
// 5 L^2 N + 3 N^2 L multiply-adds a cell (4.2 MFLOP at L = 64); on the
// tensor cores at 3xTF32 (three TF32 products for each f32 one) that takes
// about half as long as the bytes, on FFMA about 1.3 times as long.
//
// Design.
// - Only the needed work. The scores G, K, R1 and R2 are formed on their
//   lower-triangular 16 x 16 tiles only (10 of 16 at L = 64), and (I - G)
//   is not inverted: a blocked forward substitution solves the unit
//   lower-triangular system for the 64 x 128 right side [K v | a^]. Row
//   block I's right side gathers K_IJ v_J (J <= I) and G_IJ [h_J | xa_J]
//   (J < I) as products; then the 16 x 16 diagonal block is solved row by
//   row on FFMA, one thread a column. 4.7 MFLOP a cell at L = 64, where
//   full 64^3 products with X = (I - G)^-1 by doublings would run 12.1.
// - Tensor cores at f32 accuracy. Every product runs on mma.sync
//   m16n8k8 TF32 as 3xTF32: each operand x splits into hi = tf32(x) and
//   lo = tf32(x - hi) (tf32 cuts the mantissa to 10 bits), and
//   lo_a hi_b + hi_a lo_b + hi_a hi_b is summed in f32 (lo_a lo_b and lo's
//   own cut, each under 2^-20 of the product, are dropped). One TF32
//   product would not do: TF32 keeps f32's 8-bit exponent, so the exp(-lw)
//   factors (up to ~7e16 at L = 64) are in range, but its 10-bit mantissa
//   moves each operand by up to 2^-10 (~1e-3 relative), ten times the
//   1e-4 relative the card test holds phase A to. The three-term sum
//   agrees with the plain f32 version to ~1.5e-6 of each output's largest
//   value (tests/test_torch_wy.py transcribes it).
// - Memory. A cell's six tiles arrive once by 16-byte cp.async into seven
//   [Lp, 64] f32 slots (Lp = max(L, 16): rows past the block's cells are
//   zeros), 112 KB at L = 64, so two blocks share an SM. Slots are reused as tiles die: w
//   becomes K (strict lower) with G transposed beside it (strict upper),
//   then R1 (lower) with R2 transposed (strict upper, its diagonal apart);
//   a^ becomes xa in place; the decay prefix's partial sums use h's slot
//   before h exists. Rows are XOR-swizzled (sw below) so that the
//   fragment loads of both access patterns, a warp's 8 rows x 4 columns
//   and its 4 rows x 8 columns, hit 32 distinct banks.
// - Decay prefix: a parallel scan, all 256 threads (4 row segments x 64
//   columns, segment totals through shared memory).
// - One block of 8 warps a cell; a warp owns 16-row output tiles of 16 or
//   32 columns; a barrier between dependent products only.
// - Short chunks packed. At L < 16 a block takes m = 16 / L consecutive
//   cells of one head as one 16-row tile (the last block of a grid may hold
//   fewer): the scores are zero between cells, so G, K, R1 and R2 are
//   block-diagonal and the substitution solves every cell at once; the
//   decay prefix restarts at each cell; each cell's s_loc and P sum its own
//   rows (a product over its k-steps, the other cells' rows masked). A cell
//   of 4 rows padded alone to 16 would run four times its work and launch
//   four times the blocks.
// expf, not __expf, and no fast-math: a padded position's w = -30 must
// give a decay of exactly 1.0f, as in the scan. y_loc = (R1 h) + (R2 v) and
// s_loc = (h^T b~) + (v^T k~): each product is summed on its own and the two
// are then added, as the plain version adds two einsum results.

#include "sm90.cuh"

namespace {

constexpr int kN = 64;            // head size
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 7;

// a row's swizzle: 8 consecutive rows get 8 distinct values, and rows
// 0-3 (and 4-7) distinct halves of them
__device__ __forceinline__ int swz(int row) {
  return ((row & 3) << 1) | ((row >> 2) & 1);
}

// element (row, col) of a swizzled [rows, 64] f32 tile: columns move by a
// multiple of 4 within their 32-column half, so 16-byte chunks stay whole
__device__ __forceinline__ int sw(int row, int col) {
  return row * kN + (col ^ (swz(row) << 2));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// x cut to TF32: its low 13 mantissa bits cleared, one integer
// instruction (cvt.rna.tf32.f32 runs on the conversion pipe, which issues
// a quarter as often; two of them an operand held the products back)
__device__ __forceinline__ uint32_t tf32(float x) {
  return __float_as_uint(x) & 0xFFFFE000u;
}

// x = hi + lo + (what lo's cut drops, under 2^-20 |x|), hi and lo TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// not volatile: the compiler may interleave independent products
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This lane's place in the mma.sync m16n8k8 TF32 fragments (A: (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B: (t, g), (t + 4, g); C: (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)) and the swizzle masks its
// operand reads need, computed once: a step's reads then cost an add or two.
struct Frag {
  int g, t;
  int c3, m4;    // XK: rows x = g (mod 8) have sw's mask 8 c3 + m4
  int pt0, pt1;  // KX: rows t and t + 4 (mod 8) have masks pt0, pt1
};

__device__ __forceinline__ Frag frag() {
  Frag f;
  const int lane = threadIdx.x & 31;
  f.g = lane >> 2;
  f.t = lane & 3;
  const int p = swz(f.g);
  f.c3 = p >> 1;
  f.m4 = (p & 1) << 2;
  f.pt0 = swz(f.t) << 2;
  f.pt1 = swz(f.t + 4) << 2;
  return f;
}

// An operand's element (x, k) of a swizzled tile, x the output row (of A)
// or column (of B), k the summed index, k = 8 s + t + 4 h in this lane's
// step s and half h; x = g (mod 8). XK: stored at tile row x, column k
// (sw's column k ^ (8 c3 + m4) = 8 (s ^ c3) + t + (h ? 4 - m4 : m4)). KX:
// stored at tile row k, column x.
struct XK {
  const float* p;
  __device__ __forceinline__ float operator()(const Frag& f, int x, int s,
                                              int h) const {
    return p[x * kN + 8 * (s ^ f.c3) + f.t + (h ? 4 - f.m4 : f.m4)];
  }
};

struct KX {
  const float* p;
  __device__ __forceinline__ float operator()(const Frag& f, int x, int s,
                                              int h) const {
    return p[(8 * s + f.t + 4 * h) * kN + (x ^ (h ? f.pt1 : f.pt0))];
  }
};

// acc[p][q][n] += sum over steps s in [s0, s1) of A_p B_q on the warp's
// 16 x 8 NT output tiles, in 3xTF32: NA row operands and NB column
// operands, every pair a product, each operand split once a step.
// A(p, r, s, h) returns this lane's element of A_p's row g + 8 r and half
// h, B(q, n, s, h) its element of B_q's n-th tile, both as f32 (masked
// entries as 0). Within a step every accumulator takes lo_a hi_b, then
// hi_a lo_b, then hi_a hi_b, and the accumulators' products interleave, so
// that consecutive mma.sync do not wait on each other; two steps are
// unrolled, so that the next step's reads start under this one's products.
template <int NA, int NB, int NT, typename FA, typename FB>
__device__ __forceinline__ void mma_tile(float (&acc)[NA][NB][NT][4], int s0,
                                         int s1, FA A, FB B) {
#pragma unroll 2
  for (int s = s0; s < s1; ++s) {
    uint32_t ah[NA][4], al[NA][4];
#pragma unroll
    for (int p = 0; p < NA; ++p) {
      split(A(p, 0, s, 0), ah[p][0], al[p][0]);
      split(A(p, 1, s, 0), ah[p][1], al[p][1]);
      split(A(p, 0, s, 1), ah[p][2], al[p][2]);
      split(A(p, 1, s, 1), ah[p][3], al[p][3]);
    }
    uint32_t bh[NB][NT][2], bl[NB][NT][2];
#pragma unroll
    for (int q = 0; q < NB; ++q)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        split(B(q, n, s, 0), bh[q][n][0], bl[q][n][0]);
        split(B(q, n, s, 1), bh[q][n][1], bl[q][n][1]);
      }
#pragma unroll
    for (int p = 0; p < NA; ++p)
#pragma unroll
      for (int q = 0; q < NB; ++q)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma(acc[p][q][n], al[p], bh[q][n][0], bh[q][n][1]);
#pragma unroll
    for (int p = 0; p < NA; ++p)
#pragma unroll
      for (int q = 0; q < NB; ++q)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma(acc[p][q][n], ah[p], bl[q][n][0], bl[q][n][1]);
#pragma unroll
    for (int p = 0; p < NA; ++p)
#pragma unroll
      for (int q = 0; q < NB; ++q)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma(acc[p][q][n], ah[p], bh[q][n][0], bh[q][n][1]);
  }
}

// out(q, i, j, c_j, c_j+1) for each pair of adjacent outputs this lane
// holds of the NB products acc[q] (j even)
template <int NB, int NT, typename Out>
__device__ __forceinline__ void tile_out(const float (&acc)[NB][NT][4],
                                         int i0, int j0, Out out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        out(q, i0 + g + 8 * hf, j0 + 8 * n + 2 * t, acc[q][n][2 * hf],
            acc[q][n][2 * hf + 1]);
}

template <int NA, int NB, int NT>
__device__ __forceinline__ void zero(float (&acc)[NA][NB][NT][4]) {
#pragma unroll
  for (int p = 0; p < NA; ++p)
#pragma unroll
    for (int q = 0; q < NB; ++q)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][q][n][e] = 0.0f;
}

// the (I, J) block, I >= J, of lower-triangular block index u
__device__ __forceinline__ void tri_block(int u, int& I, int& J) {
  I = 0;
  while ((I + 1) * (I + 2) / 2 <= u) ++I;
  J = u - I * (I + 1) / 2;
}

__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// kPacked: L < 16, m = 16 / L cells a block; else one cell of L rows
template <bool kPacked>
__global__ void __launch_bounds__(kThreads, 2)
wkv7_wy_kernel(const float* __restrict__ r, const float* __restrict__ w,
               const float* __restrict__ k, const float* __restrict__ v,
               const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ y_loc, float* __restrict__ rho,
               float* __restrict__ s_loc, float* __restrict__ P, int H,
               int L, int n_cells) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Lp = kPacked ? 16 : L;  // rows of a slot
  const int ls = __ffs(L) - 1;      // row t lies in cell t >> ls
  const int m = kPacked ? 16 >> ls : 1;  // cells of the block
  const int nb = Lp >> 4;           // 16-row blocks
  const int tile = Lp * kN;
  float* Rs = smem;                 // r, then r^
  float* As = Rs + tile;            // a, then a^, then xa
  float* Bs = As + tile;            // b, then b*, then b~
  float* Ks = Bs + tile;            // k, then k*, then k~
  float* Vs = Ks + tile;            // v
  float* Fs = Vs + tile;            // w; K | G^T; R1 | R2^T
  float* Hs = Fs + tile;            // the prefix's partial sums; then h
  float* e_l = Hs + tile;           // [m, 64]
  float* d2 = e_l + m * kN;         // [64] R2's diagonal

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int h = blockIdx.x % H;
  const int cell = blockIdx.x / H * m;  // the first cell, b * n_c + chunk
  // rows of the block's cells
  const int Lv = kPacked ? min(m, n_cells - cell) * L : L;
  // element (row t of the block, head h, channel n) of a [B, T, H, N]
  // tensor: the first cell's first position is cell * L of the flattened
  // B*T axis
  const long long stride_t = static_cast<long long>(H) * kN;
  const long long base = static_cast<long long>(cell) * L * stride_t + h * kN;
  // element (i, j) of cell c's [N, N] summary: sum_base + c * H * N * N
  const long long sum_base = (static_cast<long long>(cell) * H + h) * kN * kN;
  // rows i and j lie in one cell
  auto same = [&](int i, int j) {
    return !kPacked || (i >> ls) == (j >> ls);
  };
  // the cell of row t
  auto cell_of = [&](int t) { return kPacked ? t >> ls : 0; };

  // the block's six tiles, 16 bytes a copy, slots in the order r, a, b, k,
  // v, w; rows Lv .. Lp-1 are zeros
  for (int idx = tid; idx < 6 * Lp * 16; idx += kThreads) {
    const int s = idx / (Lp * 16);
    const int rem = idx - s * Lp * 16;
    const int t = rem >> 4, c = (rem & 15) << 2;
    float* d = smem + s * tile + sw(t, c);
    const float* src = s == 0 ? r : s == 1 ? a : s == 2 ? b
                     : s == 3 ? k : s == 4 ? v : w;
    if (t < Lv)
      cp_async16(d, src + base + t * stride_t + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  cp_async_wait_all();
  __syncthreads();

  // lw = inclusive prefix of ld = -exp(w) down each column, within each
  // cell: thread (segment s, column n) sums its Lp / 4 rows, the totals of
  // the segments of its cell before it meet in Hs, then each thread scales
  // its rows
  {
    const int n = tid & (kN - 1), s = tid >> 6, seg = Lp >> 2;
    float ld[16];
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i < seg) {
        const int t = s * seg + i;
        ld[i] = t < Lv ? -expf(Fs[sw(t, n)]) : 0.0f;
        part += ld[i];
      }
    }
    Hs[s * kN + n] = part;
    __syncthreads();
    float lw = 0.0f;
    for (int q = (cell_of(s * seg) << ls) / seg; q < s; ++q)
      lw += Hs[q * kN + n];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i < seg) {
        const int t = s * seg + i;
        lw += ld[i];
        const int e = sw(t, n);
        const float inv = expf(-lw);
        As[e] *= expf(lw - ld[i]);
        Bs[e] *= inv;
        Ks[e] *= inv;
        Rs[e] *= expf(lw);
        if (((t + 1) & (L - 1)) == 0) e_l[cell_of(t) * kN + n] = expf(lw);
      }
    }
  }
  __syncthreads();

  const Frag f = frag();
  const XK a_xk{As}, b_xk{Bs}, k_xk{Ks}, r_xk{Rs}, f_xk{Fs};
  const KX a_kx{As}, b_kx{Bs}, k_kx{Ks}, v_kx{Vs}, h_kx{Hs}, f_kx{Fs};

  // G and K on the lower 16 x 16 blocks (one A, two B): K strictly lower
  // at Fs(i, j), G transposed at Fs(j, i), strictly upper (the diagonal is
  // neither's), both zero between cells
  for (int u = warp; u < nb * (nb + 1) / 2; u += kWarps) {
    int I, J;
    tri_block(u, I, J);
    float acc[1][2][2][4];
    zero(acc);
    mma_tile(
        acc, 0, kN / 8,
        [&](int, int rr, int s, int h) {
          return a_xk(f, 16 * I + f.g + 8 * rr, s, h);
        },
        [&](int q, int n, int s, int h) {
          return (q ? k_xk : b_xk)(f, 16 * J + 8 * n + f.g, s, h);
        });
    tile_out(acc[0], 16 * I, 16 * J,
             [&](int q, int i, int j, float c0, float c1) {
               c0 = same(i, j) ? c0 : 0.0f;
               c1 = same(i, j + 1) ? c1 : 0.0f;
               if (q) {
                 if (j < i) Fs[sw(i, j)] = c0;
                 if (j + 1 < i) Fs[sw(i, j + 1)] = c1;
               } else {
                 if (j < i) Fs[sw(j, i)] = c0;
                 if (j + 1 < i) Fs[sw(j + 1, i)] = c1;
               }
             });
  }
  __syncthreads();

  // (I - G) [h | xa] = [K v | a^], block row by block row. The right side
  // of block row I: warps 0-3 h's columns 16 q .. 16 q + 15 (K v over the
  // blocks J <= I, K masked in the diagonal block, and G h over J < I),
  // warps 4-7 xa's (a^ + G xa over J < I); G(i, c) is Fs(c, i)
  for (int I = 0; I < nb; ++I) {
    const int i0 = 16 * I, j0 = 16 * (warp & 3);
    float acc[1][1][2][4];
    zero(acc);
    auto row = [&](int rr) { return i0 + f.g + 8 * rr; };
    auto G = [&](int, int rr, int s, int h) { return f_kx(f, row(rr), s, h); };
    auto Bcol = [&](const KX& op) {
      return [&, op](int, int n, int s, int h) {
        return op(f, j0 + 8 * n + f.g, s, h);
      };
    };
    if (warp < 4) {
      mma_tile(acc, 0, 2 * I,
               [&](int, int rr, int s, int h) {
                 return f_xk(f, row(rr), s, h);
               },
               Bcol(v_kx));
      mma_tile(acc, 2 * I, 2 * I + 2,
               [&](int, int rr, int s, int h) {
                 return 8 * s + f.t + 4 * h < row(rr)
                            ? f_xk(f, row(rr), s, h) : 0.0f;
               },
               Bcol(v_kx));
      mma_tile(acc, 0, 2 * I, G, Bcol(h_kx));
      tile_out(acc[0], i0, j0, [&](int, int i, int j, float c0, float c1) {
        st2(&Hs[sw(i, j)], c0, c1);
      });
    } else {
      mma_tile(acc, 0, 2 * I, G, Bcol(a_kx));
      tile_out(acc[0], i0, j0, [&](int, int i, int j, float c0, float c1) {
        float2* p = reinterpret_cast<float2*>(&As[sw(i, j)]);
        const float2 x = *p;
        *p = make_float2(x.x + c0, x.y + c1);
      });
    }
    __syncthreads();
    // the diagonal block, row by row: thread c solves column c of [h | xa]
    if (tid < 2 * kN) {
      float* X = tid < kN ? Hs : As;
      const int col = tid & (kN - 1);
      float x[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] = X[sw(i0 + i, col)];
#pragma unroll
      for (int i = 1; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < i; ++j)
          x[i] = fmaf(Fs[sw(i0 + j, i0 + i)], x[j], x[i]);
#pragma unroll
      for (int i = 1; i < 16; ++i) X[sw(i0 + i, col)] = x[i];
    }
    __syncthreads();
  }

  // R1 and R2 on the lower blocks (one A, two B): R1 at Fs(i, j), j <= i;
  // R2 transposed at Fs(j, i), j < i, its diagonal in d2; zero between
  // cells
  for (int u = warp; u < nb * (nb + 1) / 2; u += kWarps) {
    int I, J;
    tri_block(u, I, J);
    float acc[1][2][2][4];
    zero(acc);
    mma_tile(
        acc, 0, kN / 8,
        [&](int, int rr, int s, int h) {
          return r_xk(f, 16 * I + f.g + 8 * rr, s, h);
        },
        [&](int q, int n, int s, int h) {
          return (q ? k_xk : b_xk)(f, 16 * J + 8 * n + f.g, s, h);
        });
    tile_out(acc[0], 16 * I, 16 * J,
             [&](int q, int i, int j, float c0, float c1) {
               c0 = same(i, j) ? c0 : 0.0f;
               c1 = same(i, j + 1) ? c1 : 0.0f;
               if (q) {
                 if (j < i) Fs[sw(j, i)] = c0;
                 if (j == i) d2[i] = c0;
                 if (j + 1 < i) Fs[sw(j + 1, i)] = c1;
                 if (j + 1 == i) d2[i] = c1;
               } else {
                 if (j <= i) Fs[sw(i, j)] = c0;
                 if (j + 1 <= i) Fs[sw(i, j + 1)] = c1;
               }
             });
  }
  __syncthreads();

  // y_loc = (R1 h) + (R2 v) and rho = r^ + R1 xa, straight to device
  // memory, in units of 16 rows (block row I) x 16 columns (group w % 4):
  // R1 h and R1 xa share R1's split. Block row I costs I + 1 steps a
  // product, so at L = 64 warps w and w + 4 take block rows {p, 3 - p}
  // (p = w / 4), the same work each; at nb = 2 warp w takes block row
  // w / 4, at nb = 1 warps 0-3 the one block row. R1 and R2 are masked in
  // the diagonal block only.
  for (int u = warp; u < (nb == 4 ? 8 : 4 * nb); u += kWarps) {
    const int p = u >> 2;
    for (int pass = 0; pass < (nb == 4 ? 2 : 1); ++pass) {
      const int I = pass ? nb - 1 - p : p;
      const int i0 = 16 * I, j0 = 16 * (u & 3);
      auto row = [&](int rr) { return i0 + f.g + 8 * rr; };
      auto Bcol = [&](int q, int n, int s, int h) {
        return (q ? a_kx : h_kx)(f, j0 + 8 * n + f.g, s, h);
      };
      float acc[1][2][2][4], y2[1][1][2][4];
      zero(acc);
      zero(y2);
      mma_tile(acc, 0, 2 * I,
               [&](int, int rr, int s, int h) {
                 return f_xk(f, row(rr), s, h);
               },
               Bcol);
      mma_tile(acc, 2 * I, 2 * I + 2,
               [&](int, int rr, int s, int h) {
                 return 8 * s + f.t + 4 * h <= row(rr)
                            ? f_xk(f, row(rr), s, h) : 0.0f;
               },
               Bcol);
      auto Bv = [&](int, int n, int s, int h) {
        return v_kx(f, j0 + 8 * n + f.g, s, h);
      };
      mma_tile(y2, 0, 2 * I,
               [&](int, int rr, int s, int h) {
                 return f_kx(f, row(rr), s, h);
               },
               Bv);
      mma_tile(y2, 2 * I, 2 * I + 2,
               [&](int, int rr, int s, int h) {
                 const int k = 8 * s + f.t + 4 * h, x = row(rr);
                 return k < x ? f_kx(f, x, s, h) : k == x ? d2[x] : 0.0f;
               },
               Bv);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][0][n][e] += y2[0][0][n][e];
      tile_out(acc[0], i0, j0, [&](int q, int i, int j, float c0, float c1) {
        if (i >= Lv) return;
        if (q) {
          const float2 x = *reinterpret_cast<const float2*>(&Rs[sw(i, j)]);
          st2(rho + base + i * stride_t + j, x.x + c0, x.y + c1);
        } else {
          st2(y_loc + base + i * stride_t + j, c0, c1);
        }
      });
    }
  }
  // b~ = b* e_L, k~ = k* e_L (R1 and R2, their last readers, are formed)
  for (int idx = tid; idx < tile; idx += kThreads) {
    const int t = idx >> 6, n = idx & (kN - 1);
    const int e = sw(t, n);
    Bs[e] *= e_l[cell_of(t) * kN + n];
    Ks[e] *= e_l[cell_of(t) * kN + n];
  }
  __syncthreads();

  // P = xa^T b~ + diag(e_L) and s_loc = (h^T b~) + (v^T k~) over each
  // cell's rows (rows past Lv are zeros), in 16 x 32 units: warp w takes
  // block row w / 2, columns 32 (w % 2) .. of both; xa^T b~ and h^T b~
  // share b~'s split. A packed block sums cell c over its k-steps, the
  // other cells' rows of b~ and k~ masked.
  const int i0 = 16 * (warp >> 1), j0 = 32 * (warp & 1);
  auto row = [&](int rr) { return i0 + f.g + 8 * rr; };
  auto sums = [&](int c, int s0, int s1) {
    auto in = [&](int s, int h) {
      return !kPacked || ((8 * s + f.t + 4 * h) >> ls) == c;
    };
    const long long out = sum_base + static_cast<long long>(c) * H * kN * kN;
    float acc[2][1][4][4], acc2[1][1][4][4];
    zero(acc);
    zero(acc2);
    mma_tile(acc, s0, s1,
             [&](int pp, int rr, int s, int h) {
               return (pp ? h_kx : a_kx)(f, row(rr), s, h);
             },
             [&](int, int n, int s, int h) {
               return in(s, h) ? b_kx(f, j0 + 8 * n + f.g, s, h) : 0.0f;
             });
    tile_out(acc[0], i0, j0, [&](int, int i, int j, float c0, float c1) {
      st2(P + out + i * kN + j, c0 + (i == j ? e_l[c * kN + j] : 0.0f),
          c1 + (i == j + 1 ? e_l[c * kN + j + 1] : 0.0f));
    });
    mma_tile(acc2, s0, s1,
             [&](int, int rr, int s, int h) { return v_kx(f, row(rr), s, h); },
             [&](int, int n, int s, int h) {
               return in(s, h) ? k_kx(f, j0 + 8 * n + f.g, s, h) : 0.0f;
             });
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[1][0][n][e] += acc2[0][0][n][e];
    tile_out(acc[1], i0, j0, [&](int, int i, int j, float c0, float c1) {
      st2(s_loc + out + i * kN + j, c0, c1);
    });
  };
  if constexpr (kPacked) {
    for (int c = 0; c < Lv >> ls; ++c)
      sums(c, c * L / 8, (c * L + L + 7) / 8);
  } else {
    sums(0, 0, Lp / 8);
  }
}

}  // namespace

// r, w, k, v, a, b, y_loc, rho: [B, T, H, 64] f32; s_loc, P: [B*T/L, H, 64,
// 64] f32; all contiguous, the inputs 16-byte aligned. L is a power of two
// in [4, 64] dividing T. Launches on `stream` of card `device` and returns
// cudaGetLastError() (or the error of the set-up call that failed).
extern "C" int wkv7_wy(const float* r, const float* w, const float* k,
                       const float* v, const float* a, const float* b,
                       float* y_loc, float* rho, float* s_loc, float* P,
                       int batch, int T, int H, int L, int device,
                       void* stream) {
  if (L < 4 || L > kN || (L & (L - 1)) || T % L || batch < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ins[6] = {r, w, k, v, a, b};
  for (const float* p : ins)
    if (reinterpret_cast<uintptr_t>(p) & 15)
      return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Lp = L < 16 ? 16 : L, m = Lp / L;
  const int smem = static_cast<int>((kSlots * Lp * kN + (m + 1) * kN) *
                                    sizeof(float));
  static const cudaError_t attr = [] {
    auto set = [](auto kern) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>((kSlots * kN * kN + 2 * kN) * sizeof(float)));
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      return e;
    };
    const cudaError_t e = set(wkv7_wy_kernel<false>);
    return e == cudaSuccess ? set(wkv7_wy_kernel<true>) : e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_cells = batch * (T / L);
  const dim3 grid((n_cells + m - 1) / m * H), block(kThreads);
  auto* kern = m > 1 ? wkv7_wy_kernel<true> : wkv7_wy_kernel<false>;
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      r, w, k, v, a, b, y_loc, rho, s_loc, P, H, L, n_cells);
  return static_cast<int>(cudaGetLastError());
}
