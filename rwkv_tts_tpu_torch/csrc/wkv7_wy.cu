// WY chunked prefill WKV-7, phase A: every (batch, chunk, head) cell of a
// prompt at once.
//
// Replaces the TPU kernel rwkv_tts_tpu/ops/wkv7.py:1120
// wkv7_chunked_wy_pallas (body _wkv7_chunk_wy_kernel, :1041-1116). It
// computes what the plain version wkv7_chunk_wy (:957-1021) computes, per
// cell of L positions and one head (N = 64):
//
//   ld = -exp(w), lw = cumsum_t(ld), e = exp(lw), e_L = e[L-1]
//   a^ = a * exp(lw - ld), b* = b * exp(-lw), k* = k * exp(-lw), r^ = r * e
//   G  = (a^ b*^T) strict-lower,   K  = (a^ k*^T) strict-lower
//   R1 = (r^ b*^T) lower,          R2 = (r^ k*^T) lower
//   X  = (I - G)^-1 by wy_doublings(L) nilpotent doublings
//   h  = X (K v),  xa = X a^
//   y_loc = R1 h + R2 v,   rho = r^ + R1 xa
//   P     = xa^T (b* e_L) + diag(e_L),   s_loc = h^T (b* e_L) + v^T (k* e_L)
//
// Phases B and C (the scan over chunks and the inter-chunk term) are batched
// matrix products in PyTorch (ops/wkv7.py _chunk_combine), as the JAX package
// left them to XLA.
//
// Inputs r, w, k, v, a, b are [B, T, H, N] f32 (w is the log-log decay) and
// are read as [B*n_c, L, H, N]; outputs y_loc and rho are [B, T, H, N] f32,
// s_loc and P [B*n_c, H, N, N] f32 (P with its diagonal). L is a power of two
// from 4 to 64 and divides T.
//
// Bound: operations. The function needs 5 L^2 N + 3 N^2 L multiply-adds per
// cell (triangular scores and applications, triangular solves for h and
// xa, three outer-product sums), 4.2 MFLOP at L = 64 against ~160 KB of
// traffic. This simple design does more than that: full L x L products
// whose upper triangle is then masked, and X formed by doublings, 23
// products of 64 x 64 x 64 at L = 64 (about 12 MFLOP). All products are
// f32 FFMA: the exp(-lw) factors reach ~7e16 at L = 64, and TF32's 10-bit
// mantissa would not hold the 3e-4 the plain version is held to.
// Design, simple first: one block of 256 threads per cell. The cell's 12
// tiles of L x 64 f32 live in dynamic shared memory (196 KB at L = 64), rows
// padded to 65 floats so that walks down a column hit distinct banks. Each
// product gives every thread a 4 x 4 register tile of outputs (rows and
// columns strided by a quarter of the output, so a warp's loads are
// broadcasts or consecutive words). The decay prefix runs once per column.
// expf, not __expf, and no fast-math: a padded position's w = -30 must give
// a decay of exactly 1.0f, as in the scan.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 64;            // head size
constexpr int kThreads = 256;
constexpr int kLd = kN + 1;       // row stride of every shared tile, floats
constexpr int kTiles = 12;

// C(i, j) = sum_k A(i, k) B(k, j) over an M x Nc output (M, Nc multiples of
// 4, at most 64), A(i, k) = A[i*ai + k*ak], B(k, j) = B[k*bk + j*bj]. Each
// thread owns rows ti + q*M/4 and columns tj + p*Nc/4 and calls out(i, j, c)
// for each of its 16 results. Threads beyond the tiling do nothing; the
// caller synchronises.
template <typename Out>
__device__ __forceinline__ void matmul(const float* A, int ai, int ak,
                                       const float* B, int bk, int bj, int M,
                                       int Nc, int K, Out out) {
  const int tm = M >> 2, tn = Nc >> 2;
  if (static_cast<int>(threadIdx.x) >= tm * tn) return;
  const int ti = threadIdx.x / tn, tj = threadIdx.x - ti * tn;
  float acc[4][4] = {};
  for (int kk = 0; kk < K; ++kk) {
    float x[4], y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = A[(ti + q * tm) * ai + kk * ak];
#pragma unroll
    for (int p = 0; p < 4; ++p) y[p] = B[kk * bk + (tj + p * tn) * bj];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[q][p] = fmaf(x[q], y[p], acc[q][p]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) out(ti + q * tm, tj + p * tn, acc[q][p]);
}

__global__ void __launch_bounds__(kThreads)
wkv7_wy_kernel(const float* __restrict__ r, const float* __restrict__ w,
               const float* __restrict__ k, const float* __restrict__ v,
               const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ y_loc, float* __restrict__ rho,
               float* __restrict__ s_loc, float* __restrict__ P, int H, int L,
               int n_doub) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int h = blockIdx.x % H;
  const int cell = blockIdx.x / H;       // b * n_c + chunk
  // element (position t of the cell, head h, channel n) of a [B, T, H, N]
  // tensor: the cell's first position is cell * L of the flattened B*T axis
  const long long stride_t = static_cast<long long>(H) * kN;
  const long long base = static_cast<long long>(cell) * L * stride_t + h * kN;
  // element (i, j) of this cell's [N, N] summary
  const long long sum_base = (static_cast<long long>(cell) * H + h) * kN * kN;

  const int tile = L * kLd;
  float* Rh = smem;           // r, then r^
  float* Ah = Rh + tile;      // a, then a^
  float* Bs = Ah + tile;      // b, then b*, then b* e_L
  float* Ks = Bs + tile;      // k, then k*, then k* e_L
  float* V = Ks + tile;
  float* G2 = V + tile;       // powers of G
  float* Km = G2 + tile;      // K, then xa
  float* R1 = Km + tile;
  float* R2 = R1 + tile;
  float* X = R2 + tile;
  float* T1 = X + tile;       // lw during the set-up, then scratch
  float* T2 = T1 + tile;      // ld during the set-up, then scratch
  float* e_l = smem + kTiles * tile;

  // set-up: load the cell, ld = -exp(w)
  for (int idx = tid; idx < L * kN; idx += kThreads) {
    const int t = idx >> 6, n = idx & (kN - 1);
    const long long g = base + t * stride_t + n;
    const int s = t * kLd + n;
    Rh[s] = r[g];
    Ah[s] = a[g];
    Bs[s] = b[g];
    Ks[s] = k[g];
    V[s] = v[g];
    T2[s] = -expf(w[g]);
  }
  __syncthreads();
  // lw = inclusive prefix sum of ld down each column
  if (tid < kN) {
    float acc = 0.f;
    for (int t = 0; t < L; ++t) {
      acc += T2[t * kLd + tid];
      T1[t * kLd + tid] = acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < L * kN; idx += kThreads) {
    const int t = idx >> 6, n = idx & (kN - 1);
    const int s = t * kLd + n;
    const float lw = T1[s];
    Ah[s] *= expf(lw - T2[s]);
    Bs[s] *= expf(-lw);
    Ks[s] *= expf(-lw);
    Rh[s] *= expf(lw);
    if (t == L - 1) e_l[n] = expf(lw);
  }
  __syncthreads();

  // the four masked scores; X = I + G
  matmul(Ah, kLd, 1, Bs, 1, kLd, L, L, kN, [&](int i, int j, float c) {
    const float g = j < i ? c : 0.f;
    G2[i * kLd + j] = g;
    X[i * kLd + j] = (i == j ? 1.f : 0.f) + g;
  });
  matmul(Ah, kLd, 1, Ks, 1, kLd, L, L, kN, [&](int i, int j, float c) {
    Km[i * kLd + j] = j < i ? c : 0.f;
  });
  matmul(Rh, kLd, 1, Bs, 1, kLd, L, L, kN, [&](int i, int j, float c) {
    R1[i * kLd + j] = j <= i ? c : 0.f;
  });
  matmul(Rh, kLd, 1, Ks, 1, kLd, L, L, kN, [&](int i, int j, float c) {
    R2[i * kLd + j] = j <= i ? c : 0.f;
  });
  __syncthreads();

  // X = (I - G)^-1: G2 <- G2 G2, X <- X + G2 X
  float *g2 = G2, *x = X, *s1 = T1, *s2 = T2;
  for (int d = 0; d < n_doub; ++d) {
    matmul(g2, kLd, 1, g2, kLd, 1, L, L, L,
           [&](int i, int j, float c) { s1[i * kLd + j] = c; });
    __syncthreads();
    matmul(s1, kLd, 1, x, kLd, 1, L, L, L, [&](int i, int j, float c) {
      s2[i * kLd + j] = x[i * kLd + j] + c;
    });
    __syncthreads();
    float* t = g2;
    g2 = s1;
    s1 = t;
    t = x;
    x = s2;
    s2 = t;
  }
  // free now: g2, s1, s2 (three of G2, X, T1, T2; x holds X)
  float* KV = s1;
  float* Hl = s2;
  matmul(Km, kLd, 1, V, kLd, 1, L, kN, L,
         [&](int i, int j, float c) { KV[i * kLd + j] = c; });
  __syncthreads();
  float* XA = Km;             // K is spent once K v is formed
  matmul(x, kLd, 1, KV, kLd, 1, L, kN, L,
         [&](int i, int j, float c) { Hl[i * kLd + j] = c; });
  matmul(x, kLd, 1, Ah, kLd, 1, L, kN, L,
         [&](int i, int j, float c) { XA[i * kLd + j] = c; });
  // b~ = b* e_L, k~ = k* e_L (b* and k* have no other reader left)
  for (int idx = tid; idx < L * kN; idx += kThreads) {
    const int t = idx >> 6, n = idx & (kN - 1);
    Bs[t * kLd + n] *= e_l[n];
    Ks[t * kLd + n] *= e_l[n];
  }
  __syncthreads();

  // the four results straight to device memory. y_loc = R1 h + R2 v and
  // s_loc = h^T b~ + v^T k~ sum each product on its own and then add them,
  // as the plain version adds two einsum results: the first product is
  // stored and the same thread adds the second to it (both calls give a
  // thread the same outputs, so no barrier is needed between them)
  matmul(R1, kLd, 1, Hl, kLd, 1, L, kN, L,
         [&](int i, int j, float c) { y_loc[base + i * stride_t + j] = c; });
  matmul(R2, kLd, 1, V, kLd, 1, L, kN, L,
         [&](int i, int j, float c) { y_loc[base + i * stride_t + j] += c; });
  matmul(R1, kLd, 1, XA, kLd, 1, L, kN, L, [&](int i, int j, float c) {
    rho[base + i * stride_t + j] = Rh[i * kLd + j] + c;
  });
  matmul(XA, 1, kLd, Bs, kLd, 1, kN, kN, L, [&](int i, int j, float c) {
    P[sum_base + i * kN + j] = c + (i == j ? e_l[j] : 0.f);
  });
  matmul(Hl, 1, kLd, Bs, kLd, 1, kN, kN, L,
         [&](int i, int j, float c) { s_loc[sum_base + i * kN + j] = c; });
  matmul(V, 1, kLd, Ks, kLd, 1, kN, kN, L,
         [&](int i, int j, float c) { s_loc[sum_base + i * kN + j] += c; });
}

}  // namespace

// r, w, k, v, a, b, y_loc, rho: [B, T, H, 64] f32; s_loc, P: [B*T/L, H, 64,
// 64] f32; all contiguous. L is a power of two in [4, 64] dividing T.
// Launches on `stream` of card `device` and returns cudaGetLastError() (or
// the error of the set-up call that failed).
extern "C" int wkv7_wy(const float* r, const float* w, const float* k,
                       const float* v, const float* a, const float* b,
                       float* y_loc, float* rho, float* s_loc, float* P,
                       int batch, int T, int H, int L, int device,
                       void* stream) {
  if (L < 4 || L > kN || (L & (L - 1)) || T % L)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = static_cast<int>((kTiles * L * kLd + kN) * sizeof(float));
  err = cudaFuncSetAttribute(wkv7_wy_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // doublings covering every power of G below L: (L-1).bit_length() - 1
  int n_doub = 0;
  while ((2 << n_doub) < L) ++n_doub;
  const dim3 grid(batch * (T / L) * H), block(kThreads);
  wkv7_wy_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      r, w, k, v, a, b, y_loc, rho, s_loc, P, H, L, n_doub);
  return static_cast<int>(cudaGetLastError());
}
