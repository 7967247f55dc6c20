// chol_nll: a batch of B Cholesky factorizations, each followed by a
// separate forward substitution of [y, 1]. Out: logdet, y'R^-1 y, 1'R^-1 y,
// 1'R^-1 1 per matrix.
//
// Replaces the Pallas kernel `_chol_nll_pallas`
// (ccgp_tpu/ops/pallas_chol.py:186) in its default body,
// `_chol_nll_kernel_blocked` (:107-183): per matrix, L = chol(G + jitter I)
// by LEFT-looking 8-column panels, then W = L^-1 [y, 1] by the same panels,
// then logdet = 2 sum log L_jj and the three quadratics sum W_y^2,
// sum W_y W_o, sum W_o^2.
//
// The TPU kernel pads every matrix to 128 with an identity block and
// unrolls the 16 panels at trace time. Here one thread block owns one
// matrix, with no padding (the identity block adds 0 to every output), the
// lower triangle of G (+ jitter) in shared memory, column-major with a
// leading dimension of n rounded up to 16 bytes, so that a panel's 8
// entries of one column come in 16-byte loads (a warp walking down a
// column hits 32 banks).
// Panel k holds columns r0..r0+nb-1 (nb = 8, fewer in the last); its "top
// block" is rows r0..r0+nb-1 of those columns. Every entry (i, c) of a
// panel, i >= c, gets the plain version's operations in its order:
//   A  v = G[i][c] - (sum over c' < r0 of L[i][c'] L[c][c'], accumulated in
//      c' order from 0): the downdate by the finished columns;
//   C  v -= L[i][p] L[c][p] for p = r0 .. c-1 in turn, then L[c][c] =
//      sqrt(v) on the diagonal, L[i][c] = v / L[c][c] below it.
// The plain version (`chol_nll_plain` in ops/chol_nll.py) runs C column by
// column over the whole panel: at pivot p every later entry of the panel
// subtracts its product L[i][p] L[c][p]. Entry (i, c) sees the same
// subtractions, in p order, if row i is walked on its own, column by column
// (the row recursion below); what it needs is row i's own earlier entries
// and the top block's L[c][p] and L[c][c]. So the top block is factored
// first, by one warp, and then every row below it finishes its nb entries
// on its own, with no barrier between pivots. A's sums are serial chains in
// c' order, so a chain can be started early, on the columns already final,
// and finished later: the same adds in the same order. One barrier per
// panel: step k runs, side by side,
//   warp 0: the chain of pivots. A and C of panel k on the next panel's
//           top rows, then A of the next top block (its columns < r0 + nb
//           are all final now) and its factorization, a row per lane with
//           the pivots passed by __shfl_sync (B): the next step's top block
//           is ready at the barrier. Both A's start from warp 1's partial
//           sums over c' < r0 - nb, so warp 0 adds only the last 8 and 16
//           columns' terms;
//   warp 1: those partial sums for step k + 1 (over c' < r0, final now),
//           four chains a lane, into the half of a double buffer that step
//           k + 1 reads;
//   warp 2: the forward substitution of panel k (its rows of L are final:
//           columns < r0 from earlier steps, the top block from the last
//           step): 2 x nb lanes downdate [y, 1] by W's finished rows, each
//           sum kept in c order, then one lane per right-hand side runs the
//           in-panel recursion; then four lanes each add the panel's rows
//           to one of the four running sums, in row order (2 log L_jj,
//           W_y^2, W_y W_o, W_o^2), the logs taken beside the chain;
//   warps 3..: A and C of panel k on every row below the next top rows,
//           TR threads per row (the dot products of A, nb / TR per
//           thread, several entries for the ILP of independent chains),
//           then the row's nb values shuffled to all TR threads, which
//           each run its C and keep their own nb / TR entries.
// Every dot product issues the loads of 4 columns ahead of their adds.
// The lower triangle is loaded in one pass over the matrix, UNR loads in
// flight per thread before the stores (the upper triangle never read: an
// entry above the diagonal changes no output).
//
// A non-PD matrix takes the square root of a negative pivot: NaN, which
// flows into that matrix's outputs only. No clamp, no error.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 67 TFLOP/s f32, 34
// TFLOP/s f64 outside the tensor cores): at the MAP cloud's shape (B = 128,
// n = 100, f32) the lower triangles are 2.6 MB, ~0.77 us, and the
// n^3 / 3 + 2 n^2 operations 45 MFLOP, ~0.68 us. The kernel is far from
// both: its floor is warp 0's chain, per panel the 8 row recursions of
// the next top rows (8 dependent divisions), the last terms of the next
// top block's sums and its 8 pivots (a square root, a division and two
// shuffle round trips each).
//
// Arithmetic: every add, multiply, divide and square root is an explicitly
// rounded intrinsic (no contracted multiply-add; csrc/chol_core.cuh's
// `Ar`), in the order of the plain version; log is the CUDA math library's,
// as PyTorch's elementwise kernel uses. A zero dividend is not divided
// (`div_pivot`: the same quotient without the division's slow path).

#include <type_traits>

#include "chol_core.cuh"

namespace {

// The block size (a build for the sweep sets it). `chip_smoke.k9_block_sizes`
// on one H100 80GB HBM3 at 700 W, device ms at 256 / 512 / 1024 threads:
//   MAP cloud, B = 128, n = 100, f32:  0.0362 / 0.0416 / 0.0555
//   B = 128, n = 128, f64:             0.0702 / 0.0909 / 0.1214
// The smallest block wins at both shapes: 256.
#ifndef CCGP_K9_THREADS
#define CCGP_K9_THREADS 256
#endif
constexpr int NLL_THREADS = CCGP_K9_THREADS;
static_assert(NLL_THREADS == 256 || NLL_THREADS == 512 ||
                  NLL_THREADS == 1024, "a block of 256, 512 or 1024");
constexpr int PANEL = 8;    // the TPU kernel's nb
constexpr int MAX_N = 128;  // the TPU tile
constexpr int UNR = 16;     // loads in flight per thread
constexpr unsigned FULL = 0xffffffffu;
// threads per row below the next top rows (warps 3..): more in a larger
// block, so that a pass covers the rows at n = 128
constexpr int TR = NLL_THREADS >= 1024 ? 8 : NLL_THREADS >= 512 ? 4 : 2;
constexpr int ROWS_PER_PASS = (NLL_THREADS - 96) / TR;

// G consecutive entries of one column of L, r0 + G-aligned, in 16-, 8- or
// 4-byte loads (a column starts 16-byte aligned: ld is a multiple of
// 16 / sizeof(T))
template <typename T, int G>
__device__ __forceinline__ void col_load(const T* p, T* out) {
  if constexpr (sizeof(T) * G >= 16) {
    using V = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int k = 0; k < G / PER; ++k) {
      const V v = reinterpret_cast<const V*>(p)[k];
      if constexpr (PER == 4) {
        out[4 * k] = v.x;
        out[4 * k + 1] = v.y;
        out[4 * k + 2] = v.z;
        out[4 * k + 3] = v.w;
      } else {
        out[2 * k] = v.x;
        out[2 * k + 1] = v.y;
      }
    }
  } else if constexpr (sizeof(T) == 4 && G == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
#pragma unroll
    for (int k = 0; k < G; ++k) out[k] = p[k];
  }
}

template <typename T>
struct Panels {
  T* Lc;    // L[i][c] at Lc[c * ld + i], i >= c
  T* W;     // W[i][s] at W[2 i + s]: s = 0 y, 1 ones
  T* pre;   // 2 x PRE: the helper's partial sums, by the parity of the step
  int n, ld;
  __device__ T& L(int i, int c) const { return Lc[c * ld + i]; }
};

// leading dimension: n rounded up to 16 bytes' worth of elements
__host__ __device__ inline int lead(int n, size_t elem) {
  const int per = (int)(16 / elem);
  return (n + per - 1) / per * per;
}

// the partial sums for one step of warp 0, each an 8 x 8 block by (row,
// column) of the panel: X, then Y (its lower triangle used)
constexpr int PRE_X = PANEL * PANEL;
constexpr int PRE = 2 * PRE_X;

// Steps A and C of the full panel at r0 on row i, TR2 threads to the row
// (the lanes g = 0..TR2-1 of an aligned group of the warp; every lane of
// the warp calls it, `live` false for a lane without a row): lane g
// computes the downdates of columns r0 + g G2 .. r0 + g G2 + G2 - 1, each
// sum started from `pre` (the row's partial sums over c < c0, row-major by
// panel column; zeros where null) and run over c0 .. r0-1, the group
// shares them, and each lane runs the row recursion and keeps its own.
// Only full panels reach it: a panel with rows below its top block has a
// panel after it.
template <typename T, int TR2>
__device__ __forceinline__ void row_panel(const Panels<T>& P, int i, bool live,
                                          int r0, int c0, const T* pre) {
  using A = Ar<T>;
  constexpr int G2 = PANEL / TR2;
  const int lane = threadIdx.x & 31;
  const int g = lane % TR2;
  const int base = lane - g;
  T own[G2];
#pragma unroll
  for (int q = 0; q < G2; ++q) own[q] = live ? P.L(i, r0 + g * G2 + q) : T(0);
  if (r0) {
    T acc[G2];
#pragma unroll
    for (int q = 0; q < G2; ++q) acc[q] = pre ? pre[g * G2 + q] : T(0);
#pragma unroll 4
    for (int c = c0; c < r0; ++c) {
      const T li = live ? P.L(i, c) : T(0);
      T lc[G2];
      col_load<T, G2>(&P.L(r0 + g * G2, c), lc);
#pragma unroll
      for (int q = 0; q < G2; ++q)
        acc[q] = A::add(acc[q], A::mul(li, lc[q]));
    }
#pragma unroll
    for (int q = 0; q < G2; ++q) own[q] = A::sub(own[q], acc[q]);
  }
  T v[PANEL];
#pragma unroll
  for (int s = 0; s < TR2; ++s)
#pragma unroll
    for (int q = 0; q < G2; ++q)
      v[s * G2 + q] = __shfl_sync(FULL, own[q], base + s);
  // the row recursion: entry c minus L[i][p] L[c][p] for p < c in turn,
  // then over the pivot L[c][c] (the top block's, read by every lane)
#pragma unroll
  for (int c = 0; c < PANEL; ++c) {
    T x = v[c];
#pragma unroll
    for (int p = 0; p < c; ++p)
      x = A::sub(x, A::mul(v[p], P.L(r0 + c, r0 + p)));
    v[c] = div_pivot(x, P.L(r0 + c, r0 + c));
  }
  // each lane keeps its own G2 entries (selected, not indexed by g, so
  // that v stays in registers)
#pragma unroll
  for (int q = 0; q < G2; ++q) {
    T mine = v[q];
#pragma unroll
    for (int s = 1; s < TR2; ++s) mine = g == s ? v[s * G2 + q] : mine;
    if (live) P.L(i, r0 + g * G2 + q) = mine;
  }
}

// acc[j] += L[r][c] L[s + j][c] for j < 2 and c = c0 .. c1-1 in turn:
// one row against two consecutive rows, two chains each in c order
template <typename T>
__device__ __forceinline__ void row_dots(const Panels<T>& P, int r, int s,
                                         int c0, int c1, T* acc) {
  using A = Ar<T>;
#pragma unroll 4
  for (int c = c0; c < c1; ++c) {
    const T lr = P.L(r, c);
    T ls[2];
    col_load<T, 2>(&P.L(s, c), ls);
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[j] = A::add(acc[j], A::mul(lr, ls[j]));
  }
}

// Step A of the top block at r1 (nb1 rows): its lower entries minus their
// dot products with the finished columns, each sum started from the
// helper's partial sum over c < c0 (`pre`, 8 x 8 by row and column) and
// run over c0 .. r1-1. Lane (a, g) = (lane / 4, lane % 4) takes row a's
// columns 2 g and 2 g + 1.
template <typename T>
__device__ __forceinline__ void top_downdate(const Panels<T>& P, int r1,
                                             int nb1, int c0, const T* pre) {
  using A = Ar<T>;
  const int lane = threadIdx.x & 31;
  const int a = min(lane >> 2, nb1 - 1), b = 2 * (lane & 3);
  T acc[2] = {pre[a * PANEL + b], pre[a * PANEL + b + 1]};
  row_dots(P, r1 + a, r1 + b, c0, r1, acc);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if ((lane >> 2) < nb1 && b + j <= a)
      P.L(r1 + a, r1 + b + j) = A::sub(P.L(r1 + a, r1 + b + j), acc[j]);
}

// The helper's partial sums for the next step's warp 0 (rows r2 .. r2 +
// nb2 - 1, the top rows after next): X, their entries in the columns r1 ..
// r1 + 7 of the next panel, and Y, their own lower triangle, each summed
// over c < r0 (all final now). Lane (a, g) takes row a's columns 2 g and
// 2 g + 1 of both.
template <typename T>
__device__ __forceinline__ void helper_sums(const Panels<T>& P, int r0,
                                            int r1, int r2, int nb2,
                                            T* out) {
  const int lane = threadIdx.x & 31;
  const int a = min(lane >> 2, nb2 - 1), b = 2 * (lane & 3);
  T acc[4] = {T(0), T(0), T(0), T(0)};
  using A = Ar<T>;
#pragma unroll 4
  for (int c = 0; c < r0; ++c) {
    const T lr = P.L(r2 + a, c);
    T lx[2], ly[2];
    col_load<T, 2>(&P.L(r1 + b, c), lx);
    col_load<T, 2>(&P.L(r2 + b, c), ly);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc[j] = A::add(acc[j], A::mul(lr, lx[j]));
      acc[2 + j] = A::add(acc[2 + j], A::mul(lr, ly[j]));
    }
  }
  if ((lane >> 2) < nb2)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      out[a * PANEL + b + j] = acc[j];
      out[PRE_X + a * PANEL + b + j] = acc[2 + j];
    }
}

// Step C of the top block at r1 (nb1 rows): lane j holds row r1 + j in
// registers; pivot p's square root comes from lane p, each lane below it
// divides, and the entries (j, c), p < c <= j, subtract L[j][p] L[c][p]
// with L[c][p] shuffled from lane c. Straight-line code, the lanes' own
// parts kept by selects.
template <typename T>
__device__ __forceinline__ void top_block(const Panels<T>& P, int r1,
                                          int nb1) {
  using A = Ar<T>;
  const int j = threadIdx.x & 31;
  // a block of fewer than 8 rows (the last) is padded with rows of the
  // identity, which no step of a real row reads: every pivot runs
  T v[PANEL];
#pragma unroll
  for (int c = 0; c < PANEL; ++c)
    v[c] = j < nb1 && c <= j ? P.L(r1 + j, r1 + c) : T(c == j ? 1 : 0);
#pragma unroll
  for (int p = 0; p < PANEL; ++p) {
    const T d = A::sqrt_(__shfl_sync(FULL, v[p], p));
    const T q = div_pivot(j > p ? v[p] : d, d);
    v[p] = j > p ? q : j == p ? d : v[p];
#pragma unroll
    for (int c = p + 1; c < PANEL; ++c) {
      const T lc = __shfl_sync(FULL, v[p], c);
      const T x = A::sub(v[c], A::mul(v[p], lc));
      v[c] = j >= c ? x : v[c];
    }
  }
#pragma unroll
  for (int c = 0; c < PANEL; ++c)
    if (j < nb1 && c <= j) P.L(r1 + j, r1 + c) = v[c];
}

// Lanes s < 4 add rows r .. r + nb - 1 of W and L to their running sum, in
// row order: s = 0 log L_jj, 1 W_y^2, 2 W_y W_o, 3 W_o^2 (every lane takes
// the log, so no branch splits the warp).
template <typename T>
__device__ __forceinline__ void running_sums(const Panels<T>& P, int r,
                                             int nb, T& sum) {
  using A = Ar<T>;
  const int lane = threadIdx.x & 31;
  if (lane >= 4) return;
#pragma unroll 1
  for (int jj = 0; jj < PANEL; ++jj) {
    const int p = min(r + jj, P.n - 1);
    const T wy = P.W[2 * p], wo = P.W[2 * p + 1];
    const T a = lane == 3 ? wo : wy, b = lane == 1 ? wy : wo;
    const T lg = A::log_(P.L(p, p));
    const T x = A::add(sum, lane == 0 ? lg : A::mul(a, b));
    sum = jj < nb ? x : sum;
  }
}

// A build for `chip_smoke.k9_clock_split` (-DCCGP_K9_CLOCKS) records, in
// block 0, clock64 spans: the load, the first top block, the steps' whole
// span, and the busy cycles of each part of warps 0, 1, 2 and the first row
// warp, summed over the steps (K9_LAP: up to 3 parts a warp);
// `ccgp_k9_clocks` copies them out.
#ifdef CCGP_K9_CLOCKS
constexpr int K9_SLOTS = 3 + 4 * 3;
__device__ long long k9_clocks[K9_SLOTS];
#define K9_CLOCK(x) long long x = clock64()
#define K9_LAP(slot)                       \
  {                                        \
    const long long k9_now = clock64();    \
    k9_busy[slot] += k9_now - k9_lap;      \
    k9_lap = k9_now;                       \
  }
#else
#define K9_CLOCK(x)
#define K9_LAP(slot)
#endif

template <typename T>
__global__ void __launch_bounds__(NLL_THREADS)
chol_nll_kernel(const T* __restrict__ grams, const T* __restrict__ y,
                T* __restrict__ q, int n, T jitter, bool add_j) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = Ar<T>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  K9_CLOCK(t_start);
  Panels<T> P;
  P.n = n;
  P.ld = lead(n, sizeof(T));
  P.Lc = (T*)smem_raw;
  P.W = P.Lc + (size_t)n * P.ld;
  P.pre = P.W + 2 * n;

  // the lower triangle in one pass over the matrix (contiguous reads), UNR
  // loads in flight before their stores; with a jitter (add_j), + jitter
  // on the diagonal and + jitter * 0 off it, as the plain version adds
  // jitter * I
  const T* g = grams + (size_t)blockIdx.x * n * n;
  const T zero_j = A::mul(jitter, T(0));
  {
    // (i, c) of element e stepped along by NLL_THREADS, not divided out
    const int di = NLL_THREADS / n, dc = NLL_THREADS % n;
    int i = tid / n, c = tid % n;
    while (i < n) {
      T val[UNR];
      int ii[UNR], cc[UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        ii[u] = i;
        cc[u] = c;
        val[u] = i < n && c <= i ? g[i * n + c] : T(0);
        c += dc;
        i += di;
        if (c >= n) {
          c -= n;
          ++i;
        }
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const T v = val[u];
        const T vj = A::add(v, cc[u] == ii[u] ? jitter : zero_j);
        if (ii[u] < n && cc[u] <= ii[u]) P.L(ii[u], cc[u]) = add_j ? vj : v;
      }
    }
  }
  if (tid < PRE) P.pre[tid] = T(0);   // step 0's (it sums over no column)
  static_assert(PRE <= NLL_THREADS, "one zero a thread");
  __syncthreads();
  K9_CLOCK(t_loaded);
  if (warp == 0) top_block(P, 0, min(PANEL, n));
  __syncthreads();
  K9_CLOCK(t_steps);
#ifdef CCGP_K9_CLOCKS
  long long k9_busy[3] = {0, 0, 0};
#endif

  T sum = T(0);   // warp 2, lane s < 4: 2 log L_jj, W_y^2, W_y W_o, W_o^2
  for (int r0 = 0, k = 0; r0 < n; r0 += PANEL, ++k) {
    const int nb = min(PANEL, n - r0);
    const int r1 = r0 + nb;
    const int nb1 = min(PANEL, n - r1);   // <= 0 after the last panel
    const int r2 = r1 + max(nb1, 0);
    const int nb2 = min(PANEL, n - r2);
    // warp 0 sums from the helper's partials over c < r0 - PANEL
    const int c0 = max(r0 - PANEL, 0);
    K9_CLOCK(k9_lap);
    if (warp == 0) {
      if (nb1 > 0) {
        const T* pre = P.pre + (k & 1) * PRE;
        row_panel<T, 4>(P, r1 + (lane >> 2), (lane >> 2) < nb1, r0, c0,
                        pre + (lane >> 2) * PANEL);
        __syncwarp();
        K9_LAP(0);
        top_downdate(P, r1, nb1, c0, pre + PRE_X);
        __syncwarp();
        K9_LAP(1);
        top_block(P, r1, nb1);
        K9_LAP(2);
      }
    } else if (warp == 1) {
      if (nb2 > 0) helper_sums(P, r0, r1, r2, nb2, P.pre + ((k + 1) & 1) * PRE);
      K9_LAP(0);
    } else if (warp == 2) {
      // W's rows of panel k: [y, 1] minus L[p][c] W[c] over c < r0 (one
      // lane per (p, s)), then the in-panel recursion (one lane per s)
      if (lane < 2 * nb) {
        const int p = r0 + (lane >> 1), s = lane & 1;
        T b = s ? T(1) : y[p];
        if (r0) {
          T acc = T(0);
#pragma unroll 4
          for (int c = 0; c < r0; ++c)
            acc = A::add(acc, A::mul(P.L(p, c), P.W[2 * c + s]));
          b = A::sub(b, acc);
        }
        P.W[2 * p + s] = b;
      }
      __syncwarp();
      K9_LAP(0);
      if (lane < 2) {
        // the in-panel recursion, panel rows of L and [y, 1] in registers
        // (a last panel of fewer rows padded with rows of the identity)
        const int s = lane;
        T w[PANEL], l[PANEL][PANEL];
#pragma unroll
        for (int jj = 0; jj < PANEL; ++jj) {
          w[jj] = jj < nb ? P.W[2 * (r0 + jj) + s] : T(0);
#pragma unroll
          for (int c = 0; c <= jj; ++c)
            l[jj][c] = jj < nb ? P.L(r0 + jj, r0 + c) : T(c == jj ? 1 : 0);
        }
#pragma unroll
        for (int jj = 0; jj < PANEL; ++jj) {
          T acc = T(0);
#pragma unroll
          for (int c = 0; c < jj; ++c)
            acc = A::add(acc, A::mul(l[jj][c], w[c]));
          w[jj] = A::div(A::sub(w[jj], acc), l[jj][jj]);
          if (jj < nb) P.W[2 * (r0 + jj) + s] = w[jj];
        }
      }
      __syncwarp();
      K9_LAP(1);
      running_sums(P, r0, nb, sum);
      K9_LAP(2);
    } else {
      // every row below the next top rows
      const int t = tid - 96;
      for (int i0 = r2; i0 < n; i0 += ROWS_PER_PASS) {
        const int i = i0 + t / TR;
        row_panel<T, TR>(P, min(i, n - 1), i < n, r0, 0, nullptr);
      }
      K9_LAP(0);
    }
    __syncthreads();
  }
#ifdef CCGP_K9_CLOCKS
  if (blockIdx.x == 0) {
    if (tid == 0) {
      k9_clocks[0] = t_loaded - t_start;
      k9_clocks[1] = t_steps - t_loaded;
      k9_clocks[2] = clock64() - t_steps;
    }
    if (lane == 0 && warp < 4)
      for (int j = 0; j < 3; ++j) k9_clocks[3 + 3 * warp + j] = k9_busy[j];
  }
#endif
  if (warp == 2 && lane < 4)
    q[(size_t)blockIdx.x * 4 + lane] = lane == 0 ? A::mul(T(2), sum) : sum;
}

// L (n x lead(n), column-major), W (n x 2) and the helper's partial sums
size_t smem_bytes(int n, size_t elem) {
  return ((size_t)n * lead(n, elem) + (size_t)2 * n + 2 * PRE) * elem;
}

template <typename T>
int launch(const void* grams, const void* y, void* q, int B, int n,
           double jitter, void* stream) {
  if (B < 1 || n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(n, sizeof(T));
  // above 48 KB the block must opt in; a refusal is returned and cleared
  cudaError_t err = cudaFuncSetAttribute(
      chol_nll_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  chol_nll_kernel<T><<<B, NLL_THREADS, bytes, (cudaStream_t)stream>>>(
      (const T*)grams, (const T*)y, (T*)q, n, (T)jitter, jitter != 0.0);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef CCGP_K9_CLOCKS
extern "C" int ccgp_k9_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k9_clocks, sizeof(k9_clocks));
}
#endif

extern "C" int ccgp_chol_nll_f32(const void* grams, const void* y, void* q,
                                 int B, int n, double jitter, void* stream) {
  return launch<float>(grams, y, q, B, n, jitter, stream);
}

extern "C" int ccgp_chol_nll_f64(const void* grams, const void* y, void* q,
                                 int B, int n, double jitter, void* stream) {
  return launch<double>(grams, y, q, B, n, jitter, stream);
}
