// tile_core.cuh: the register-tile factorization core for n <= 128, shared
// by K1 (csrc/mh_rounds.cu, one candidate per block of a cluster), K5 and
// K6 (csrc/chol_smallk.cu, one Gram per block), K7 (csrc/chol_smallk.cu,
// one candidate per block of a cluster), K8 (csrc/gram_chol.cu, one lane
// per block) and K3 and K4 beyond n = 32 (csrc/chol_lanes.cu, one Gram per
// block), and the launches they and K5's and K6's panel core
// (n > 128) share.
//
// The core factors the AUGMENTED matrix [M | y | 1] of one n x n symmetric
// matrix M: its forward solve of [y, 1] is the same downdate on columns n
// and n + 1, ry[i] -= L_j[i] (ry[j] dinv) being M[i][n] -= L_j[i] L_j[n].
// Thread t holds one TQ x TQ tile of the augmented upper triangle in
// registers: row tile a (rows TQ a ..) by column tile b >= a (columns
// TQ b ..), t counting the tiles row tile by row tile (`tile_of`). Pivot j
// reads d_j = M[j][j] and the scaled row L_j[c] = M[j][c] dinv with
// dinv = rsqrt(d_j) (j <= c <= n + 1; K3 and K4 take M[j][c] / sqrt(d_j)
// instead, the pivot policy `P`), and every entry downdates
// M[i][c] -= L_j[i] L_j[c] once per pivot, in ascending j. The scaled rows
// go to shared memory, row j holding columns TQ floor(j / TQ) .. TQ ntc - 1
// (ntc column tiles), so that each tile's TQ columns are one aligned
// vector load. There is no block barrier per pivot: the tiles that publish
// row j arrive on an mbarrier of that row, and a tile waits only for the
// rows it applies. logdet and the quadratics are summed afterwards by one
// thread in pivot order (`tile_quadratics`).
//
// Where a tile's entries come from is the template parameter `Src`, a
// functor with entry(r, c) (r <= c < n, jitter on the diagonal included)
// and diag(r): `SeMixSource` builds the SE-mixture correlation from x
// (K1, K6, K7), `ScaledSeMixSource` the covariance scale R + shift J from
// it (K8), `GramSource` reads a materialized Gram's lower triangle (K5,
// K3, K4).
//
// Arithmetic: explicitly rounded intrinsics in the order of the plain
// PyTorch twin (`_factor_plain` in ops/chol_smallk.py, or in
// ops/chol_lanes.py for `SqrtPivot`), as in csrc/chol_core.cuh.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

#include "chol_core.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int TILE = 128;            // the register-tile core: n <= TILE
constexpr int MAX_CLUSTER = 8;       // portable cluster size
constexpr int MAX_KB = MAX_K / MAX_CLUSTER;   // candidates per block

// mbarriers in shared memory (CTA scope), by their shared-window address:
// an arrival releases the arriving thread's earlier stores, a completed
// wait acquires them.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// The cluster barrier in two halves: an arrival releases the thread's
// earlier stores (shared memory read by other blocks included), a
// completed wait acquires every block's. Each thread arrives once per
// phase before it waits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

constexpr int TQ = 4;

__host__ __device__ inline int col_tiles(int n) {
  return (n + 2 + TQ - 1) / TQ;
}

__host__ __device__ inline int row_tiles(int n) { return (n + TQ - 1) / TQ; }

// tiles of the augmented upper triangle: row tile a has ntc - a of them
__host__ __device__ inline int reg_tiles(int n) {
  const int ntr = row_tiles(n), ntc = col_tiles(n);
  return ntr * ntc - ntr * (ntr - 1) / 2;
}

// offset of row j's first stored column, TQ floor(j / TQ), in the rows of
// one matrix; aug_row_off(n, .) is their size (a multiple of TQ)
__host__ __device__ inline int aug_row_off(int j, int n) {
  const int ncp = TQ * col_tiles(n), m = j / TQ, t = j % TQ;
  return j * ncp - TQ * (TQ * (m * (m - 1) / 2) + t * m);
}

// (j, c) of one matrix's scaled rows L, c >= TQ floor(j / TQ)
template <typename T>
__device__ __forceinline__ T* aug_at(T* L, int j, int c, int n) {
  return L + aug_row_off(j, n) + (c - TQ * (j / TQ));
}

// TQ consecutive values from an aligned address in shared memory
__device__ __forceinline__ void load_tq(const float* p, float (&v)[TQ]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load_tq(const double* p, double (&v)[TQ]) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}

// TQ consecutive values from an aligned address in global memory, read
// through L2 only (another SM wrote them in this launch: an L1 line would
// be stale)
__device__ __forceinline__ void load_tq_l2(const float* p, float (&v)[TQ]) {
  const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load_tq_l2(const double* p,
                                           double (&v)[TQ]) {
  const double2 q0 = __ldcg(reinterpret_cast<const double2*>(p));
  const double2 q1 = __ldcg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}

__device__ __forceinline__ void store_tq(float* p, const float (&v)[TQ]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_tq(double* p, const double (&v)[TQ]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// This thread's tile (ta, tb) of the augmented upper triangle, or ta = -1
// for a thread beyond reg_tiles(n).
__device__ __forceinline__ void tile_of(int tid, int n, int& ta, int& tb) {
  ta = -1;
  tb = 0;
  if (tid >= reg_tiles(n)) return;
  const int ntc = col_tiles(n);
  int first = 0;   // the tiles of the row tiles before ta
  for (ta = 0; first + ntc - ta <= tid; ++ta) first += ntc - ta;
  tb = ta + tid - first;
}

// The block size of a cluster kernel on the register-tile core (K1, K7),
// measured on K1 at the bench shape (PERF.md section 6): f32 1024
// threads; f64 512 where the tiles fit (at 1024 a thread has 64 registers,
// fewer than an f64 tile needs). 512 threads hold the tiles of n <= 122,
// 1024 those of n <= TILE (560).
template <typename T>
inline int reg_threads(int tiles) {
  return sizeof(T) == 4 || tiles > 512 ? 1024 : 512;
}

// The block size of a kernel with one matrix per block on the register-
// tile core (K5, K6, K8): the fewest threads, a power of two from 32, that
// hold the tiles (one warp at n = 8 and at n = 14).
inline int tile_block(int tiles) {
  int nt = 32;
  while (nt < tiles) nt *= 2;
  return nt;
}

// bar[j] completes when every tile of row j has published its part; call
// once before the first factorization, then sync the block.
__device__ __forceinline__ void init_row_bars(uint64_t* bar, int n, int nt) {
  for (int j = threadIdx.x; j < n; j += nt)
    mbar_init(smem_addr(&bar[j]), col_tiles(n) - j / TQ);
}

// The SE-mixture correlation built from x (K1, K6, K7):
//   (w1 exp(-sum_a r1_a dx_a^2) + w2 exp(-sum_a r2_a dx_a^2)) / wsum
//   (+ jitter on the diagonal).
template <typename T>
struct SeMixSource {
  const T* __restrict__ x;
  const T* r1;
  const T* r2;
  T w1, w2, wsum, jitter;
  int d;

  __device__ __forceinline__ T entry(int r, int c) const {
    T v = se_mix_corr<T>(x, r, c, d, r1, r2, w1, w2, wsum);
    if (c == r && jitter != T(0)) v = Ar<T>::add(v, jitter);
    return v;
  }
  __device__ __forceinline__ T diag(int r) const { return entry(r, r); }
};

// The covariance scale R + shift J (+ jitter on the diagonal) of the
// SE-mixture correlation R (K8): each entry scaled and shifted before the
// jitter, as the plain twin (`fused_mix_quadratics_plain` in
// ops/gram_chol.py) does.
template <typename T>
struct ScaledSeMixSource {
  const T* __restrict__ x;
  const T* r1;
  const T* r2;
  T w1, w2, wsum, scale, shift, jitter;
  int d;

  __device__ __forceinline__ T entry(int r, int c) const {
    using A = Ar<T>;
    T v = se_mix_corr<T>(x, r, c, d, r1, r2, w1, w2, wsum);
    v = A::add(A::mul(scale, v), shift);
    if (c == r && jitter != T(0)) v = A::add(v, jitter);
    return v;
  }
  __device__ __forceinline__ T diag(int r) const { return entry(r, r); }
};

// A materialized Gram g (n x n) of which only the lower triangle is read:
// M[r][c] = g[c][r] for c >= r, plus jitter on the diagonal (K5).
template <typename T>
struct GramSource {
  const T* __restrict__ g;
  int n;
  T jitter;

  __device__ __forceinline__ T entry(int r, int c) const {
    T v = g[(size_t)c * n + r];
    if (c == r && jitter != T(0)) v = Ar<T>::add(v, jitter);
    return v;
  }
  __device__ __forceinline__ T diag(int r) const { return entry(r, r); }
};

// How pivot j turns d_j, row j's downdated diagonal, into the factor f
// that scales row j and the pivot it leaves in D[j], from which the kernel
// takes the log terms lg that `tile_quadratics` sums. Two orders of
// arithmetic, which round differently:
//   RsqrtPivot (K1, K5-K8; the twins of ops/chol_smallk.py and
//     ops/gram_chol.py): f = rsqrt(d_j), L_j[c] = M[j][c] f, D[j] = d_j,
//     lg = log D[j];
//   SqrtPivot (K3, K4; the twin `_factor_plain` of ops/chol_lanes.py):
//     f = sqrt(d_j), L_j[c] = M[j][c] / f, D[j] = f (the factor's
//     diagonal), lg = 2 log D[j].
struct RsqrtPivot {
  template <typename T>
  static __device__ __forceinline__ T factor(T dj) { return Ar<T>::rsqrt_(dj); }
  template <typename T>
  static __device__ __forceinline__ T scale(T m, T f) { return Ar<T>::mul(m, f); }
  template <typename T>
  static __device__ __forceinline__ T pivot(T dj, T) { return dj; }
};

struct SqrtPivot {
  template <typename T>
  static __device__ __forceinline__ T factor(T dj) { return Ar<T>::sqrt_(dj); }
  template <typename T>
  static __device__ __forceinline__ T scale(T m, T f) { return Ar<T>::div(m, f); }
  template <typename T>
  static __device__ __forceinline__ T pivot(T, T f) { return f; }
};

// Pivot j's step, by each tile that holds part of row j (downdated by
// every earlier pivot): `row` its TQ columns TQ b .., dj the diagonal d_j
// (every tile of the row keeps it). The scaled entries
// L_j[c] = P::scale(M[j][c], P::factor(d_j)) (j <= c <= n + 1) into the
// rows; the diagonal tile stores P::pivot in D[j]; then the thread arrives
// on `bar`, which completes when every tile of row j has (ntc - floor(j /
// TQ) arrivals) and so releases the row to the block.
template <typename T, typename P = RsqrtPivot>
__device__ __forceinline__ void publish_pivot(T* L, T* D, unsigned bar,
                                              int j, int b, bool diag, int n,
                                              const T (&row)[TQ], T dj) {
  const T f = P::factor(dj);
  T* Lj = aug_at(L, j, TQ * b, n);
#pragma unroll
  for (int p = 0; p < TQ; ++p) {
    const int c = TQ * b + p;
    if (c >= j && c <= n + 1) Lj[p] = P::scale(row[p], f);
  }
  if (diag) D[j] = P::pivot(dj, f);
  mbar_arrive(bar);
}

// The register-tile core (n <= TILE): one matrix's augmented rows built
// from `src` and y into the tiles' registers and factored there (see the
// header). Leaves the scaled rows at L (aug_row_off(n, n) values) and the
// pivots at D (`P::pivot`, d_j for RsqrtPivot). Every thread of the block
// calls it once what `src`
// reads is visible; the threads without a tile (ta = -1) only meet the
// block barrier at its end.
//
// A tile waits on bar[j] (phase `parity`) only before it applies pivot j,
// so it runs ahead as far as the rows it needs allow; it stops after the
// pivot below its last row. Each row is written once per factorization,
// and the block barrier at the end keeps the next factorization from
// writing a row that is still being read.
//
// A tile updates all of its entries without a test: an entry left of the
// diagonal (c < r), of a finished row (r <= j) or beyond n + 1 takes junk
// that no one reads (a row is published from its columns r..n+1 before it
// is finished, and L_j is read at columns up to n + 1 only).
template <typename T, typename P = RsqrtPivot, typename Src>
__device__ __forceinline__ void factor_tiles(T* L, T* D, unsigned bar0,
                                             unsigned parity, int ta, int tb,
                                             const Src& src,
                                             const T* __restrict__ y, int n) {
  using A = Ar<T>;
  if (ta >= 0) {
    T m[TQ][TQ];   // m[q][p] = M[TQ ta + q][TQ tb + p]
    // every tile keeps its rows' diagonals, downdated as the diagonal
    // tile's entries are (li li, li == L_j[r] bit for bit)
    T dg[TQ];
#pragma unroll
    for (int q = 0; q < TQ; ++q) {
      const int r = TQ * ta + q;
#pragma unroll
      for (int p = 0; p < TQ; ++p) {
        const int c = TQ * tb + p;
        T v = T(0);
        if (r < n && c >= r && c < n) {
          v = src.entry(r, c);
        } else if (r < n && c == n) {
          v = y[r];
        } else if (r < n && c == n + 1) {
          v = T(1);
        }
        m[q][p] = v;
      }
      dg[q] = r < n ? src.diag(r) : T(0);
    }
    const bool diag = ta == tb;
    if (ta == 0)
      publish_pivot<T, P>(L, D, bar0, 0, tb, diag, n, m[0], dg[0]);
    // the tile applies the pivots below its last row
    const int last = min(TQ * ta + TQ - 1, n - 1);
    for (int j = 0; j < last; ++j) {
      mbar_wait(bar0 + 8 * j, parity);
      T li[TQ], lc[TQ];
      load_tq(aug_at(L, j, TQ * ta, n), li);
      load_tq(aug_at(L, j, TQ * tb, n), lc);
#pragma unroll
      for (int q = 0; q < TQ; ++q) {
#pragma unroll
        for (int p = 0; p < TQ; ++p)
          m[q][p] = A::sub(m[q][p], A::mul(li[q], lc[p]));
        dg[q] = A::sub(dg[q], A::mul(li[q], li[q]));
      }
#pragma unroll
      for (int q = 0; q < TQ; ++q)
        if (TQ * ta + q == j + 1)
          publish_pivot<T, P>(L, D, bar0 + 8 * (j + 1), j + 1, tb, diag,
                              n, m[q], dg[q]);
    }
  }
  __syncthreads();
}

// logdet and the quadratics of one factored matrix, summed in pivot order
// from the log terms (`lg`, n values: log d_j, or 2 log d_j for
// `SqrtPivot`) and L^-1 y, L^-1 1 (columns n and n + 1 of the scaled rows
// L). One thread calls it.
template <typename T>
__device__ __forceinline__ void tile_quadratics(T* L, const T* lg, int n,
                                                T& ld, T& qyy, T& qoy,
                                                T& qoo) {
  using A = Ar<T>;
  ld = qyy = qoy = qoo = T(0);
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const T* Lr = aug_at(L, j, n, n);
    const T wy = Lr[0], wo = Lr[1];
    ld = A::add(ld, lg[j]);
    qyy = A::add(qyy, A::mul(wy, wy));
    qoy = A::add(qoy, A::mul(wy, wo));
    qoo = A::add(qoo, A::mul(wo, wo));
  }
}

// A plain launch of `kern` as `grid` blocks of `threads` threads with `smem`
// bytes of dynamic shared memory (opted in above 48 KB); returns the first
// error.
template <typename Args>
cudaError_t launch_plain(void (*kern)(Args), const Args& a, int grid,
                         int threads, size_t smem, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, s>>>(a);
  return cudaSuccess;
}

// f(std::integral_constant<int, NTB>) for the block size `threads`
// (`tile_block`: 32, 64, .., 1024), so that a launch can pick the kernel
// instantiated for its block size.
template <typename F>
cudaError_t with_tile_block(int threads, F&& f) {
  switch (threads) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    case 512: return f(std::integral_constant<int, 512>{});
    default: return f(std::integral_constant<int, 1024>{});
  }
}

// Launch `kern` as `clusters` thread-block clusters of C blocks of
// `threads` threads with `smem` bytes of dynamic shared memory, after
// checking that the card can place such a cluster (C > 8 is a
// non-portable size). Returns the first error; the caller clears it, so
// a refused launch, which never ran, leaves no error behind.
template <typename Args>
cudaError_t launch_cluster(void (*kern)(Args), const Args& a, int C,
                           int clusters, int threads, size_t smem,
                           cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (C > MAX_CLUSTER) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * clusters, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kern, &cfg);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorLaunchOutOfResources;
  return cudaLaunchKernelEx(&cfg, kern, a);
}

// The error of a launch made with launch_cluster (or any launch whose
// refusal was returned), cleared, else the launch's own error.
inline int launch_result(cudaError_t err) {
  if (err != cudaSuccess) {
    cudaGetLastError();   // a refused launch never ran: clear its error
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace
