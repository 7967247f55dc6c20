// chol_smallk: the small-K latency kernels K5, K6 and K7. Each factors K
// (<= 16) n x n matrices, each with the forward solve of [y, 1] fused in
// and logdet and the quadratics qyy = y'R^-1 y, qoy = 1'R^-1 y,
// qoo = 1'R^-1 1 accumulated in pivot order, and differs in where the
// matrices come from and what it writes:
//
//   K5 chol_quad   (replaces `chol_quadratics_smallk`,
//                   ccgp_tpu/ops/pallas_chol_smallk.py:850): materialized
//                   Grams (K, n, n), of which only the lower triangle is
//                   read, plus jitter on the diagonal -> {logdet, qyy,
//                   qoy, qoo} per matrix;
//   K6 mix_quad    (replaces `fused_mix_quadratics_smallk`, :960): the
//                   SE-mixture Gram built in the kernel from x (n, d), the
//                   rates r1, r2 (K, d) and the weights p (K,),
//                     R = (p^2 exp(-sum_a r1_a dx_a^2)
//                          + (1-p)^2 exp(-sum_a r2_a dx_a^2))
//                         / (p^2 + (1-p)^2)  (+ jitter on the diagonal)
//                   -> the same quadratics;
//   K7 mh_round    (replaces `fused_mix_mh_round`, :1104): K6, then each
//                   candidate's log-posterior from the passed extra
//                   (log-Jacobian + log-prior) and log_scale,
//                     val = -0.5 (n log 2pi + logdet + n log_scale
//                                 + quad e^-log_scale) + extra,
//                   and the first-acceptance scan (val_k - lp_val) >
//                   log_u[k] -> z_new (dim,), [val_new, beta_new],
//                   [any_acc, consumed]. With no acceptance z_new is 0,
//                   val_new = lp_val, beta_new = lp_beta, consumed = K.
//
// Failure dataflow: a negative pivot gives NaN quadratics on that member
// only (K5, K6); in K7 a NaN log-posterior compares false and so rejects.
// Nothing raises.
//
// What bounds them on the card: latency, not FLOPs or bytes (n sequential
// pivots per matrix; at the 1-D models' shape, n = 8, K = 4, a few hundred
// operations). So the designs spread the matrices over SMs and shorten the
// pivot step. Which kernel runs which core (`layout`, the one place it is
// decided; the wrapper reads it through `ccgp_smallk_layout`). K5 and K6
// differ only in where an entry comes from, so they share one layout and
// two kernels templated on the source (`GramSource` for K5, `SeMixSource`
// for K6; the demangled names tell them apart):
//   - K5 and K6, n <= 128: `chol_quad_tiles_kernel`, a grid of K
//     independent blocks, block k on matrix k with the register-tile core
//     of csrc/tile_core.cuh (`factor_tiles`, one 4 x 4 tile of [M | y | 1]
//     per thread, an mbarrier per row instead of a block barrier per
//     pivot). The block has the fewest threads, a power of two from 32,
//     that hold the tiles (`tile_block`): one warp at n = 8 (5 tiles). K6's
//     block first stages its candidate's rates and weights in shared
//     memory.
//   - K5 and K6, 128 < n <= 1024: `chol_quad_panel_kernel`, a grid of K
//     clusters of C blocks (16, or 8 for K > 8 so that the clusters fit the
//     card's 132 SMs at once), cluster k on matrix k: a
//     panel-blocked right-looking factorization over the cluster's shared
//     memory. The augmented upper triangle [M | y | 1] is split across the
//     C blocks in panels of b rows (b = 8, or 4 where 8 does not fit),
//     dealt out in snake order (0..C-1, C-1..0, ...) so that the blocks
//     hold about as much (C and b from the sweep
//     `chip_smoke.k5_panel_sizes`); each block builds its own rows from the
//     source. The panel's owner factors its b pivots alone (one thread the
//     b x b diagonal block, then a thread per column) and
//     writes the b scaled rows to its shared memory and to an exchange
//     buffer in global memory (L2), both double-buffered by panel parity;
//     the cluster meets at ONE barrier per panel, split into arrive and
//     wait so that the next panel's owner factors it before it finishes
//     its other rows; every other block copies the rows from the exchange
//     (through L2: out of the owner's shared memory every copy would pass
//     one SM's port) and downdates its own trailing rows in 4 x 4 register
//     tiles with the b pivots in ascending j. Rank 0 gathers the pivots
//     through distributed shared memory. At n = 1024 in f64 the triangle
//     (4.2 MB) does not fit 16 blocks' shared memory: the rows live in the
//     global (L2-resident) workspace too, a slice per block, and the rest
//     is the same.
//   - K7, n <= 128: `mh_round_cluster_kernel`, one round of K1's cluster
//     (csrc/mh_rounds.cu): C = min(K, 8) blocks, candidate k on block
//     k mod C, `factor_tiles` on `SeMixSource` from the passed r1, r2 and
//     p; each block publishes (val, beta) of its candidates, the cluster
//     meets at one barrier, and rank 0 reads the K pairs through
//     distributed shared memory and runs the scan.
//   - K7 at 128 < n <= 256: `smallk_kernel`, ONE block for all K matrices
//     on `factor_quadratics` of csrc/chol_core.cuh (packed triangles, one
//     block barrier per pivot), its workspace in shared memory when it
//     fits, else in the wrapper's global workspace.
//
// Arithmetic: explicitly rounded intrinsics in the order of the plain
// PyTorch twins in ops/chol_smallk.py (see csrc/chol_core.cuh): every
// entry receives M[i][c] = M[i][c] - L_j[i] L_j[c] once per pivot j, in
// ascending j, with L_j[c] = M[j][c] rsqrt(d_j), and logdet and the
// quadratics are summed in pivot order by one thread.

#include "tile_core.cuh"

namespace {

template <typename T>
struct SmallkArgs {
  const T* grams;       // K5: (K, n, n)
  const T* x;           // K6, K7: (n, d)
  const T* y;           // (n,)
  const T* r1;          // K6, K7: (K, d)
  const T* r2;          // K6, K7: (K, d)
  const T* p;           // K6, K7: (K,)
  const T* extra;       // K7: (K,)
  const T* log_scale;   // K7: (K,)
  const T* cands;       // K7: (K, dim)
  const T* st;          // K7: [lp_val, lp_beta]
  const T* log_u;       // K7: (K,)
  T* q;                 // K5, K6: (K, 4) logdet, qyy, qoy, qoo
  T* z_out;             // K7: (dim,)
  T* vb_out;            // K7: [val_new, beta_new]
  int* info;            // K7: [any_acc, consumed]
  T* ws;                // global workspace (`layout`)
  int n, d, dim, K;
  T jitter;
  T n_log2pi;
  int b;                // K5 panel core: rows per panel
  long long rows_max;   // K5 panel core: elements of a block's rows
};

// ---------------------------------------------------------------------------
// the layout: which core, how many blocks, how much memory
// ---------------------------------------------------------------------------

enum Which { K5_QUAD = 0, K6_MIX = 1, K7_ROUND = 2 };
enum Core { CORE_TILES = 0, CORE_PANEL_SMEM, CORE_PANEL_GLOBAL,
            CORE_ROUND_CLUSTER, CORE_BLOCK };

constexpr int PANEL_MAX_LT = 256;   // a block's row tiles in the panel core
// The panel core's cluster: 16 blocks (non-portable) when the K clusters
// fit the card's 132 SMs at one block each, else 8
constexpr int PANEL_C = 16;
constexpr int PANEL_C_MANY = 8;
constexpr int PANEL_K_MANY = 8;     // K above which PANEL_C_MANY is taken
constexpr size_t PANEL_STATIC = 2048;   // the panel kernel's static arrays

// Panel P's block in snake order (0..C-1, C-1..0, ...), and the panel of a
// block's r-th local panel.
__host__ __device__ inline int panel_owner(int P, int C) {
  const int r = P / C, pos = P - r * C;
  return (r & 1) ? C - 1 - pos : pos;
}

__host__ __device__ inline int local_panel(int r, int C, int rank) {
  return r * C + ((r & 1) ? C - 1 - rank : rank);
}

// Global row tile of a block's local row tile lt (tb row tiles a panel).
__host__ __device__ inline int local_tile_row(int lt, int tb, int C,
                                              int rank) {
  return local_panel(lt / tb, C, rank) * tb + lt % tb;
}

// Elements of a block's rows before its local row tile lt: each row tile a
// holds TQ rows of TQ (ntc - a) columns (TQ a .. TQ ntc - 1).
__host__ __device__ inline long long local_tile_off(int lt, int tb, int C,
                                                    int rank, int ntc) {
  const long long r = lt / tb, t = lt % tb;
  // sum of the block's panels before its r-th, in closed form
  const long long sum_p = (long long)C * r * (r - 1) / 2 +
                          ((r + 1) / 2) * rank + (r / 2) * (C - 1 - rank);
  const long long full = r * tb * ntc - (long long)tb * tb * sum_p -
                         r * tb * (tb - 1) / 2;
  const long long pr = local_panel((int)r, C, rank);
  const long long part = t * ntc - t * pr * tb - t * (t - 1) / 2;
  return (long long)TQ * TQ * (full + part);
}

// A block's existing local row tiles (the last panel may be short).
__host__ __device__ inline int local_tiles(int n, int b, int C, int rank) {
  const int tb = b / TQ, ntr = row_tiles(n), np = (n + b - 1) / b;
  int cnt = 0;
  for (int r = 0; local_panel(r, C, rank) < np; ++r) {
    const int a0 = local_panel(r, C, rank) * tb;
    cnt += ntr - a0 < tb ? ntr - a0 : tb;
  }
  return cnt;
}

struct Layout {
  int core;
  int C;            // blocks per cluster (1: no cluster)
  int grid;         // blocks in all
  int threads;
  int b;            // panel core: rows per panel
  long long rows_max;   // panel core: elements of the largest block's rows
  size_t smem;      // dynamic shared memory per block, bytes
  size_t ws_elems;  // global workspace the wrapper allocates (0: none)
};

// The panel core's block size: 1024 threads in f32, 512 in f64 (at 1024 a
// thread has 64 registers, fewer than an f64 4 x 4 tile and its pivots'
// rows take).
template <typename T>
constexpr int panel_threads() {
  return sizeof(T) == 4 ? 1024 : 512;
}

// The panel core's layout for a given C and b: the largest block's rows,
// and the shared memory a block takes (rows when they are in it, the two
// panel buffers of b rows of TQ ntc columns, and (d_j, L_j[n], L_j[n+1])
// of each of the block's rows).
inline void panel_sizes(int n, int C, int b, int elem, bool rows_in_smem,
                        long long& rows_max, size_t& smem) {
  const int tb = b / TQ, ntc = col_tiles(n);
  rows_max = 0;
  int lrows = 0;
  for (int rank = 0; rank < C; ++rank) {
    const int nlt = local_tiles(n, b, C, rank);
    const long long e = local_tile_off(nlt, tb, C, rank, ntc);
    rows_max = e > rows_max ? e : rows_max;
    lrows = TQ * nlt > lrows ? TQ * nlt : lrows;
  }
  smem = (size_t)((rows_in_smem ? rows_max : 0) + 2LL * b * TQ * ntc +
                  3LL * lrows) * elem;
}

// K6's staged rates and weights in a tiles block's shared memory: r1 and
// r2 (MAX_D each), w1 = p^2, w2 = (1 - p)^2 and w1 + w2
constexpr int MIX_STAGE = 2 * MAX_D + 3;

inline Layout layout(int which, int n, int K, int elem) {
  Layout l = {};
  const bool quad = which == K5_QUAD || which == K6_MIX;
  if (quad && n <= TILE) {
    l.core = CORE_TILES;
    l.C = 1;
    l.grid = K;
    l.threads = tile_block(reg_tiles(n));
    l.smem = (size_t)(aug_row_off(n, n) + n +
                      (which == K6_MIX ? MIX_STAGE : 0)) * elem;
  } else if (quad) {
#ifdef CCGP_K5_PANEL_C
    // a sweep's own build (chip_smoke.k5_panel_sizes)
    l.C = CCGP_K5_PANEL_C;
    const int widths[] = {CCGP_K5_PANEL_B};
#else
    l.C = K > PANEL_K_MANY ? PANEL_C_MANY : PANEL_C;
    const int widths[] = {8, 4};
#endif
    l.grid = K * l.C;
    l.threads = elem == 4 ? panel_threads<float>() : panel_threads<double>();
    l.core = CORE_PANEL_GLOBAL;
    l.b = widths[0];
    for (int b : widths) {
      long long rows;
      size_t smem;
      panel_sizes(n, l.C, b, elem, true, rows, smem);
      if (smem + PANEL_STATIC <= SMEM_PER_BLOCK) {
        l.core = CORE_PANEL_SMEM;
        l.b = b;
        break;
      }
    }
    panel_sizes(n, l.C, l.b, elem, l.core == CORE_PANEL_SMEM, l.rows_max,
                l.smem);
    // the panel exchange (two buffers of b rows per cluster), behind the
    // rows when they are in it
    l.ws_elems = (size_t)K * 2 * l.b * TQ * col_tiles(n) +
                 (l.core == CORE_PANEL_GLOBAL ? (size_t)l.grid * l.rows_max
                                              : 0);
  } else if (which == K7_ROUND && n <= TILE) {
    l.core = CORE_ROUND_CLUSTER;
    l.C = K < MAX_CLUSTER ? K : MAX_CLUSTER;
    l.grid = l.C;
    const int kbm = (K + l.C - 1) / l.C;
    l.threads = elem == 4 ? reg_threads<float>(reg_tiles(n))
                          : reg_threads<double>(reg_tiles(n));
    l.smem = (size_t)kbm * (aug_row_off(n, n) + n) * elem;
  } else {
    // the workspace goes to shared memory when it fits beside the static
    // arrays (`launch_smem_or_global`), else to this global one
    l.core = CORE_BLOCK;
    l.C = 1;
    l.grid = 1;
    l.threads = NT;
    l.ws_elems = workspace_elems(n, K);
    l.smem = l.ws_elems * elem;
  }
  return l;
}

// ---------------------------------------------------------------------------
// where matrix k's entries come from (K5: Gram k; K6: candidate k's SE
// mixture built from x)
// ---------------------------------------------------------------------------

// SmallkSource<Src>: stage(a, k, st) puts what the source keeps in shared
// memory at st (the room `layout` gives it: none for K5, MIX_STAGE values
// for K6; every thread of the block calls it, and the block syncs before
// the source is read); of(a, k, st) is the source, from what stage left at
// st, or, with st null, from the arguments in global memory. The panel
// core takes the latter: K6's rates would not fit beside its static arrays
// (PANEL_STATIC) without changing the layout K5 and K6 share, and each of
// its entries is built once.
template <typename Src>
struct SmallkSource;

template <typename T>
struct SmallkSource<GramSource<T>> {
  __device__ static void stage(const SmallkArgs<T>&, int, T*) {}
  __device__ static GramSource<T> of(const SmallkArgs<T>& a, int k,
                                     const T*) {
    return GramSource<T>{a.grams + (size_t)k * a.n * a.n, a.n, a.jitter};
  }
};

template <typename T>
struct SmallkSource<SeMixSource<T>> {
  // w1 = p^2, w2 = (1 - p)^2 and w1 + w2, as K7 and the twin compute them
  __device__ static void weights(T pk, T* w) {
    using A = Ar<T>;
    const T qk = A::sub(T(1), pk);
    w[0] = A::mul(pk, pk);
    w[1] = A::mul(qk, qk);
    w[2] = A::add(w[0], w[1]);
  }
  __device__ static void stage(const SmallkArgs<T>& a, int k, T* st) {
    for (int c = threadIdx.x; c < a.d; c += blockDim.x) {
      st[c] = a.r1[(size_t)k * a.d + c];
      st[MAX_D + c] = a.r2[(size_t)k * a.d + c];
    }
    if (threadIdx.x == 0) weights(a.p[k], st + 2 * MAX_D);
  }
  __device__ static SeMixSource<T> of(const SmallkArgs<T>& a, int k,
                                      const T* st) {
    if (st != nullptr) {
      const T* w = st + 2 * MAX_D;
      return SeMixSource<T>{a.x,  st,   st + MAX_D, w[0],
                            w[1], w[2], a.jitter,   a.d};
    }
    T w[3];
    weights(a.p[k], w);
    return SeMixSource<T>{a.x,  a.r1 + (size_t)k * a.d,
                          a.r2 + (size_t)k * a.d,
                          w[0], w[1], w[2], a.jitter, a.d};
  }
};

// ---------------------------------------------------------------------------
// K5 and K6, n <= 128: a block per matrix on the register-tile core
// ---------------------------------------------------------------------------

template <typename T, int NTB, typename Src>
__global__ void __launch_bounds__(NTB)
    chol_quad_tiles_kernel(const SmallkArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = Ar<T>;
  using S = SmallkSource<Src>;
  __shared__ __align__(8) uint64_t s_bar[TILE];
  const int n = a.n, k = blockIdx.x, tid = threadIdx.x;
  // the scaled rows, the pivots, then what the source stages
  T* const L = (T*)smem_raw;
  T* const D = L + aug_row_off(n, n);
  T* const st = D + n;
  int ta, tb;
  tile_of(tid, n, ta, tb);
  init_row_bars(s_bar, n, NTB);
  S::stage(a, k, st);
  __syncthreads();
  const Src src = S::of(a, k, st);
  factor_tiles<T>(L, D, smem_addr(s_bar), 0, ta, tb, src, a.y, n);
  for (int j = tid; j < n; j += NTB) D[j] = A::log_(D[j]);
  __syncthreads();
  if (tid == 0) {
    T* o = a.q + (size_t)k * 4;
    tile_quadratics<T>(L, D, n, o[0], o[1], o[2], o[3]);
  }
}

// ---------------------------------------------------------------------------
// K5 and K6, 128 < n <= 1024: a cluster per matrix, panels over its shared
// memory
// ---------------------------------------------------------------------------

constexpr int PANEL_MAX_B = 8;   // rows per panel, at most

// The panel core's view of one block: its rows of [M | y | 1] (row tile by
// row tile, `s_off`), the two panel buffers and its pivots' (d_j, L_j[n],
// L_j[n + 1]).
template <typename T>
struct PanelBlock {
  T* rows;
  const int* off;   // elements before each local row tile
  int n, b, tb, ntc, W, C, rank;

  // (i, c) of this block's rows, i in its local row tile lt
  __device__ __forceinline__ T* at(int lt, int i, int c) const {
    const int ra = i / TQ;
    return rows + off[lt] + (i - TQ * ra) * TQ * (ntc - ra) + (c - TQ * ra);
  }

  // The trailing update of local row tiles [lt0, lt1) with the b pivots of
  // the panel whose scaled rows are in Lp (columns TQ ta .. W - 1): a thread
  // per 4 x 4 tile (row tile ta, column tile cb >= ta), the pivots in
  // ascending j. Every thread of the block calls it.
  __device__ void trailing(const T* Lp, int lt0, int lt1, int nt) const {
    using A = Ar<T>;
    int lt = lt0, base = 0;
    for (int e = threadIdx.x;; e += nt) {
      int ta = 0;
      while (lt < lt1) {
        ta = local_tile_row(lt, tb, C, rank);
        if (e < base + ntc - ta) break;
        base += ntc - ta;
        ++lt;
      }
      if (lt >= lt1) break;
      const int cb = ta + (e - base);
      T* m0 = rows + off[lt] + TQ * (cb - ta);
      const int stride = TQ * (ntc - ta);
      T m[TQ][TQ];
#pragma unroll
      for (int q = 0; q < TQ; ++q) load_tq(m0 + q * stride, m[q]);
      for (int jj = 0; jj < b; ++jj) {
        T li[TQ], lc[TQ];
        load_tq(Lp + jj * W + TQ * ta, li);
        load_tq(Lp + jj * W + TQ * cb, lc);
#pragma unroll
        for (int q = 0; q < TQ; ++q)
#pragma unroll
          for (int p = 0; p < TQ; ++p)
            m[q][p] = A::sub(m[q][p], A::mul(li[q], lc[p]));
      }
#pragma unroll
      for (int q = 0; q < TQ; ++q) store_tq(m0 + q * stride, m[q]);
    }
  }

  // Factor panel P (rows p0 .. p1 - 1, this block's local panel P / C),
  // downdated by every earlier pivot: its scaled rows L_j[c] = M[j][c]
  // rsqrt(d_j) at columns p1 .. W - 1 into Lp and the exchange X,
  // (d_j, L_j[n], L_j[n + 1]) into trip. Thread 0 factors the b x b
  // diagonal block (d_j, rsqrt and L_j[i] of the panel's rows into s_dinv,
  // s_l); then a thread per column c >= p1 applies the panel's pivots to
  // its b entries in ascending j. Every thread of the block calls it; it
  // ends with the panel's rows written by every thread, not with a
  // barrier.
  __device__ void factor_panel(int P, T* Lp, T* X, T* trip, T* s_dinv,
                               T (*s_l)[PANEL_MAX_B], int nt) const {
    using A = Ar<T>;
    const int p0 = P * b, bp = min(b, n - p0), p1 = p0 + bp;
    const int lt0 = (P / C) * tb, lr0 = (P / C) * b;
    if (threadIdx.x == 0) {
      // up-looking: row i of the diagonal block takes the pivots of the
      // rows above it in ascending j (each entry the subtractions of the
      // right-looking order, in the same order), then its own pivot
#pragma unroll
      for (int i = 0; i < PANEL_MAX_B; ++i) {
        if (i < bp) {
          T acc[PANEL_MAX_B];
#pragma unroll
          for (int c = i; c < PANEL_MAX_B; ++c)
            if (c < bp) acc[c] = *at(lt0 + i / TQ, p0 + i, p0 + c);
#pragma unroll
          for (int j = 0; j < i; ++j) {
            const T li = s_l[j][i];
#pragma unroll
            for (int c = i; c < PANEL_MAX_B; ++c)
              if (c < bp) acc[c] = A::sub(acc[c], A::mul(li, s_l[j][c]));
          }
          const T dinv = A::rsqrt_(acc[i]);
          s_dinv[i] = dinv;
          trip[3 * (lr0 + i)] = acc[i];
#pragma unroll
          for (int c = i + 1; c < PANEL_MAX_B; ++c)
            if (c < bp) s_l[i][c] = A::mul(acc[c], dinv);
        }
      }
    }
    __syncthreads();
    for (int c = p1 + threadIdx.x; c < W; c += nt) {
      T v[PANEL_MAX_B];
#pragma unroll
      for (int ii = 0; ii < PANEL_MAX_B; ++ii)
        if (ii < bp) v[ii] = *at(lt0 + ii / TQ, p0 + ii, c);
#pragma unroll
      for (int jj = 0; jj < PANEL_MAX_B; ++jj) {
        if (jj < bp) {
          const T l = A::mul(v[jj], s_dinv[jj]);
          Lp[jj * W + c] = l;
          X[jj * W + c] = l;
          if (c == n) trip[3 * (lr0 + jj) + 1] = l;
          if (c == n + 1) trip[3 * (lr0 + jj) + 2] = l;
#pragma unroll
          for (int ii = jj + 1; ii < PANEL_MAX_B; ++ii)
            if (ii < bp) v[ii] = A::sub(v[ii], A::mul(s_l[jj][ii], l));
        }
      }
    }
  }
};

template <typename T, int NTB, bool GROWS, typename Src>
__global__ void __launch_bounds__(NTB)
    chol_quad_panel_kernel(const SmallkArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = Ar<T>;
  __shared__ int s_off[PANEL_MAX_LT];
  __shared__ T s_dinv[PANEL_MAX_B];
  __shared__ T s_l[PANEL_MAX_B][PANEL_MAX_B];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int k = blockIdx.x / C;   // this cluster's matrix
  const int tid = threadIdx.x;
  const int n = a.n, b = a.b, tb = b / TQ;
  const int ntc = col_tiles(n), W = TQ * ntc;
  const int np = (n + b - 1) / b;
  const int nlt = local_tiles(n, b, C, rank);
  // this block's rows (row tile by row tile), the two panel buffers of b
  // scaled rows (W columns each) and (d_j, L_j[n], L_j[n + 1]) per row
  T* const lbuf = (T*)smem_raw + (GROWS ? 0 : a.rows_max);
  T* const trip = lbuf + 2 * b * W;
  // this cluster's two exchange buffers in the global workspace, behind
  // the rows when they are there
  T* const xbuf = a.ws + (GROWS ? (size_t)gridDim.x * a.rows_max : 0) +
                  (size_t)k * 2 * b * W;
  const PanelBlock<T> pb{GROWS ? a.ws + (size_t)blockIdx.x * a.rows_max
                               : (T*)smem_raw,
                         s_off, n, b, tb, ntc, W, C, rank};
  for (int lt = tid; lt < nlt; lt += NTB)
    s_off[lt] = (int)local_tile_off(lt, tb, C, rank, ntc);
  __syncthreads();

  // the rows of [M | y | 1] from the source: M[i][c] (c >= i, jitter on
  // the diagonal; K5 reads G[c][i] of the Gram's lower triangle, K6 builds
  // the entry from x and the rates in global memory), y and 1 in columns
  // n, n + 1; zeros left of the diagonal, beyond n + 1 and in rows past n.
  // Local rows run fastest, so a warp of K5 reads runs of b neighbours of a
  // Gram row.
  {
    const Src src = SmallkSource<Src>::of(a, k, nullptr);
    const int R = TQ * nlt;
    for (int e = tid; e < R * W; e += NTB) {
      const int c = e / R, lr = e - c * R;
      const int lt = lr / TQ;
      const int i = local_tile_row(lt, tb, C, rank) * TQ + lr % TQ;
      if (c < TQ * (i / TQ)) continue;
      T v = T(0);
      if (i < n && c >= i) {
        if (c < n) {
          v = src.entry(i, c);
        } else if (c == n) {
          v = a.y[i];
        } else if (c == n + 1) {
          v = T(1);
        }
      }
      *pb.at(lt, i, c) = v;
    }
  }
  __syncthreads();

  // Panel P is factored by its owner and released at the cluster barrier
  // of phase P; every block then takes a copy of its rows and applies them
  // to its rows below it. The owner of P + 1 looks ahead: it applies P's
  // pivots to its panel-(P + 1) rows first, factors them and arrives at
  // the barrier, and only then updates the rest of its rows.
  if (rank == panel_owner(0, C))
    pb.factor_panel(0, lbuf, xbuf, trip, s_dinv, s_l, NTB);
  cluster_arrive();
  for (int P = 0;; ++P) {
    cluster_wait();
    __syncthreads();
    if (P == np - 1) break;
    const int owner = panel_owner(P, C);
    const int p1 = (P + 1) * b;
    T* const Lp = lbuf + (P & 1) * b * W;
    if (rank != owner) {
      // this block's copy of the panel's scaled rows, columns p1 .. W - 1
      // (all a trailing row tile reads), from the exchange in L2: the
      // owner's shared memory would serve every copy through one port
      const T* src = xbuf + (P & 1) * b * W;
      const int wv = (W - p1) / TQ;
      for (int e = tid; e < b * wv; e += NTB) {
        const int jj = e / wv, c = p1 + TQ * (e - jj * wv);
        T v[TQ];
        load_tq_l2(src + jj * W + c, v);
        store_tq(Lp + jj * W + c, v);
      }
      __syncthreads();
    }
    // this block's row tiles below the panel
    const int r1 = P / C;
    const int lt_first =
        (local_panel(r1, C, rank) <= P ? r1 + 1 : r1) * tb;
    if (rank == panel_owner(P + 1, C)) {
      const int lt_next = min(lt_first + tb, nlt);
      pb.trailing(Lp, lt_first, lt_next, NTB);
      __syncthreads();
      pb.factor_panel(P + 1, lbuf + ((P + 1) & 1) * b * W,
                      xbuf + ((P + 1) & 1) * b * W, trip, s_dinv, s_l, NTB);
      cluster_arrive();
      pb.trailing(Lp, lt_next, nlt, NTB);
    } else {
      pb.trailing(Lp, lt_first, nlt, NTB);
      cluster_arrive();
    }
  }

  // rank 0 gathers (log d_j, L^-1 y, L^-1 1) of every pivot from its owner
  // and sums logdet and the quadratics in pivot order
  if (rank == 0) {
    T* const lg = lbuf;   // no block reads the panel buffers any more
    T* const wy = lg + n;
    T* const wo = wy + n;
    for (int j = tid; j < n; j += NTB) {
      const int P = j / b;
      const T* tr = cluster.map_shared_rank(trip, panel_owner(P, C)) +
                    3 * ((P / C) * b + (j - P * b));
      lg[j] = A::log_(tr[0]);
      wy[j] = tr[1];
      wo[j] = tr[2];
    }
    __syncthreads();
    if (tid == 0) {
      T ld = T(0), qyy = T(0), qoy = T(0), qoo = T(0);
      for (int j = 0; j < n; ++j) {
        ld = A::add(ld, lg[j]);
        qyy = A::add(qyy, A::mul(wy[j], wy[j]));
        qoy = A::add(qoy, A::mul(wy[j], wo[j]));
        qoo = A::add(qoo, A::mul(wo[j], wo[j]));
      }
      T* o = a.q + (size_t)k * 4;
      o[0] = ld;
      o[1] = qyy;
      o[2] = qoy;
      o[3] = qoo;
    }
  }
  // no block leaves while rank 0 may still read its pivots
  cluster.sync();
}

// ---------------------------------------------------------------------------
// K7, n <= 128: one round of K1's cluster
// ---------------------------------------------------------------------------

template <typename T, int NTB>
__global__ void __launch_bounds__(NTB)
    mh_round_cluster_kernel(const SmallkArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = Ar<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n = a.n, d = a.d, K = a.K, tid = threadIdx.x;
  const int kb = (K - rank + C - 1) / C;   // this block's candidates
  __shared__ T s_r1[MAX_KB][MAX_D];
  __shared__ T s_r2[MAX_KB][MAX_D];
  __shared__ T s_w1[MAX_KB], s_w2[MAX_KB], s_ws[MAX_KB];
  // (val, beta) of this block's candidates, read by rank 0
  __shared__ T s_pub[MAX_KB][2];
  __shared__ T s_val[MAX_K], s_beta[MAX_K];
  __shared__ int s_sel;
  __shared__ __align__(8) uint64_t s_bar[TILE];
  // kbm sets of scaled augmented rows, then kbm x n pivots
  const int naug = aug_row_off(n, n);
  const int kbm = (K + C - 1) / C;
  T* const Laug = (T*)smem_raw;
  T* const Dpiv = Laug + kbm * naug;
  int ta, tb;
  tile_of(tid, n, ta, tb);
  init_row_bars(s_bar, n, NTB);
  if (tid < kb) {
    const int k = rank + tid * C;
    for (int c = 0; c < d; ++c) {
      s_r1[tid][c] = a.r1[(size_t)k * d + c];
      s_r2[tid][c] = a.r2[(size_t)k * d + c];
    }
    const T pk = a.p[k];
    const T qk = A::sub(T(1), pk);
    s_w1[tid] = A::mul(pk, pk);
    s_w2[tid] = A::mul(qk, qk);
    s_ws[tid] = A::add(s_w1[tid], s_w2[tid]);
  }
  __syncthreads();
  for (int lk = 0; lk < kb; ++lk) {
    const SeMixSource<T> src{a.x,       s_r1[lk], s_r2[lk], s_w1[lk],
                             s_w2[lk],  s_ws[lk], a.jitter, d};
    factor_tiles<T>(Laug + lk * naug, Dpiv + lk * n, smem_addr(s_bar), lk & 1,
                    ta, tb, src, a.y, n);
  }
  for (int e = tid; e < kb * n; e += NTB) Dpiv[e] = A::log_(Dpiv[e]);
  __syncthreads();
  if (tid < kb) {
    const int k = rank + tid * C;
    T ld, qyy, qoy, qoo, beta;
    tile_quadratics<T>(Laug + tid * naug, Dpiv + tid * n, n, ld, qyy, qoy,
                       qoo);
    s_pub[tid][0] = logpost_of<T>(ld, qyy, qoy, qoo, a.extra[k],
                                  a.log_scale[k], n, a.n_log2pi, beta);
    s_pub[tid][1] = beta;
  }
  cluster.sync();
  if (rank == 0) {
    if (tid < K) {
      const T* pub = cluster.map_shared_rank(&s_pub[0][0], tid % C);
      s_val[tid] = pub[2 * (tid / C)];
      s_beta[tid] = pub[2 * (tid / C) + 1];
    }
    __syncthreads();
    if (tid == 0) {
      const T lpv = a.st[0];
      int sel = -1;
      for (int k = 0; k < K; ++k) {
        if (A::sub(s_val[k], lpv) > a.log_u[k]) {
          sel = k;
          break;
        }
      }
      a.vb_out[0] = sel >= 0 ? s_val[sel] : lpv;
      a.vb_out[1] = sel >= 0 ? s_beta[sel] : a.st[1];
      a.info[0] = sel >= 0 ? 1 : 0;
      a.info[1] = sel >= 0 ? sel + 1 : K;
      s_sel = sel;
    }
    __syncthreads();
    const int sel = s_sel;
    for (int c = tid; c < a.dim; c += NTB)
      a.z_out[c] = sel >= 0 ? a.cands[(size_t)sel * a.dim + c] : T(0);
  }
  // no block leaves while rank 0 may still read its s_pub
  cluster.sync();
}

// ---------------------------------------------------------------------------
// K7, 128 < n <= 256: one block for all K matrices
// ---------------------------------------------------------------------------

template <typename T, bool SMEM>
__global__ void __launch_bounds__(NT) smallk_kernel(const SmallkArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = Ar<T>;
  __shared__ T s_r1[MAX_K][MAX_D];
  __shared__ T s_r2[MAX_K][MAX_D];
  __shared__ T s_w1[MAX_K], s_w2[MAX_K], s_ws[MAX_K];
  __shared__ T s_ld[MAX_K], s_qyy[MAX_K], s_qoy[MAX_K], s_qoo[MAX_K];
  __shared__ T s_dinv[2 * MAX_K];
  __shared__ int s_sel;

  const int tid = threadIdx.x;
  const int n = a.n, d = a.d, K = a.K;
  const Factors<T> f(SMEM ? (T*)smem_raw : a.ws, n, K, s_ld, s_qyy, s_qoy,
                     s_qoo, s_dinv);

  if (tid < K) {
    const int k = tid;
    for (int c = 0; c < d; ++c) {
      s_r1[k][c] = a.r1[(size_t)k * d + c];
      s_r2[k][c] = a.r2[(size_t)k * d + c];
    }
    const T pk = a.p[k];
    const T qk = A::sub(T(1), pk);
    s_w1[k] = A::mul(pk, pk);
    s_w2[k] = A::mul(qk, qk);
    s_ws[k] = A::add(s_w1[k], s_w2[k]);
  }
  __syncthreads();
  build_se_mix_grams<T>(f, a.x, a.y, s_r1, s_r2, s_w1, s_w2, s_ws, n, d, K,
                        a.jitter);
  __syncthreads();

  factor_quadratics<T>(f, n, K);

  // log-posteriors and the first-acceptance scan
  if (tid == 0) {
    T val_sel = a.st[0], beta_sel = a.st[1];
    const int sel = logpost_first_acceptance<T>(
        f, a.extra, a.log_scale, a.log_u, a.st[0], n, K, a.n_log2pi, val_sel,
        beta_sel);
    a.vb_out[0] = val_sel;
    a.vb_out[1] = beta_sel;
    a.info[0] = sel >= 0 ? 1 : 0;
    a.info[1] = sel >= 0 ? sel + 1 : K;
    s_sel = sel;
  }
  __syncthreads();
  const int sel = s_sel;
  for (int c = tid; c < a.dim; c += NT)
    a.z_out[c] = sel >= 0 ? a.cands[(size_t)sel * a.dim + c] : T(0);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T, typename Src>
cudaError_t launch_tiles(const SmallkArgs<T>& a, const Layout& l,
                         cudaStream_t s) {
  return with_tile_block(l.threads, [&](auto nt) {
    constexpr int NTB = decltype(nt)::value;
    return launch_plain(chol_quad_tiles_kernel<T, NTB, Src>, a, l.grid, NTB,
                        l.smem, s);
  });
}

template <typename T, typename Src>
cudaError_t launch_panel(const SmallkArgs<T>& a, const Layout& l,
                         cudaStream_t s) {
  constexpr int PT = panel_threads<T>();
  if (a.ws == nullptr) return cudaErrorInvalidValue;
  return l.core == CORE_PANEL_SMEM
             ? launch_cluster(chol_quad_panel_kernel<T, PT, false, Src>, a,
                              l.C, a.K, PT, l.smem, s)
             : launch_cluster(chol_quad_panel_kernel<T, PT, true, Src>, a,
                              l.C, a.K, PT, l.smem, s);
}

template <typename T>
int launch(int which, SmallkArgs<T> a, double jitter, void* stream) {
  if (a.K < 1 || a.K > MAX_K || a.n < 1 || a.n > 1024)
    return (int)cudaErrorInvalidValue;
  if (which != K5_QUAD && (a.d < 1 || a.d > MAX_D))
    return (int)cudaErrorInvalidValue;
  if (which == K7_ROUND && (a.dim < 1 || a.dim > MAX_DIM))
    return (int)cudaErrorInvalidValue;
  a.jitter = (T)jitter;
  a.n_log2pi = (T)(a.n * 1.8378770664093453);   // n * log(2 pi)
  const Layout l = layout(which, a.n, a.K, (int)sizeof(T));
  a.b = l.b;
  a.rows_max = l.rows_max;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (l.core) {
    case CORE_TILES:
      err = which == K5_QUAD ? launch_tiles<T, GramSource<T>>(a, l, s)
                             : launch_tiles<T, SeMixSource<T>>(a, l, s);
      break;
    case CORE_PANEL_SMEM:
    case CORE_PANEL_GLOBAL:
      err = which == K5_QUAD ? launch_panel<T, GramSource<T>>(a, l, s)
                             : launch_panel<T, SeMixSource<T>>(a, l, s);
      break;
    case CORE_ROUND_CLUSTER:
      err = l.threads == 1024
                ? launch_cluster(mh_round_cluster_kernel<T, 1024>, a, l.C, 1,
                                 1024, l.smem, s)
                : launch_cluster(mh_round_cluster_kernel<T, 512>, a, l.C, 1,
                                 512, l.smem, s);
      break;
    default:
      return launch_smem_or_global(
          smallk_kernel<T, true>, smallk_kernel<T, false>, l.smem,
          [&](auto kern, size_t bytes) { kern<<<1, NT, bytes, s>>>(a); });
  }
  return launch_result(err);
}

template <typename T>
SmallkArgs<T> empty_args(const void* y, void* ws, int n, int K) {
  SmallkArgs<T> a = {};
  a.y = (const T*)y;
  a.ws = (T*)ws;
  a.n = n;
  a.K = K;
  return a;
}

template <typename T>
int chol_quad(const void* grams, const void* y, void* q, void* ws, int n,
              int K, double jitter, void* stream) {
  SmallkArgs<T> a = empty_args<T>(y, ws, n, K);
  a.grams = (const T*)grams;
  a.q = (T*)q;
  return launch<T>(K5_QUAD, a, jitter, stream);
}

template <typename T>
int mix_quad(const void* x, const void* y, const void* r1, const void* r2,
             const void* p, void* q, void* ws, int n, int d, int K,
             double jitter, void* stream) {
  SmallkArgs<T> a = empty_args<T>(y, ws, n, K);
  a.x = (const T*)x;
  a.r1 = (const T*)r1;
  a.r2 = (const T*)r2;
  a.p = (const T*)p;
  a.d = d;
  a.q = (T*)q;
  return launch<T>(K6_MIX, a, jitter, stream);
}

template <typename T>
int mh_round(const void* x, const void* y, const void* r1, const void* r2,
             const void* p, const void* extra, const void* log_scale,
             const void* cands, const void* st, const void* log_u,
             void* z_out, void* vb_out, void* info, void* ws, int n, int d,
             int dim, int K, double jitter, void* stream) {
  SmallkArgs<T> a = empty_args<T>(y, ws, n, K);
  a.x = (const T*)x;
  a.r1 = (const T*)r1;
  a.r2 = (const T*)r2;
  a.p = (const T*)p;
  a.extra = (const T*)extra;
  a.log_scale = (const T*)log_scale;
  a.cands = (const T*)cands;
  a.st = (const T*)st;
  a.log_u = (const T*)log_u;
  a.z_out = (T*)z_out;
  a.vb_out = (T*)vb_out;
  a.info = (int*)info;
  a.d = d;
  a.dim = dim;
  return launch<T>(K7_ROUND, a, jitter, stream);
}

}  // namespace

extern "C" int ccgp_chol_quad_smallk_f32(const void* grams, const void* y,
                                         void* q, void* ws, int n, int K,
                                         double jitter, void* stream) {
  return chol_quad<float>(grams, y, q, ws, n, K, jitter, stream);
}

extern "C" int ccgp_chol_quad_smallk_f64(const void* grams, const void* y,
                                         void* q, void* ws, int n, int K,
                                         double jitter, void* stream) {
  return chol_quad<double>(grams, y, q, ws, n, K, jitter, stream);
}

extern "C" int ccgp_mix_quad_smallk_f32(const void* x, const void* y,
                                        const void* r1, const void* r2,
                                        const void* p, void* q, void* ws,
                                        int n, int d, int K, double jitter,
                                        void* stream) {
  return mix_quad<float>(x, y, r1, r2, p, q, ws, n, d, K, jitter, stream);
}

extern "C" int ccgp_mix_quad_smallk_f64(const void* x, const void* y,
                                        const void* r1, const void* r2,
                                        const void* p, void* q, void* ws,
                                        int n, int d, int K, double jitter,
                                        void* stream) {
  return mix_quad<double>(x, y, r1, r2, p, q, ws, n, d, K, jitter, stream);
}

extern "C" int ccgp_mix_mh_round_f32(
    const void* x, const void* y, const void* r1, const void* r2,
    const void* p, const void* extra, const void* log_scale,
    const void* cands, const void* st, const void* log_u, void* z_out,
    void* vb_out, void* info, void* ws, int n, int d, int dim, int K,
    double jitter, void* stream) {
  return mh_round<float>(x, y, r1, r2, p, extra, log_scale, cands, st, log_u,
                         z_out, vb_out, info, ws, n, d, dim, K, jitter,
                         stream);
}

extern "C" int ccgp_mix_mh_round_f64(
    const void* x, const void* y, const void* r1, const void* r2,
    const void* p, const void* extra, const void* log_scale,
    const void* cands, const void* st, const void* log_u, void* z_out,
    void* vb_out, void* info, void* ws, int n, int d, int dim, int K,
    double jitter, void* stream) {
  return mh_round<double>(x, y, r1, r2, p, extra, log_scale, cands, st,
                          log_u, z_out, vb_out, info, ws, n, d, dim, K,
                          jitter, stream);
}

// The launch that `which` (0: K5, 1: K6, 2: K7) takes for (n, K) in
// elements of `elem` bytes: the blocks of a cluster (1: none), the blocks
// in all, and the elements of the global workspace the wrapper allocates
// (0: none).
extern "C" int ccgp_smallk_layout(int which, int n, int K, int elem,
                                  int* cluster, int* blocks,
                                  long long* ws_elems) {
  if (which < K5_QUAD || which > K7_ROUND || K < 1 || K > MAX_K || n < 1 ||
      n > 1024 || (elem != 4 && elem != 8))
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(which, n, K, elem);
  *cluster = l.C;
  *blocks = l.grid;
  *ws_elems = (long long)l.ws_elems;
  return 0;
}
