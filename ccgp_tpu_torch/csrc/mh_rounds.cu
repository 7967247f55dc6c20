// mh_rounds: R whole speculative Metropolis rounds of the SE-mixture
// combined-GP sampler in ONE launch of one thread-block cluster.
//
// Replaces the Pallas kernel `fused_mix_mh_rounds` (body
// `_make_mh_rounds_kernel`, ccgp_tpu/ops/pallas_chol_smallk.py:1187-1492)
// with both of its factorization cores: the single-tile
// `_chol_quad_core_shrink` (n <= 128) and the multi-tile blocked-Schur
// `_chol_quad_core_multitile` (128 < n <= 1024), over the whole dispatch
// envelope (n <= 1024, K <= 16, K * tiles^2 <= 256).
//
// Per round r, for the K candidates z + delta[r, k]:
//   1. the candidate model (unconstrained -> constrained transform,
//      log-Jacobian, priors; `CandModel`), one thread per candidate;
//   2. the SE-mixture Gram from x directly,
//        R = (p^2 exp(-sum_a r1_a dx_a^2) + (1-p)^2 exp(-sum_a r2_a dx_a^2))
//            / (p^2 + (1-p)^2)  (+ jitter on the diagonal)
//      (`se_mix_corr`), its upper triangle;
//   3. a right-looking Cholesky with the forward solve of [y, 1] fused in:
//      pivot j reads d_j = M[j][j], dinv = rsqrt(d_j), the scaled row
//      L_j[c] = M[j][c] dinv, and downdates M[i][c] -= L_j[i] L_j[c] for
//      j < i <= c and ry[i] -= L_j[i] (ry[j] dinv);
//   4. logdet and the quadratics qyy, qoy, qoo, beta = qoy / qoo and the
//      log-posterior (`logpost_of`);
//   5. the first-acceptance scan: (val_k - lp_val) > log_u[r, k]; a NaN
//      log-posterior (an indefinite candidate) compares false and so
//      rejects;
//   6. one rec row [z | beta | logpost], one info row [acc, consumed],
//      and, with the stash on, the accepted candidate's row-scaled factor
//      rows (row j: L[i][j] at column i >= j), L^-1 y and L^-1 1.
//
// What bounds it on the card: latency, not FLOPs or bytes. The chain is
// sequential across rounds and a factorization across its n pivots; at the
// bench shape (n = 100, K = 4) a pivot's downdate is at most ~5k
// multiply-subtracts per candidate. So the design spreads the candidates
// over SMs and shortens each pivot step:
//   - ONE cluster of C = min(K, 8) thread blocks per launch (8 is the
//     portable cluster size). Block `rank` carries the candidates
//     k = rank, rank + C, ... in k order: at K = 4 each of 4 SMs factors
//     one candidate, at K = 16 each of 8 SMs two. Every block keeps its own
//     copy of the chain state (z, lp_val, lp_beta) in shared memory and
//     loops over all R rounds: no per-round launch, no host round trip.
//   - Each round every block publishes (val, beta) of its candidates in its
//     shared memory, double-buffered by round parity, and the cluster meets
//     at ONE barrier (release / acquire). Then every block reads all K
//     pairs through distributed shared memory and runs the same scan in k
//     order on the same numbers, so all blocks select the same candidate
//     with no second barrier. Rank 0 writes rec and info; the block that
//     owns the selected candidate writes the stash. A block writes a parity
//     buffer again only after the next round's barrier, which every block
//     reaches after reading it; a last cluster barrier keeps every block's
//     shared memory alive until the last reads are done.
//   - n <= 128, the register-tile core (`factor_tiles` of
//     csrc/tile_core.cuh on `SeMixSource`, shared with K5 and K7): the
//     augmented matrix [R | y | 1] is built straight into registers and
//     stays there,
//     one 4 x 4 tile of its upper triangle per thread (350 tiles at
//     n = 100, 560 at 128), so the forward solve is the same downdate on
//     columns n and n + 1. A pivot step is two 16-byte loads (L_j at the
//     tile's rows and columns), 16 multiply-subtracts, and, in the tiles
//     of row j + 1, its scaling and store: no shuffle, no integer
//     division, and the trailing matrix never goes through shared memory.
//     There is no block barrier per pivot: the tiles of row j + 1 arrive
//     on an mbarrier of that row, and a tile waits only for the rows it
//     applies. logdet and the quadratics are summed after the loop by one
//     thread in pivot order. The scaled rows stay in shared memory, and
//     they are the stash rows.
//   - 128 < n <= 1024, the multi-tile core: `factor_quadratics` of
//     csrc/chol_core.cuh on the block's own candidates, with 1024 threads,
//     its workspace in shared memory when it fits beside the static arrays
//     and otherwise in the wrapper's global workspace, one slice per block.
// Block size: f32 runs 1024 threads, f64 512 where its tiles fit (at 1024
// a thread has 64 registers, fewer than an f64 tile needs); `reg_threads`,
// chosen by the sweep `chip_smoke.k1_block_sizes`, which builds this file
// once per block size with -DCCGP_K1_THREADS=<size> (PERF.md section 6).
//
// Arithmetic: every add, multiply and divide is an explicitly rounded
// intrinsic, so no multiply-add is contracted, and the operations run in
// the order of the plain PyTorch version (`fused_mix_mh_rounds_plain` and
// `_factor_plain` in ops/chol_smallk.py): L_j[i] = M[j][i] dinv,
// M[i][c] -= L_j[i] L_j[c], ry[i] -= L_j[i] (ry[j] dinv), each entry's
// subtractions in ascending j, and logdet and the quadratics summed in
// pivot order. exp / log / log1p / rsqrt are the CUDA math library's, as
// PyTorch's elementwise kernels use.

#include "tile_core.cuh"

namespace {

// must match ops/chol_smallk.py CandModel
struct CandModel {
  int anisotropic;
  int ndim;
  int tied;
  int prior_code[3];   // theta1, theta2, p
  double prior_a[3];
  double prior_b[3];
};

enum { PRIOR_NONE = 0, PRIOR_INVGAMMA, PRIOR_LOGNORMAL, PRIOR_UNIFORM01,
       PRIOR_JEFFREYS };

template <typename T>
__device__ T sigmoid(T x) {
  using A = Ar<T>;
  return A::div(T(1), A::add(T(1), A::exp_(-x)));
}

// -(max(-x, 0) + log1p(exp(-|x|)))
template <typename T>
__device__ T log_sigmoid(T x) {
  using A = Ar<T>;
  T m = -x > T(0) ? -x : T(0);
  return -A::add(m, A::log1p_(A::exp_(-fabs(x))));
}

template <typename T>
__device__ T prior_kernel(int code, double a, double b, T x) {
  using A = Ar<T>;
  switch (code) {
    case PRIOR_INVGAMMA:   // -(a+1) log x - b / x
      return A::sub(A::mul(-(T)(a + 1.0), A::log_(x)), A::div((T)b, x));
    case PRIOR_LOGNORMAL: {  // -log x - 0.5 ((log x - mu) / sigma)^2
      T lx = A::log_(x);
      T t = A::div(A::sub(lx, (T)a), (T)b);
      return A::sub(-lx, A::mul(T(0.5), A::mul(t, t)));
    }
    case PRIOR_UNIFORM01:
      return T(0);
    case PRIOR_JEFFREYS:   // -0.5 (log x + log1p(-x))
      return A::mul(T(-0.5), A::add(A::log_(x), A::log1p_(-x)));
    default:
      return T(0);
  }
}

// Candidate model for the candidate z + dl (see
// ops/chol_smallk.cand_model_plain).
template <typename T>
__device__ void cand_model(const CandModel& m, const T* z, const T* dl, T s2,
                           T* r1, T* r2, T& p, T& extra, T& log_scale) {
  using A = Ar<T>;
  const auto cz = [&](int c) { return A::add(z[c], dl[c]); };
  const int d = m.ndim;
  T th2, log_jac, theta1 = T(0);
  if (m.anisotropic) {
    T psi_sum = cz(0);
    r1[0] = A::exp_(psi_sum);
    for (int a = 1; a < d; ++a) {
      const T za = cz(a);
      r1[a] = A::exp_(za);
      psi_sum = A::add(psi_sum, za);
    }
    const T phi = cz(d), zeta = cz(d + 1);
    th2 = A::exp_(zeta);
    p = sigmoid(phi);
    log_jac = A::add(A::add(psi_sum, zeta),
                     A::add(log_sigmoid(phi), log_sigmoid(-phi)));
  } else {
    const T psi1 = cz(0), psi2 = cz(1), phi = cz(2);
    theta1 = A::exp_(psi1);
    th2 = A::exp_(psi2);
    p = sigmoid(phi);
    log_jac = A::add(A::add(psi1, psi2),
                     A::add(log_sigmoid(phi), log_sigmoid(-phi)));
    for (int a = 0; a < d; ++a) r1[a] = theta1;
  }
  const T lam1 = A::add(T(1), th2);
  for (int a = 0; a < d; ++a) r2[a] = m.tied ? A::mul(lam1, r1[a]) : th2;

  T log_prior = T(0);
  if (m.prior_code[0]) {
    T lp1;
    if (m.anisotropic) {
      lp1 = prior_kernel<T>(m.prior_code[0], m.prior_a[0], m.prior_b[0], r1[0]);
      for (int a = 1; a < d; ++a)
        lp1 = A::add(lp1, prior_kernel<T>(m.prior_code[0], m.prior_a[0],
                                          m.prior_b[0], r1[a]));
    } else {
      lp1 = prior_kernel<T>(m.prior_code[0], m.prior_a[0], m.prior_b[0], theta1);
    }
    log_prior = A::add(log_prior, lp1);
  }
  if (m.prior_code[1])
    log_prior = A::add(log_prior, prior_kernel<T>(m.prior_code[1], m.prior_a[1],
                                                  m.prior_b[1], th2));
  if (m.prior_code[2])
    log_prior = A::add(log_prior, prior_kernel<T>(m.prior_code[2], m.prior_a[2],
                                                  m.prior_b[2], p));
  extra = A::add(log_jac, log_prior);
  const T q = A::sub(T(1), p);
  const T s = A::add(A::mul(p, p), A::mul(q, q));
  log_scale = A::log_(A::mul(s, s2));
}

enum { CORE_REG = 0, CORE_SMEM, CORE_GLOBAL };

template <typename T>
struct RoundsArgs {
  const T* x;
  const T* y;
  const T* z0;
  const T* st;        // lp_val, lp_beta, sigma2
  const T* deltas;
  const T* log_u;
  T* rec;
  int* info;
  T* stash;           // null: no stash
  T* ws;              // C x workspace_elems(n, ceil(K / C)) (CORE_GLOBAL)
  CandModel model;
  int n, d, dim, R, K;
  T jitter, n_log2pi;
};

template <typename T, int NTB, int CORE>
__global__ void __launch_bounds__(NTB) mh_rounds_kernel(const RoundsArgs<T> a) {
  static_assert(CORE == CORE_REG || NTB == NT,
                "factor_quadratics runs on NT threads");
  constexpr bool REG = CORE == CORE_REG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = Ar<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n = a.n, dim = a.dim, K = a.K;
  const int kb = (K - rank + C - 1) / C;   // this block's candidates
  const int kbm = (K + C - 1) / C;         // the most a block carries
  __shared__ T s_z[MAX_DIM];
  __shared__ T s_r1[MAX_KB][MAX_D];
  __shared__ T s_r2[MAX_KB][MAX_D];
  __shared__ T s_w1[MAX_KB], s_w2[MAX_KB], s_ws[MAX_KB];
  __shared__ T s_extra[MAX_KB], s_logscale[MAX_KB];
  // factor_quadratics' accumulators and pivot rsqrt (indexed up to MAX_K)
  __shared__ T s_ld[MAX_K], s_qyy[MAX_K], s_qoy[MAX_K], s_qoo[MAX_K];
  __shared__ T s_dinv[2 * MAX_K];
  // (val, beta) of this block's candidates by round parity, read by every
  // block of the cluster
  __shared__ T s_pub[2][MAX_KB][2];
  __shared__ T s_val[MAX_K], s_beta[MAX_K];   // all K, gathered
  __shared__ T s_lpv, s_lpb;
  __shared__ int s_sel;
  // the single-tile core's row-published barriers, one per pivot
  __shared__ __align__(8) uint64_t s_bar[TILE];
  unsigned gen = 0;   // factorizations so far: the barriers' phase

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t nn = (size_t)n * (n + 1) / 2;
  // the multi-tile cores' workspace: kbm packed triangles, then RY, RO, WY,
  // WO, DINV (kbm x n each)
  const Factors<T> f(CORE == CORE_GLOBAL
                         ? a.ws + (size_t)rank * workspace_elems(n, kbm)
                         : (T*)smem_raw,
                     n, kbm, s_ld, s_qyy, s_qoy, s_qoo, s_dinv);
  // the single-tile core's: kbm sets of scaled augmented rows, then kbm x n
  // pivots, and this thread's tile (ta = -1: none)
  const int naug = aug_row_off(n, n);
  T* const Laug = (T*)smem_raw;
  T* const Dpiv = Laug + kbm * naug;
  int ta = -1, tb = 0;
  if (REG) tile_of(tid, n, ta, tb);
  const T s2 = a.st[2];

  for (int c = tid; c < dim; c += NTB) s_z[c] = a.z0[c];
  if (REG) init_row_bars(s_bar, n, NTB);
  if (tid == 0) {
    s_lpv = a.st[0];
    s_lpb = a.st[1];
  }
  __syncthreads();

  for (int r = 0; r < a.R; ++r) {
    // 1. this block's candidates and their model terms
    if (tid < kb) {
      const int k = rank + tid * C;
      const T* dl = a.deltas + ((size_t)r * K + k) * dim;
      T p, extra, ls;
      cand_model<T>(a.model, s_z, dl, s2, s_r1[tid], s_r2[tid], p, extra, ls);
      const T q = A::sub(T(1), p);
      s_w1[tid] = A::mul(p, p);
      s_w2[tid] = A::mul(q, q);
      s_ws[tid] = A::add(s_w1[tid], s_w2[tid]);
      s_extra[tid] = extra;
      s_logscale[tid] = ls;
    }
    __syncthreads();

    // 2.-3. the Grams, their factorizations and forward solves
    if constexpr (REG) {
      for (int lk = 0; lk < kb; ++lk, ++gen) {
        const SeMixSource<T> src{a.x,       s_r1[lk], s_r2[lk], s_w1[lk],
                                 s_w2[lk],  s_ws[lk], a.jitter, a.d};
        factor_tiles<T>(Laug + lk * naug, Dpiv + lk * n, smem_addr(s_bar),
                        gen & 1, ta, tb, src, a.y, n);
      }
      for (int e = tid; e < kb * n; e += NTB) Dpiv[e] = A::log_(Dpiv[e]);
      __syncthreads();
    } else {
      build_se_mix_grams<T>(f, a.x, a.y, s_r1, s_r2, s_w1, s_w2, s_ws, n,
                            a.d, kb, a.jitter);
      __syncthreads();
      factor_quadratics<T>(f, n, kb);
    }

    // 4. log-posteriors, published to the cluster
    const int par = r & 1;
    if (tid < kb) {
      T ld, qyy, qoy, qoo;
      if constexpr (REG) {
        // logdet and the quadratics in pivot order from log d_j, L^-1 y
        // and L^-1 1 (columns n and n + 1 of the augmented rows)
        tile_quadratics<T>(Laug + tid * naug, Dpiv + tid * n, n, ld, qyy, qoy,
                           qoo);
      } else {
        ld = s_ld[tid];
        qyy = s_qyy[tid];
        qoy = s_qoy[tid];
        qoo = s_qoo[tid];
      }
      T beta;
      s_pub[par][tid][0] = logpost_of<T>(ld, qyy, qoy, qoo, s_extra[tid],
                                         s_logscale[tid], n, a.n_log2pi,
                                         beta);
      s_pub[par][tid][1] = beta;
    }
    cluster.sync();

    // 5. every block gathers all K and runs the same first-acceptance scan
    if (tid < K) {
      const T* pub = cluster.map_shared_rank(&s_pub[par][0][0], tid % C);
      s_val[tid] = pub[2 * (tid / C)];
      s_beta[tid] = pub[2 * (tid / C) + 1];
    }
    __syncthreads();
    if (tid == 0) {
      int sel = -1;
      for (int k = 0; k < K; ++k) {
        if (A::sub(s_val[k], s_lpv) > a.log_u[(size_t)r * K + k]) {
          sel = k;
          break;
        }
      }
      if (sel >= 0) {
        s_lpv = s_val[sel];
        s_lpb = s_beta[sel];
      }
      s_sel = sel;
      if (rank == 0) {
        T* rr = a.rec + (size_t)r * (dim + 2);
        rr[dim] = s_lpb;
        rr[dim + 1] = s_lpv;
        a.info[2 * r] = sel >= 0 ? 1 : 0;
        a.info[2 * r + 1] = sel >= 0 ? sel + 1 : K;
      }
    }
    __syncthreads();

    // 6. the state carry, the record and the accepted candidate's factors
    const int sel = s_sel;
    if (sel >= 0) {
      const T* dl = a.deltas + ((size_t)r * K + sel) * dim;
      for (int c = tid; c < dim; c += NTB) s_z[c] = A::add(s_z[c], dl[c]);
    }
    if (rank == 0)
      for (int c = tid; c < dim; c += NTB)
        a.rec[(size_t)r * (dim + 2) + c] = s_z[c];
    if (a.stash != nullptr && sel >= 0 && sel % C == rank) {
      const int lk = sel / C;
      T* out = a.stash + (size_t)r * (n + 2) * n;
      for (int row = warp; row < n + 2; row += NTB / 32) {
        T* o = out + (size_t)row * n;
        if constexpr (REG) {
          // row j < n: L_j[c] (c >= j); rows n, n + 1: column n, n + 1 of
          // every augmented row
          T* const La = Laug + lk * naug;
          if (row < n) {
            for (int c = lane; c < n; c += 32)
              o[c] = c >= row ? *aug_at(La, row, c, n) : T(0);
          } else {
            for (int c = lane; c < n; c += 32) o[c] = *aug_at(La, c, row, n);
          }
        } else if (row < n) {
          const T* Mr = f.M + (size_t)lk * nn + rowbase(row, n);
          const T dinv = f.DINV[(size_t)lk * n + row];
          for (int c = lane; c < n; c += 32)
            o[c] = c >= row ? A::mul(Mr[c], dinv) : T(0);
        } else {
          const T* v = (row == n ? f.WY : f.WO) + (size_t)lk * n;
          for (int c = lane; c < n; c += 32) o[c] = v[c];
        }
      }
    }
    __syncthreads();
  }
  // no block leaves while another may still read its s_pub
  cluster.sync();
}

// The launch's layout, the one place it is decided: a cluster of
// C = min(K, 8) blocks, each carrying at most kbm = ceil(K / C) candidates;
// beyond one tile, a global workspace of C slices of workspace_elems(n, kbm)
// (used when the block's slice does not fit its shared memory).
struct Layout {
  int C, kbm;
  size_t ws_elems;
};

inline Layout layout(int n, int K) {
  const int C = K < MAX_CLUSTER ? K : MAX_CLUSTER;
  const int kbm = (K + C - 1) / C;
  return {C, kbm, n <= TILE ? 0 : (size_t)C * workspace_elems(n, kbm)};
}

template <typename T>
int launch(const void* x, const void* y, const void* z, const void* st,
           const void* deltas, const void* log_u, void* rec, void* info,
           void* stash, void* ws, const void* model, int n, int d, int dim,
           int R, int K, double jitter, void* stream) {
  if (K < 1 || K > MAX_K || d < 1 || d > MAX_D || dim > MAX_DIM || n < 1)
    return (int)cudaErrorInvalidValue;
  const RoundsArgs<T> a{(const T*)x, (const T*)y, (const T*)z, (const T*)st,
                        (const T*)deltas, (const T*)log_u, (T*)rec,
                        (int*)info, (T*)stash, (T*)ws,
                        *(const CandModel*)model, n, d, dim, R, K, (T)jitter,
                        (T)(n * 1.8378770664093453)};   // n log(2 pi)
  const Layout lay = layout(n, K);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (n <= TILE) {
    const size_t bytes =
        (size_t)lay.kbm * (aug_row_off(n, n) + n) * sizeof(T);
    // one thread per tile
#ifdef CCGP_K1_THREADS
    // a block-size sweep's own build (chip_smoke.k1_block_sizes)
    if (reg_tiles(n) > CCGP_K1_THREADS) return (int)cudaErrorInvalidValue;
    err = launch_cluster(mh_rounds_kernel<T, CCGP_K1_THREADS, CORE_REG>, a,
                         lay.C, 1, CCGP_K1_THREADS, bytes, s);
#else
    err = reg_threads<T>(reg_tiles(n)) == 1024
              ? launch_cluster(mh_rounds_kernel<T, 1024, CORE_REG>, a, lay.C,
                               1, 1024, bytes, s)
              : launch_cluster(mh_rounds_kernel<T, 512, CORE_REG>, a, lay.C,
                               1, 512, bytes, s);
#endif
  } else {
    const size_t bytes = workspace_elems(n, lay.kbm) * sizeof(T);
    // the workspace goes to shared memory when it fits beside the static
    // arrays
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, mh_rounds_kernel<T, NT, CORE_SMEM>);
    if (err == cudaSuccess)
      err = fa.sharedSizeBytes + bytes <= SMEM_PER_BLOCK
                ? launch_cluster(mh_rounds_kernel<T, NT, CORE_SMEM>, a,
                                 lay.C, 1, NT, bytes, s)
                : ws == nullptr
                      ? cudaErrorInvalidValue
                      : launch_cluster(mh_rounds_kernel<T, NT, CORE_GLOBAL>, a,
                                       lay.C, 1, NT, 0, s);
  }
  return launch_result(err);
}

}  // namespace

extern "C" int ccgp_mh_rounds_f32(const void* x, const void* y, const void* z,
                                  const void* st, const void* deltas,
                                  const void* log_u, void* rec, void* info,
                                  void* stash, void* ws, const void* model,
                                  int n, int d, int dim, int R, int K,
                                  double jitter, void* stream) {
  return launch<float>(x, y, z, st, deltas, log_u, rec, info, stash, ws, model,
                       n, d, dim, R, K, jitter, stream);
}

extern "C" int ccgp_mh_rounds_f64(const void* x, const void* y, const void* z,
                                  const void* st, const void* deltas,
                                  const void* log_u, void* rec, void* info,
                                  void* stash, void* ws, const void* model,
                                  int n, int d, int dim, int R, int K,
                                  double jitter, void* stream) {
  return launch<double>(x, y, z, st, deltas, log_u, rec, info, stash, ws,
                        model, n, d, dim, R, K, jitter, stream);
}

// The cluster's blocks and the elements of the global workspace (0: none)
// that a launch for (n, K) takes, for the wrapper to size `ws` with.
extern "C" int ccgp_mh_rounds_layout(int n, int K, int* blocks,
                                     long long* ws_elems) {
  if (K < 1 || K > MAX_K || n < 1) return (int)cudaErrorInvalidValue;
  const Layout lay = layout(n, K);
  *blocks = lay.C;
  *ws_elems = (long long)lay.ws_elems;
  return 0;
}
