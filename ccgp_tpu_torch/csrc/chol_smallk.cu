// chol_smallk: the small-K latency kernels K5, K6 and K7. Each factors K
// (<= 16) n x n matrices in ONE thread block with the core of
// csrc/chol_core.cuh (packed upper triangles, right-looking Cholesky with
// the forward solve of [y, 1] fused in, logdet and the quadratics
// accumulated pivot by pivot) and differs only in where the matrices come
// from and what it writes:
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
// Failure dataflow: a negative pivot gives NaN quadratics (K5, K6); in K7
// a NaN log-posterior compares false and so rejects. Nothing raises.
//
// What bounds it on the card: latency, as for K1 (csrc/mh_rounds.cu): n
// sequential pivots, each ending in a block barrier, on one SM; at the
// 1-D models' shape (n = 8, K = 4) the work is a few hundred operations
// and the launch itself dominates. The workspace (K packed triangles and
// five K x n vectors) lives in shared memory when it fits beside the
// static arrays, else in the global workspace the wrapper allocates (K5
// at n = 1024, K = 4, f64: 16.8 MB).
//
// Arithmetic: explicitly rounded intrinsics in the order of the plain
// PyTorch twins in ops/chol_smallk.py (see csrc/chol_core.cuh).

#include <stdint.h>

#include "chol_core.cuh"

namespace {

enum Mode { GRAMS = 0, SE_MIX = 1, ROUND = 2 };

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
  T* ws;                // global workspace (workspace_elems(n, K))
  int n, d, dim, K;
  T jitter;
  T n_log2pi;
};

template <typename T, bool SMEM, int MODE>
__global__ void __launch_bounds__(NT) smallk_kernel(const SmallkArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = Ar<T>;
  __shared__ T s_r1[MODE == GRAMS ? 1 : MAX_K][MAX_D];
  __shared__ T s_r2[MODE == GRAMS ? 1 : MAX_K][MAX_D];
  __shared__ T s_w1[MAX_K], s_w2[MAX_K], s_ws[MAX_K];
  __shared__ T s_ld[MAX_K], s_qyy[MAX_K], s_qoy[MAX_K], s_qoo[MAX_K];
  __shared__ T s_dinv[2 * MAX_K];
  __shared__ int s_sel;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = a.n, d = a.d, K = a.K;
  const size_t nn = (size_t)n * (n + 1) / 2;
  const Factors<T> f(SMEM ? (T*)smem_raw : a.ws, n, K, s_ld, s_qyy, s_qoy,
                     s_qoo, s_dinv);

  if (MODE == GRAMS) {
    // the lower triangle of each Gram, a warp per Gram row c (contiguous
    // loads), into the packed upper triangle: (c, i) -> M[i][c], i <= c
    for (int row = warp; row < K * n; row += WARPS) {
      const int k = row / n, c = row - k * n;
      const T* g = a.grams + ((size_t)k * n + c) * n;
      T* Mk = f.M + (size_t)k * nn;
      for (int i = lane; i <= c; i += 32) {
        T v = g[i];
        if (i == c && a.jitter != T(0)) v = A::add(v, a.jitter);
        Mk[rowbase(i, n) + c] = v;
      }
      if (lane == 0) {
        f.RY[(size_t)k * n + c] = a.y[c];
        f.RO[(size_t)k * n + c] = T(1);
      }
    }
  } else {
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
  }
  __syncthreads();

  factor_quadratics<T>(f, n, K);

  if (MODE != ROUND) {
    if (tid < K) {
      T* o = a.q + (size_t)tid * 4;
      o[0] = s_ld[tid];
      o[1] = s_qyy[tid];
      o[2] = s_qoy[tid];
      o[3] = s_qoo[tid];
    }
    return;
  }
  // K7: log-posteriors and the first-acceptance scan
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

template <typename T, int MODE>
int launch(SmallkArgs<T> a, double jitter, void* stream) {
  if (a.K < 1 || a.K > MAX_K || a.n < 1) return (int)cudaErrorInvalidValue;
  if (MODE != GRAMS && (a.d < 1 || a.d > MAX_D))
    return (int)cudaErrorInvalidValue;
  if (MODE == ROUND && (a.dim < 1 || a.dim > MAX_DIM))
    return (int)cudaErrorInvalidValue;
  a.jitter = (T)jitter;
  a.n_log2pi = (T)(a.n * 1.8378770664093453);   // n * log(2 pi)
  cudaStream_t s = (cudaStream_t)stream;
  return launch_smem_or_global(
      smallk_kernel<T, true, MODE>, smallk_kernel<T, false, MODE>,
      workspace_elems(a.n, a.K) * sizeof(T), [&](auto kern, size_t bytes) {
        kern<<<1, NT, bytes, s>>>(a);
      });
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
  return launch<T, GRAMS>(a, jitter, stream);
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
  return launch<T, SE_MIX>(a, jitter, stream);
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
  return launch<T, ROUND>(a, jitter, stream);
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
