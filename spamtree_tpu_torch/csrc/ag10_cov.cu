// AG10 covariance blocks, masked, for a whole tree level at once: kernel K6.
//
// Replaces no TPU kernel: the JAX package writes the covariance
// (spamtree_tpu/ops/covariance.py::pairwise_cov) as plain array code, which
// XLA fuses into its consumers.  Run op by op in PyTorch the same formula
// materialises ~20 full (C, B, n1, n2) intermediates per call (coordinate
// differences, their sum, sqrt, per-margin gathers, selects, exps,
// quotients) and one more pass for the caller's mask.  This kernel writes
// the masked block once.
//
// For covariance model 0 (Apanasovich & Genton 2010 on a 2-d domain), with
// cx1 (B, n1, dd) and cx2 (B, n2, dd) coordinates (the first two columns
// are the plane), mv1 (B, n1) and mv2 (B, n2) int64 margin ids, and the
// parameters of C chains (C = 1 without a chain axis), it writes out
// (C, B, n1, n2), row-major and contiguous:
//   eye = 0: K[i, j] * (m1[i] & m2[j]);
//   eye = 1: K[i, j] where m1[i] & m1[j], else the identity's entry.
// K is ops/covariance.py::pairwise_cov's formula in the same IEEE
// operations in the same order: explicit round-to-nearest intrinsics keep
// the compiler from contracting a product and a sum into one FMA, and the
// library's expf / log1pf / sqrtf (no fast-math) are those PyTorch's own
// CUDA kernels call, so on the card the kernel and the plain version agree
// to the libm's rounding, typically to the bit.
//
// What bounds it on Hopper: bytes written, then the transcendental
// functions.  Each entry reads nothing from device memory but its row's and
// column's coordinates, ids and masks (n1 + n2 of them a block) and writes
// one value; it costs a sqrt, one or two expf and two IEEE divisions.  At
// the five-outcome configuration's thin level (B = 1024, n1 = 709, n2 = 185,
// f32) the launch writes 537 MB: 0.16 ms at the card's memory rate.
// Design: one thread block per tile of rows of one (chain, block) pair.
// The tile spans whole rows when n2 <= 512 (else it is cut in column
// tiles), so its entries are one contiguous stretch of the output and the
// stores of consecutive threads land on consecutive addresses.  Each thread
// owns one column: its coordinates, id and mask sit in registers, and it
// walks the tile's rows with a stride of the rows a pass covers.  The
// tile's rows are staged in shared memory once; so are the chain's
// per-margin-pair constants (coefficient, the Gneiting scale and its
// square, the nugget's factor), computed by the block's threads from the
// parameters, at q <= 16 at most 256 pairs.  The kernel reads the
// parameters in place through their strides (views of theta), so a call
// launches nothing but the kernel.

#include <cuda_runtime.h>

// the arguments of one call, filled by the wrapper (ops/covariance.py::
// _CovArgs, field by field) and copied into the launch
struct CovArgs {
  const void* cx1;
  const void* cx2;
  const long long* mv1;
  const long long* mv2;
  const unsigned char* m1;  // (B, n1)
  const unsigned char* m2;  // (B, n2); unused with eye (m1 serves both)
  void* out;
  const void* ai1;
  const void* ai2;
  const void* phi;
  const void* tmv;
  const void* dmat;
  long long s_ai1[2];  // chain stride, element stride (elements)
  long long s_ai2[2];
  long long s_phi[2];
  long long s_tmv[2];
  long long s_dmat[3];  // chain, row, column
  long long C, B, n1, n2;
  int dd, q, eye;
};

namespace {

constexpr int kMaxQ = 16;
constexpr int kMaxRowsPerTile = 1024;

// the IEEE operations, never contracted
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double dvd(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float ex(float a) { return expf(a); }
__device__ __forceinline__ float lg1p(float a) { return log1pf(a); }
__device__ __forceinline__ float sq(float a) { return sqrtf(a); }
__device__ __forceinline__ double ex(double a) { return exp(a); }
__device__ __forceinline__ double lg1p(double a) { return log1p(a); }
__device__ __forceinline__ double sq(double a) { return sqrt(a); }

// the tile: rows_per_pass rows of tc threads each, tile_rows rows a block
struct Tiling {
  int tc;             // columns a tile spans (= threads per row)
  int rows_per_pass;  // rows one pass of the block covers
  int tile_rows;      // rows a tile spans (a multiple of rows_per_pass)
  long long col_tiles, row_tiles;
};

Tiling tiling(long long n1, long long n2) {
  Tiling t;
  t.col_tiles = (n2 + 511) / 512;
  t.tc = static_cast<int>((n2 + t.col_tiles - 1) / t.col_tiles);
  t.rows_per_pass = t.tc >= 256 ? 1 : 256 / t.tc;
  // ~16 entries a thread; whole passes; at most kMaxRowsPerTile rows
  long long want = 16LL * t.rows_per_pass;
  if (want > kMaxRowsPerTile) want = kMaxRowsPerTile;
  t.row_tiles = (n1 + want - 1) / want;
  long long tr = (n1 + t.row_tiles - 1) / t.row_tiles;
  tr = (tr + t.rows_per_pass - 1) / t.rows_per_pass * t.rows_per_pass;
  if (tr > kMaxRowsPerTile)
    tr = kMaxRowsPerTile / t.rows_per_pass * t.rows_per_pass;
  t.tile_rows = static_cast<int>(tr);
  t.row_tiles = (n1 + tr - 1) / tr;
  return t;
}

template <typename T>
__device__ __forceinline__ T qnan();
template <>
__device__ __forceinline__ float qnan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double qnan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// QMODE: 1 = the univariate fast path (q = 1), 2 = q = 2, 3 = q > 2
template <typename T, int QMODE>
__global__ void ag10_cov_kernel(const CovArgs a, const Tiling t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q = a.q;
  const int nq = QMODE == 1 ? 1 : q * q;
  // per-pair constants (pair p = row margin * q + column margin), then the
  // tile's rows
  T* coef = reinterpret_cast<T*>(smem_raw);
  T* scale = coef + nq;   // exp(-c h / scale) ...
  T* denom = scale + nq;  // ... / denom
  T* same = denom + nq;   // 1 where the pair's latent distance v is 0
  T* nugc = same + nq;    // ai2_a^2
  T* negphi = nugc + nq;  // -phi_a
  T* rx = negphi + nq;
  T* ry = rx + t.tile_rows;
  int* rid = reinterpret_cast<int*>(ry + t.tile_rows);
  unsigned char* rok = reinterpret_cast<unsigned char*>(rid + t.tile_rows);
  __shared__ T negc;  // -c_phi1 (q >= 2), -phi (q = 1)

  long long lin = blockIdx.x;
  const long long ct = lin % t.col_tiles;
  lin /= t.col_tiles;
  const long long rt = lin % t.row_tiles;
  lin /= t.row_tiles;
  const long long b = lin % a.B;
  const long long c = lin / a.B;

  const T* ai1 = static_cast<const T*>(a.ai1) + c * a.s_ai1[0];
  const T* ai2 = static_cast<const T*>(a.ai2) + c * a.s_ai2[0];
  const T* phi = static_cast<const T*>(a.phi) + c * a.s_phi[0];
  const T* tmv = static_cast<const T*>(a.tmv) + c * a.s_tmv[0];
  const T* dm = static_cast<const T*>(a.dmat) + c * a.s_dmat[0];
  const int tid = threadIdx.x;
  if (tid == 0) {
    // thetamv: (a_psi1, beta_psi1, c_phi1) for q > 2, (c_phi1) for q = 2,
    // (phi) for q = 1
    negc = -tmv[(QMODE == 3 ? 2 : 0) * a.s_tmv[1]];
    if (QMODE == 1) coef[0] = ai1[0];
  }
  for (int p = tid; QMODE != 1 && p < nq; p += blockDim.x) {
    const int ma = p / q, mb = p % q;
    const T v = dm[ma * a.s_dmat[1] + mb * a.s_dmat[2]];
    const bool s = v == T(0);
    const T a1a = ai1[ma * a.s_ai1[1]], a1b = ai1[mb * a.s_ai1[1]];
    const T a2a = ai2[ma * a.s_ai2[1]];
    coef[p] = s ? mul(a1a, a1a) : mul(a1a, a1b);
    if (QMODE == 3) {  // psi1_sqrt = exp(0.5 beta_psi1 log1p(a_psi1 v))
      const T apsi = tmv[0], bpsi = tmv[a.s_tmv[1]];
      const T ps = ex(mul(mul(T(0.5), bpsi), lg1p(mul(apsi, v))));
      scale[p] = ps;
      denom[p] = mul(ps, ps);
    } else {
      const T v1 = add(v, T(1));
      scale[p] = sq(v1);
      denom[p] = v1;
    }
    same[p] = s ? T(1) : T(0);
    nugc[p] = mul(a2a, a2a);
    negphi[p] = -phi[ma * a.s_phi[1]];
  }

  const long long r0 = rt * t.tile_rows;
  const int nr = static_cast<int>(
      a.n1 - r0 < t.tile_rows ? a.n1 - r0 : t.tile_rows);
  const T* cx1 = static_cast<const T*>(a.cx1);
  for (int r = tid; r < nr; r += blockDim.x) {
    const long long g = b * a.n1 + r0 + r;
    rx[r] = cx1[g * a.dd];
    ry[r] = cx1[g * a.dd + 1];
    rid[r] = static_cast<int>(a.mv1[g]);
    rok[r] = a.m1[g];
  }
  __syncthreads();

  const long long j = ct * t.tc + tid % t.tc;
  if (j >= a.n2) return;
  const T* cx2 = static_cast<const T*>(a.cx2);
  const long long gj = b * a.n2 + j;
  const T x2 = cx2[gj * a.dd], y2 = cx2[gj * a.dd + 1];
  const long long mj = a.mv2[gj];
  const bool cok = a.eye ? a.m1[b * a.n1 + j] != 0 : a.m2[gj] != 0;
  T* out = static_cast<T*>(a.out) + ((c * a.B + b) * a.n1 + r0) * a.n2 + j;

  for (int r = tid / t.tc; r < nr; r += t.rows_per_pass) {
    const bool ok = rok[r] && cok;
    const long long i = r0 + r;
    T k;
    if (a.eye && !ok) {
      k = i == j ? T(1) : T(0);
    } else {
      const T dx = sub(rx[r], x2), dy = sub(ry[r], y2);
      T d2 = add(mul(dx, dx), mul(dy, dy));
      d2 = d2 < T(0) ? T(0) : d2;  // clamp(min=0); NaN stays NaN
      const T h = sq(d2);
      if (QMODE == 1) {
        k = mul(coef[0], ex(mul(negc, h)));
      } else if (static_cast<unsigned>(rid[r]) >= static_cast<unsigned>(q) ||
                 static_cast<unsigned long long>(mj) >=
                     static_cast<unsigned long long>(q)) {
        k = qnan<T>();  // a margin id out of range
      } else {
        const int p = rid[r] * q + static_cast<int>(mj);
        const T cb = dvd(ex(dvd(mul(negc, h), scale[p])), denom[p]);
        // the nugget's term only on pairs with v == 0, as the plain
        // version's select keeps it
        const T nug = same[p] != T(0) ? mul(nugc[p], ex(mul(negphi[p], h)))
                                      : T(0);
        k = add(mul(coef[p], cb), nug);
      }
      if (!a.eye) k = mul(k, ok ? T(1) : T(0));
    }
    out[static_cast<long long>(r) * a.n2] = k;
  }
}

template <typename T, int QMODE>
int launch_mode(const CovArgs& a, cudaStream_t st) {
  const Tiling t = tiling(a.n1, a.n2);
  const int nq = QMODE == 1 ? 1 : a.q * a.q;
  const size_t smem =
      sizeof(T) * (6 * static_cast<size_t>(nq) + 2 * t.tile_rows) +
      (sizeof(int) + 1) * static_cast<size_t>(t.tile_rows);
  const long long blocks = a.C * a.B * t.row_tiles * t.col_tiles;
  if (blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int threads = t.rows_per_pass * t.tc;
  ag10_cov_kernel<T, QMODE><<<static_cast<unsigned int>(blocks), threads, smem,
                              st>>>(a, t);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const CovArgs* a, void* stream) {
  if (a->q < 1 || a->q > kMaxQ || a->dd < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->C < 1 || a->B < 1 || a->n1 < 1 || a->n2 < 1) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->q == 1) return launch_mode<T, 1>(*a, st);
  if (a->q == 2) return launch_mode<T, 2>(*a, st);
  return launch_mode<T, 3>(*a, st);
}

}  // namespace

// Plain C entry points for ctypes: the arguments by pointer (copied into
// the launch), the stream.  Returns the launch's cudaGetLastError() as an
// int (0 = launched), or cudaErrorInvalidValue for q outside 1..16 or
// dd < 2.
extern "C" int st_ag10_cov_f32(const CovArgs* a, void* stream) {
  return launch<float>(a, stream);
}

extern "C" int st_ag10_cov_f64(const CovArgs* a, void* stream) {
  return launch<double>(a, stream);
}
