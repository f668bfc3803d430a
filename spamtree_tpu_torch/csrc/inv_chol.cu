// Batched inverse Cholesky factor for small identity-padded SPD blocks.
//
// Replaces the Pallas TPU kernels spamtree_tpu/ops/pallas_chol.py::
// inv_chol_lanes (L stays on chip) and chol_and_inv_lanes (L written out,
// here the write-L form of the same kernel).  For A (B, S, S), S <= 128
// (double: S <= 64), row-major and contiguous, it writes Linv = chol(A)^-1
// (lower triangular, zeros above the diagonal) and, when L is non-null,
// L = chol(A).
//
// What bounds it on Hopper: latency, not bytes.  At the deepest config-3
// level (B = 1024, S = 47) the launch moves ~18 MB in f32 (5 us at the
// card's memory rate) and every matrix fits on the card at once, so a
// launch costs the dependent chain of one matrix.  Design: one thread block
// per matrix, S padded to SP = 32, 64, 96 or 128 threads, thread i holding
// row i in registers (96 and 128, float only: 96 serves the trivariate
// configuration's 70-75 row reference blocks, three outcomes at each of 25
// sites, and 128 the five-outcome configuration's 112-121 row blocks; a
// double row of 96 spills past the 255 registers a thread has, so double
// stops at 64 and the callers take the plain route above).  A right-looking
// Cholesky carries the inverse along in the same registers: before step k,
// row i holds [T[i, 0..k-1] | A[i, k..]], with T the residual of the
// inverse, unscaled (T = I at the start; row k of Linv is row k of T over
// L_kk).  At step k every row i > k subtracts (A[i, k] / L_kk^2) v from
// its whole row, v being row k as it stands (T[k, 0..k-1], then 1 for
// T[k, k], beside the column A[k+1.., k]): one update serves the trailing
// matrix and the inverse's residual.  Factor and inverse take S dependent
// steps, each two block barriers around a burst of SP independent FMAs
// whose operand v is read by 16-byte broadcasts; a row-per-thread
// substitution would chain ~S^2/2 of them.
// Row k + 1 writes itself to v as soon as its update is done, and a row
// is scaled by its 1/L_kk only when it is written out.  The row is kept
// rotated by k (register p holds column (p + k) mod SP, and the update
// writes each result one register to the left), so column k always sits
// in register 0: every register index is static while the step loop stays
// rolled and the code small.  A and Linv pass through shared memory once,
// so their device-memory accesses are coalesced, and A's copies (cp.async)
// are all in flight at once.  The 128-thread form is the same code: its
// 128-float row leaves two blocks an SM, and its S x (S + 1) buffer (65 KB
// at S = 128) passes the 48 KB default: its launcher raises the kernel's
// limit once per device, before the first launch there.
//
// Failure contract: no early exit and no error path.  A non-SPD block
// takes the square root of a non-positive pivot, which turns that row of
// Linv and every later row into NaN (or inf); the caller's ok flag
// (diag(Linv) finite and > 0) is then false, exactly like the TPU kernel
// and like LAPACK's failed factorisation after the caller's NaN fill.
// Built without fast-math, so sqrt and the one division per step keep IEEE
// semantics.  Linv does not depend on whether L is written: L only adds
// stores.

#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  }
}

// the row c (SP registers) to v, 16 bytes a store
template <typename T, int SP>
__device__ __forceinline__ void store_row(T* v, const T (&c)[SP]) {
#pragma unroll
  for (int p = 0; p < SP; p += 16 / sizeof(T)) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(v + p) =
          make_float4(c[p], c[p + 1], c[p + 2], c[p + 3]);
    } else {
      *reinterpret_cast<double2*>(v + p) = make_double2(c[p], c[p + 1]);
    }
  }
}

// Blocks that share an SM.  float, SP <= 64: at most 128 registers, so
// eight blocks of 64 share an SM and a batch of 1024 fits the card at once.
// A row of SP = 96 floats needs that many registers besides: four blocks
// of 96 (at most 170 registers); a row of 128, two blocks of 128 (at most
// 255).  double keeps two registers a column: one block.
template <typename T, int SP>
constexpr int min_blocks() {
  return sizeof(T) != 4 ? 1 : SP <= 64 ? 8 : SP <= 96 ? 4 : 2;
}

template <typename T, int SP>
__global__ void __launch_bounds__(SP, min_blocks<T, SP>())
    inv_chol_kernel(const T* __restrict__ A, T* __restrict__ Linv,
                    T* __restrict__ Lout, int S) {
  constexpr int VEC = 16 / sizeof(T);
  // v of step k in v[k & 1], rotated like the rows (v[.][p] is column
  // (p + k) mod SP); v[.][0] holds the pivot A[k, k]
  __shared__ __align__(16) T v[2][SP];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);  // S x (S + 1): A in, Linv out
  const int ld = S + 1;
  const int i = threadIdx.x;
  const bool row = i < S;
  const size_t off = static_cast<size_t>(blockIdx.x) * S * S;

  for (int e = i; e < S * S; e += SP)
    cp_async(buf + (e / S) * ld + e % S, A + off + e);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  T c[SP];  // row i, rotated by k: c[p] is column (p + k) mod SP
#pragma unroll
  for (int p = 0; p < SP; ++p) c[p] = (row && p < S) ? buf[i * ld + p] : T(0);
  if (i == 0) store_row(v[0], c);
  __syncthreads();

  T rii = T(0);  // this row's 1/L_ii, from its own step
  for (int k = 0; k < S; ++k) {
    T* vk = v[k & 1];
    const T lkk = sqrt(vk[0]);
    const T rk = T(1) / lkk;
    T aik = T(0);
    if (row && i > k) {
      aik = c[0];  // A[i, k]: L[i, k] = aik / L_kk
      vk[i - k] = aik;
      if (Lout) Lout[off + static_cast<size_t>(i) * S + k] = aik * rk;
    } else if (i == k) {
      rii = rk;
      if (Lout) Lout[off + static_cast<size_t>(k) * S + k] = lkk;
    }
    __syncthreads();
    if (row && i > k) {
      // trailing A[i, k+1..] and residual T[i, 0..k] in one update, rotated
      // by one: column k leaves register 0 for register SP-1 as T[i, k] =
      // 0 - f T[k, k].  Columns past S are padding, never read.
      const T f = aik * rk * rk;
#pragma unroll
      for (int p0 = 0; p0 < SP; p0 += VEC) {
        T x[VEC];
        if constexpr (sizeof(T) == 4) {
          const float4 q = *reinterpret_cast<const float4*>(vk + p0);
          x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
        } else {
          const double2 q = *reinterpret_cast<const double2*>(vk + p0);
          x[0] = q.x; x[1] = q.y;
        }
#pragma unroll
        for (int m = 0; m < VEC; ++m) {
          if (p0 + m > 0) c[p0 + m - 1] = c[p0 + m] - f * x[m];
        }
      }
      c[SP - 1] = -f;
      if (i == k + 1) store_row(v[(k + 1) & 1], c);  // the next step's v
    }
    __syncthreads();
  }

  if (row) {  // row i stopped rotating at its own step: c[p] is column p + i
#pragma unroll
    for (int p = 0; p < SP; ++p) {
      const int j = (p + i) % SP;
      if (j < S) buf[i * ld + j] = j < i ? c[p] * rii : j == i ? rii : T(0);
    }
  }
  __syncthreads();
  for (int e = i; e < S * S; e += SP) {
    const int r = e / S, cc = e % S;
    Linv[off + e] = buf[r * ld + cc];
    if (Lout && cc > r) Lout[off + e] = T(0);  // L's strict upper triangle
  }
}

// The dynamic shared memory that SP's largest S needs, allowed once per
// device (an attribute of the kernel, not of a stream: it holds in and out
// of a graph capture)
template <typename T, int SP>
cudaError_t allow_smem() {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kDevices && done[dev])) return e;
  e = cudaFuncSetAttribute(inv_chol_kernel<T, SP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(sizeof(T) * SP * (SP + 1)));
  if (e == cudaSuccess && dev < kDevices) done[dev] = true;
  return e;
}

template <typename T, int SP>
int launch_sp(const void* A, void* Linv, void* L, long long B, int S,
              cudaStream_t st) {
  // at most 37 KB up to SP = 96 (f32, S = 96; f64, S = 64: 33 KB): under
  // the 48 KB default; SP = 128 takes up to 65 KB
  const size_t smem = sizeof(T) * static_cast<size_t>(S) * (S + 1);
  if constexpr (SP > 96) {
    const cudaError_t e = allow_smem<T, SP>();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  inv_chol_kernel<T, SP><<<static_cast<unsigned int>(B), SP, smem, st>>>(
      static_cast<const T*>(A), static_cast<T*>(Linv), static_cast<T*>(L), S);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* A, void* Linv, void* L, long long B, int S,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 4) {
    if (S > 96) return launch_sp<T, 128>(A, Linv, L, B, S, st);
    if (S > 64) return launch_sp<T, 96>(A, Linv, L, B, S, st);
  }
  return S <= 32 ? launch_sp<T, 32>(A, Linv, L, B, S, st)
                 : launch_sp<T, 64>(A, Linv, L, B, S, st);
}

}  // namespace

// Plain C entry points for ctypes.  L may be null (Linv only).  Returns the
// launch's cudaGetLastError() as an int (0 = launched).
extern "C" int st_inv_chol_f32(const void* A, void* Linv, void* L,
                               long long B, int S, void* stream) {
  return launch<float>(A, Linv, L, B, S, stream);
}

extern "C" int st_inv_chol_f64(const void* A, void* Linv, void* L,
                               long long B, int S, void* stream) {
  return launch<double>(A, Linv, L, B, S, stream);
}
