// Fused thin-level kernels for the SpamTree sweeps: K3 (w-Gibbs) and K4
// (decision sweep), each instantiated for float and double.
//
// thin_gibbs_kernel replaces the Pallas TPU kernel
// spamtree_tpu/ops/pallas_level.py::thin_gibbs_level (_thin_gibbs_kernel).
// Per thin block b, with H (S, P) the stored conditional-mean operator:
//   hw  = H wpar ; sig = prec + ti
//   wu  = (prec hw + resid) / sig + z / sqrt(sig), 0 where rmask <= 0.5
//   msg = H' (prec (wu - hw))
// What bounds it on Hopper: bytes.  It reads H once from device memory (at
// bench config 3, B = 1024, S = 68, P = 293, f32: 82 MB, 0.026 ms at the
// H100 SXM's 3.35 TB/s) for 4 B S P flops.  Design: one thread block per tree block.
// Pass 1 gives each warp whole rows of H, read coalesced along P against
// wpar held in shared memory, and reduces each row with warp shuffles; the
// row's wu and v = prec (wu - hw) stay in shared memory.  Pass 2 gives each
// thread one column p of H, reads H again (the block's slab, at most 2 MB,
// comes from L2) and sums H[s, p] v[s] in row order.
//
// thin_decision_kernel replaces pallas_level.py::thin_decision_level, both
// its bodies (_thin_decision_kernel, and _thin_decision_kernel_vpu for the
// 128-aligned layouts: the split is a TPU layout artefact).  Per block b,
// with LAi = joint[lp_pos[b]] (P, P) and Kxc (P, S):
//   M = LAi Kxc ; u = LAi wpar ; hk = sum_p M^2 ; hw = M' u
//   r = kdiag - hk on rows with rmask > 0.5, else 1 ; ok = all(r finite, > 0)
//   logdet = -1/2 sum log r (masked) ; qn = -1/2 sum (w_r - hw)^2 / r
//   qc = -1/2 sum prevprec (w_r - prevH wpar)^2
// and writes the block's four partials (logdet, qn, qc, ok) to part[b];
// the caller reduces them over B (no atomics: runs repeat bit for bit).
// What bounds it on Hopper: operations.  2 P^2 (S + 1) B flops on the FP32
// CUDA cores (TF32 is barred by the package's precision pins): at config 3,
// 12.2 GFLOP, 0.183 ms at the H100 SXM's 67 TFLOP/s, against ~0.52 GB of
// input, 0.154 ms at 3.35 TB/s.
// Design: one thread block per tree block, a plain shared-memory tiled
// product.  u rides as a virtual column S of the right-hand side, read
// straight from wpar (never concatenated in device memory), and the column
// tile that holds it runs first, so every later tile finds u complete in
// shared memory.  Each 64 x 32 tile of M is reduced into hk and hw in
// registers and never leaves the SM.  The tiles need at most 37 KB of
// shared memory (double, P = 1024), at any S <= 512.  LAi is not assumed
// triangular.
//
// No early exit and no error path: a non-positive or non-finite r makes the
// block's ok flag 0, as in the TPU kernel.  Built without fast-math, so log,
// sqrt and division keep IEEE semantics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int TP = 64;  // rows of LAi per tile
constexpr int TS = 32;  // columns of [Kxc | wpar] per tile
constexpr int TQ = 32;  // contraction depth per tile
constexpr int RP = TP / kWarps;  // rows of M per thread

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // xor butterfly: every lane ends with the same total, in a fixed order
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) thin_gibbs_kernel(
    const T* __restrict__ H, const T* __restrict__ prec,
    const T* __restrict__ wpar, const T* __restrict__ z,
    const T* __restrict__ ti, const T* __restrict__ resid,
    const T* __restrict__ rmask, T* __restrict__ wu_out,
    T* __restrict__ msg_out, int S, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);  // P: wpar
  T* sv = sw + P;                          // S: prec (wu - hw)

  const long long b = blockIdx.x;
  const T* Hb = H + b * S * P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int p = tid; p < P; p += kThreads) sw[p] = wpar[b * P + p];
  __syncthreads();

  for (int s = warp; s < S; s += kWarps) {
    const T* row = Hb + static_cast<long long>(s) * P;
    T hw = T(0);
    for (int p = lane; p < P; p += 32) hw += row[p] * sw[p];
    hw = warp_sum(hw);
    if (lane == 0) {
      const long long i = b * S + s;
      const T pr = prec[i];
      const T sig = pr + ti[i];
      T wu = (pr * hw + resid[i]) / sig + z[i] / sqrt_(sig);
      if (!(rmask[i] > T(0.5))) wu = T(0);
      wu_out[i] = wu;
      sv[s] = pr * (wu - hw);
    }
  }
  __syncthreads();

  for (int p = tid; p < P; p += kThreads) {
    T acc = T(0);
    for (int s = 0; s < S; ++s) acc += Hb[static_cast<long long>(s) * P + p] * sv[s];
    msg_out[b * P + p] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) thin_decision_kernel(
    const T* __restrict__ Kxc, const T* __restrict__ joint,
    const long long* __restrict__ lp_pos, const T* __restrict__ wpar,
    const T* __restrict__ w_r, const T* __restrict__ prevH,
    const T* __restrict__ prevprec, const T* __restrict__ kdiag,
    const T* __restrict__ rmask, T* __restrict__ part, int S, int P) {
  __shared__ T sA[TP][TQ];       // tile of LAi
  __shared__ T sB[TQ][TS];       // tile of [Kxc | wpar]
  __shared__ T sHk[kWarps][TS];  // per-warp column partials of hk
  __shared__ T sHw[kWarps][TS];  // ... and of hw
  __shared__ T sQc[kWarps];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* su = reinterpret_cast<T*>(smem_raw);  // P: u = LAi wpar

  const long long b = blockIdx.x;
  // aligned levels pass no lp_pos: block b reads parent slab b
  const long long pb = lp_pos ? lp_pos[b] : b;
  const T* A = joint + pb * P * P;
  const T* K = Kxc + b * P * S;
  const T* wp = wpar + b * P;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int ntile = (S + 1 + TS - 1) / TS;  // S columns + the u column

  T ld_acc = T(0), qn_acc = T(0);  // warp 0: sums over its columns
  bool ok = true;

  for (int k = 0; k < ntile; ++k) {
    const int s0 = ((k + ntile - 1) % ntile) * TS;  // u's tile first
    const int c = s0 + tx;
    T hk = T(0), hw = T(0);
    for (int p0 = 0; p0 < P; p0 += TP) {
      T m[RP];
#pragma unroll
      for (int i = 0; i < RP; ++i) m[i] = T(0);
      for (int q0 = 0; q0 < P; q0 += TQ) {
        for (int e = tid; e < TP * TQ; e += kThreads) {
          const int r = e / TQ, cc = e % TQ;
          const int p = p0 + r, q = q0 + cc;
          sA[r][cc] = (p < P && q < P) ? A[static_cast<long long>(p) * P + q]
                                       : T(0);
        }
        for (int e = tid; e < TQ * TS; e += kThreads) {
          const int r = e / TS, cc = e % TS;
          const int q = q0 + r, col = s0 + cc;
          T v = T(0);
          if (q < P) {
            if (col < S) v = K[static_cast<long long>(q) * S + col];
            else if (col == S) v = wp[q];
          }
          sB[r][cc] = v;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < TQ; ++kk) {
          const T bv = sB[kk][tx];
#pragma unroll
          for (int i = 0; i < RP; ++i) m[i] += sA[ty + kWarps * i][kk] * bv;
        }
        __syncthreads();
      }
      if (c == S) {
#pragma unroll
        for (int i = 0; i < RP; ++i) {
          const int p = p0 + ty + kWarps * i;
          if (p < P) su[p] = m[i];
        }
      }
      __syncthreads();
      if (c < S) {
#pragma unroll
        for (int i = 0; i < RP; ++i) {
          const int p = p0 + ty + kWarps * i;
          if (p < P) {
            hk += m[i] * m[i];
            hw += m[i] * su[p];
          }
        }
      }
    }
    sHk[ty][tx] = hk;
    sHw[ty][tx] = hw;
    __syncthreads();
    if (ty == 0 && c < S) {
      T hks = T(0), hws = T(0);
      for (int g = 0; g < kWarps; ++g) {
        hks += sHk[g][tx];
        hws += sHw[g][tx];
      }
      const long long i = b * S + c;
      const bool in = rmask[i] > T(0.5);
      T r = in ? kdiag[i] - hks : T(1);
      const bool okl = isfinite(r) && r > T(0);
      ok = ok && okl;
      if (!okl) r = T(1);
      if (in) ld_acc += log_(r);
      const T wx = w_r[i] - hws;
      qn_acc += wx * wx / r;
    }
    __syncthreads();
  }

  // qc: wxc = w_r - prevH wpar, one warp per row of prevH
  T qc_acc = T(0);
  const T* Hp = prevH + b * S * P;
  for (int s = ty; s < S; s += kWarps) {
    const T* row = Hp + static_cast<long long>(s) * P;
    T acc = T(0);
    for (int p = tx; p < P; p += 32) acc += row[p] * wp[p];
    acc = warp_sum(acc);
    const long long i = b * S + s;
    const T wxc = w_r[i] - acc;
    qc_acc += prevprec[i] * wxc * wxc;
  }
  if (tx == 0) sQc[ty] = qc_acc;
  __syncthreads();
  if (ty == 0) {
    ld_acc = warp_sum(ld_acc);
    qn_acc = warp_sum(qn_acc);
    const bool all_ok = __all_sync(0xffffffffu, ok);
    if (tx == 0) {
      T qc = T(0);
      for (int g = 0; g < kWarps; ++g) qc += sQc[g];
      part[b * 4 + 0] = T(-0.5) * ld_acc;
      part[b * 4 + 1] = T(-0.5) * qn_acc;
      part[b * 4 + 2] = T(-0.5) * qc;
      part[b * 4 + 3] = all_ok ? T(1) : T(0);
    }
  }
}

template <typename T>
int launch_gibbs(const void* H, const void* prec, const void* wpar,
                 const void* z, const void* ti, const void* resid,
                 const void* rmask, void* wu, void* msg, long long B, int S,
                 int P, void* stream) {
  const size_t smem = sizeof(T) * (static_cast<size_t>(P) + S);
  cudaError_t err = cudaFuncSetAttribute(
      thin_gibbs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  thin_gibbs_kernel<T><<<static_cast<unsigned int>(B), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(H), static_cast<const T*>(prec),
      static_cast<const T*>(wpar), static_cast<const T*>(z),
      static_cast<const T*>(ti), static_cast<const T*>(resid),
      static_cast<const T*>(rmask), static_cast<T*>(wu), static_cast<T*>(msg),
      S, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_decision(const void* Kxc, const void* joint, const void* lp_pos,
                    const void* wpar, const void* w_r, const void* prevH,
                    const void* prevprec, const void* kdiag, const void* rmask,
                    void* part, long long B, int S, int P, void* stream) {
  const size_t smem = sizeof(T) * static_cast<size_t>(P);
  cudaError_t err = cudaFuncSetAttribute(
      thin_decision_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  thin_decision_kernel<T><<<static_cast<unsigned int>(B), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Kxc), static_cast<const T*>(joint),
      static_cast<const long long*>(lp_pos), static_cast<const T*>(wpar),
      static_cast<const T*>(w_r), static_cast<const T*>(prevH),
      static_cast<const T*>(prevprec), static_cast<const T*>(kdiag),
      static_cast<const T*>(rmask), static_cast<T*>(part), S, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  Every array is row-major and contiguous;
// lp_pos is int64 or null (aligned: block b reads parent slab b).  Each
// returns the launch's cudaGetLastError() as an int (0 = launched).
extern "C" int st_thin_gibbs_f32(const void* H, const void* prec,
                                 const void* wpar, const void* z,
                                 const void* ti, const void* resid,
                                 const void* rmask, void* wu, void* msg,
                                 long long B, int S, int P, void* stream) {
  return launch_gibbs<float>(H, prec, wpar, z, ti, resid, rmask, wu, msg, B,
                             S, P, stream);
}

extern "C" int st_thin_gibbs_f64(const void* H, const void* prec,
                                 const void* wpar, const void* z,
                                 const void* ti, const void* resid,
                                 const void* rmask, void* wu, void* msg,
                                 long long B, int S, int P, void* stream) {
  return launch_gibbs<double>(H, prec, wpar, z, ti, resid, rmask, wu, msg, B,
                              S, P, stream);
}

extern "C" int st_thin_decision_f32(const void* Kxc, const void* joint,
                                    const void* lp_pos, const void* wpar,
                                    const void* w_r, const void* prevH,
                                    const void* prevprec, const void* kdiag,
                                    const void* rmask, void* part, long long B,
                                    int S, int P, void* stream) {
  return launch_decision<float>(Kxc, joint, lp_pos, wpar, w_r, prevH,
                                prevprec, kdiag, rmask, part, B, S, P, stream);
}

extern "C" int st_thin_decision_f64(const void* Kxc, const void* joint,
                                    const void* lp_pos, const void* wpar,
                                    const void* w_r, const void* prevH,
                                    const void* prevprec, const void* kdiag,
                                    const void* rmask, void* part, long long B,
                                    int S, int P, void* stream) {
  return launch_decision<double>(Kxc, joint, lp_pos, wpar, w_r, prevH,
                                 prevprec, kdiag, rmask, part, B, S, P,
                                 stream);
}
