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
// Design: one thread block of 160 threads per tree block, one pass over
// LAi.  For each 64-row tile of LAi the block makes the whole 64 x 80 slab
// of M in registers, each thread a 4 x 8 micro-tile: three 16-byte shared
// loads feed 32 FMAs per contraction step.  LAi's tile sits transposed
// (depth-major) in shared memory so that a thread's four rows are one
// 16-byte load, and a warp spans all 16 row threads and two column
// threads.  The 80 columns are up to 79 columns of Kxc and u's column,
// read straight from wpar (never concatenated in device memory), so u[p]
// is finished in the same row tile as M[p, :]; S > 79 loops over column
// passes, each with its own copy of u's column.  hk and hw accumulate per
// column in registers across row tiles and meet in shared memory once per
// pass.  LAi (64 x 16) and [Kxc | u] (16 x 80) tiles stream through a
// three-stage ring of 4- or 8-byte cp.async copies (a warp's copies land on
// consecutive shared-memory words), so the next tiles' loads overlap this
// tile's FMAs: LAi's row stride (P elements) is no multiple of 16
// bytes at the main shapes, which rules out TMA and 16-byte copies.
// Kxc's tile is re-read per row tile (80 KB per block at config 3, from
// L2); LAi is read from device memory once.  At most 41 KB (float) or
// 82 KB (double) of shared memory at any P <= 1024, S <= 512.  LAi is not
// assumed triangular.  What holds it back: each warp's contraction step
// needs four shared-memory wavefronts for eight cycles of FMAs, so four
// warps issuing at once ask for twice what shared memory serves; and the
// padded slab does 1.32x the needed FLOPs at config 3 (320 rows for 293,
// 80 columns for 69).
//
// No early exit and no error path: a non-positive or non-finite r makes the
// block's ok flag 0, as in the TPU kernel.  Built without fast-math, so log,
// sqrt and division keep IEEE semantics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // K3's block
constexpr int kWarps = kThreads / 32;

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

// K4's tiling (see the header): threads, micro-tile, tiles, ring depth
constexpr int kDecThreads = 160;
constexpr int NC = 10, NR = 16;  // column and row threads of the block
constexpr int RN = 8, RM = 4;    // M columns and rows per thread
constexpr int W = NC * RN;       // slab width: up to W-1 columns and u
constexpr int TP = NR * RM;      // rows of LAi per row tile
constexpr int TQ = 16;           // contraction depth per stage
constexpr int LDA = TP + 4;      // pitch of the transposed LAi tile
constexpr int STAGES = 3;
// the tile copies: one slab column of [Kxc | u] per thread, every other
// depth row; two threads per row of LAi's tile, 8 depths each
static_assert(kDecThreads == 2 * W, "[Kxc | u] copy");
static_assert(TQ == 16 && TP * TQ / 8 <= kDecThreads, "LAi copy");

template <typename T>
constexpr size_t decision_smem() {
  return sizeof(T) * (STAGES * TQ * W + STAGES * TQ * LDA + TP + 2 * NR * W +
                      3 * kDecThreads);
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  // src_size 0 fills the element with zeros and reads nothing, so src may
  // point past the array there
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? static_cast<int>(sizeof(T)) : 0;
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

// N consecutive shared-memory values, 16 bytes per load (p 16-byte aligned)
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + j);
    v[j] = x.x; v[j + 1] = x.y; v[j + 2] = x.z; v[j + 3] = x.w;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const double* p, double (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    const double2 x = *reinterpret_cast<const double2*>(p + j);
    v[j] = x.x; v[j + 1] = x.y;
  }
}

// float: at most 102 registers (a few bytes spill), so four blocks share
// an SM; measured faster than 123 registers and three blocks
template <typename T>
__global__ void __launch_bounds__(kDecThreads, sizeof(T) == 4 ? 4 : 1)
    thin_decision_kernel(
    const T* __restrict__ Kxc, const T* __restrict__ joint,
    const long long* __restrict__ lp_pos, const T* __restrict__ wpar,
    const T* __restrict__ w_r, const T* __restrict__ prevH,
    const T* __restrict__ prevprec, const T* __restrict__ kdiag,
    const T* __restrict__ rmask, T* __restrict__ part, int S, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sB = reinterpret_cast<T*>(smem_raw);  // STAGES x TQ x W: [Kxc | u] tiles
  T* sA = sB + STAGES * TQ * W;            // STAGES x TQ x LDA: LAi tiles
  T* su = sA + STAGES * TQ * LDA;          // TP: u on the row tile
  T* sHk = su + TP;                        // NR x W: per-row-thread hk
  T* sHw = sHk + NR * W;                   // ... and hw
  T* sRed = sHw + NR * W;                  // 3 x kDecThreads: block sums

  const long long b = blockIdx.x;
  // aligned levels pass no lp_pos: block b reads parent slab b
  const long long pb = lp_pos ? lp_pos[b] : b;
  const T* A = joint + pb * P * P;
  const T* K = Kxc + b * P * S;
  const T* wp = wpar + b * P;
  const int tid = threadIdx.x, tr = tid % NR, tc = tid / NR;
  const int nrt = (P + TP - 1) / TP, nqt = (P + TQ - 1) / TQ;
  const int nit = nrt * nqt;  // (row tile, depth tile) steps of one pass

  T ld_acc = T(0), qn_acc = T(0);  // thread tid: column c0 + tid of a pass
  bool ok = true;

  for (int c0 = 0; c0 < S; c0 += W - 1) {
    const int nc = min(W - 1, S - c0);  // Kxc columns; u sits in slot nc

    // stage `st` <- LAi rows of row tile it / nqt, depth tile it % nqt.
    // A warp's copies land on consecutive shared-memory words (no bank
    // conflicts), and a tile costs each thread one address and 4- or 8-byte
    // cp.async's.
    auto load = [&](int st, int it) {
      const int p0 = (it / nqt) * TP, q0 = (it % nqt) * TQ;
      if (tid < TP * TQ / 8) {  // LAi: row r, depths q0 + cq ..
        const int r = tid % TP, cq = 8 * (tid / TP), p = p0 + r;
        const T* src = A + static_cast<long long>(p) * P + q0 + cq;
        T* dst = sA + st * TQ * LDA + cq * LDA + r;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const bool v = p < P && q0 + cq + m < P;
          cp_async(dst + m * LDA, src + m, v);
        }
      }
      {  // [Kxc | u]: slab column j, depth rows r0, r0 + 2, ...
        const int j = tid % W, r0 = tid / W;
        const T* src = j < nc ? K + c0 + j : wp;  // column j's depth 0
        const long long ld = j < nc ? S : 1;      // ... and its stride
        T* dst = sB + st * TQ * W + r0 * W + j;
#pragma unroll
        for (int m = 0; m < TQ / 2; ++m) {
          const int q = q0 + r0 + 2 * m;
          const bool v = j <= nc && q < P;
          cp_async(dst + 2 * m * W, src + q * ld, v);
        }
      }
    };

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nit) load(st, st);
      cp_async_commit();  // empty groups keep the ring's count uniform
    }

    T acc[RM][RN], hk[RN], hw[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      hk[j] = hw[j] = T(0);
#pragma unroll
      for (int i = 0; i < RM; ++i) acc[i][j] = T(0);
    }

    for (int it = 0; it < nit; ++it) {
      cp_async_wait_ring();
      __syncthreads();  // stage it has landed; stage it - 1 is free
      const int nxt = it + STAGES - 1;
      if (nxt < nit) load(nxt % STAGES, nxt);
      cp_async_commit();

      const T* a = sA + (it % STAGES) * TQ * LDA + RM * tr;
      const T* bt = sB + (it % STAGES) * TQ * W + RN * tc;
#pragma unroll
      for (int kk = 0; kk < TQ; ++kk) {
        T av[RM], bv[RN];
        load_vec(a + kk * LDA, av);
        load_vec(bt + kk * W, bv);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] += av[i] * bv[j];
      }

      if (it % nqt == nqt - 1) {  // row tile done: M and u are complete
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          if (RN * tc + j == nc) {
#pragma unroll
            for (int i = 0; i < RM; ++i) su[RM * tr + i] = acc[i][j];
          }
        }
        __syncthreads();
        // rows past P are zero-filled, so they add nothing
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const T uv = su[RM * tr + i];
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            hk[j] += acc[i][j] * acc[i][j];
            hw[j] += acc[i][j] * uv;
            acc[i][j] = T(0);
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < RN; ++j) {
      sHk[tr * W + RN * tc + j] = hk[j];
      sHw[tr * W + RN * tc + j] = hw[j];
    }
    __syncthreads();
    if (tid < nc) {
      T hks = T(0), hws = T(0);
      for (int g = 0; g < NR; ++g) {
        hks += sHk[g * W + tid];
        hws += sHw[g * W + tid];
      }
      const long long i = b * S + c0 + tid;
      const bool in = rmask[i] > T(0.5);
      T r = in ? kdiag[i] - hks : T(1);
      const bool okl = isfinite(r) && r > T(0);
      ok = ok && okl;
      if (!okl) r = T(1);
      if (in) ld_acc += log_(r);
      const T wx = w_r[i] - hws;
      qn_acc += wx * wx / r;
    }
    __syncthreads();  // sHk, su and the ring are reused by the next pass
  }

  // qc: wxc = w_r - prevH wpar, one warp per row of prevH (full warps)
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int kFullWarps = kDecThreads / 32;
  T qc_acc = T(0);
  const T* Hp = prevH + b * S * P;
  if (warp < kFullWarps) {
    for (int s = warp; s < S; s += kFullWarps) {
      const T* row = Hp + static_cast<long long>(s) * P;
      T acc = T(0);
      for (int p = lane; p < P; p += 32) acc += row[p] * wp[p];
      acc = warp_sum(acc);
      const long long i = b * S + s;
      const T wxc = w_r[i] - acc;
      qc_acc += prevprec[i] * wxc * wxc;
    }
  }
  sRed[tid] = ld_acc;
  sRed[kDecThreads + tid] = qn_acc;
  sRed[2 * kDecThreads + tid] = lane == 0 ? qc_acc : T(0);
  const bool all_ok = __syncthreads_and(ok);
  if (tid == 0) {  // in a fixed order: runs repeat bit for bit
    T ld = T(0), qn = T(0), qc = T(0);
    for (int g = 0; g < kDecThreads; ++g) {
      ld += sRed[g];
      qn += sRed[kDecThreads + g];
      qc += sRed[2 * kDecThreads + g];
    }
    part[b * 4 + 0] = T(-0.5) * ld;
    part[b * 4 + 1] = T(-0.5) * qn;
    part[b * 4 + 2] = T(-0.5) * qc;
    part[b * 4 + 3] = all_ok ? T(1) : T(0);
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
  const size_t smem = decision_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(
      thin_decision_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  thin_decision_kernel<T><<<static_cast<unsigned int>(B), kDecThreads, smem,
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
