// Fused thin-level kernels for the SpamTree sweeps: K3 (w-Gibbs) and K4
// (decision sweep), each instantiated for float and double.
//
// K3 replaces the Pallas TPU kernel
// spamtree_tpu/ops/pallas_level.py::thin_gibbs_level (_thin_gibbs_kernel).
// Per thin block b, with H (S, P) the stored conditional-mean operator:
//   hw  = H wpar ; sig = prec + ti
//   wu  = (prec hw + resid) / sig + z / sqrt(sig), 0 where rmask <= 0.5
//   msg = H' (prec (wu - hw))
// What bounds it on Hopper: bytes.  4 B S P flops for B S P elements of H,
// two (B, P) and seven (B, S) arrays (at bench config 3, B = 1024, S = 68,
// P = 293, f32: 82 MB of H, 0.026 ms at the H100 SXM's 3.35 TB/s; at config
// 5's four thin levels, P = 25, a quarter of the bytes are the vectors).
// Design: H is read from device memory once and held on chip between the two
// contractions; the threads follow the slab.  Three variants, chosen by the
// launcher from (S, P, type) alone (gibbs_variant):
// * flat (thin_gibbs_flat_kernel): P <= 32, S <= 128 and S P <= 1536.  One
//   warp per tree block, kFlatWarps tree blocks per thread block, the slab
//   in the warp's shared memory at row pitch P | 1 (no bank conflicts along
//   a column of lanes).  The warp copies the flattened slab by cp.async as
//   it lies in device memory, lane l elements l, l + 32, ...: every copy a
//   full 128-byte line, no lane idle on P < 32, no registers held, so six
//   thread blocks share an SM and all of an SM's slabs are in flight at
//   once.  Lane j makes hw[s], wu[s] and v[s] = prec (wu - hw) of rows j,
//   j + 32, ... in column order; lane p sums column p of H' v in row order.
// * rows (thin_gibbs_rows_kernel<WARPS, RPW, CPL>): S <= WARPS RPW and
//   P <= 32 CPL, capacities in GIBBS_ROWS_F32 / GIBBS_ROWS_F64 (the first
//   that holds the slab).  One thread block per tree block; warp w holds
//   rows w, w + WARPS, ... and lane l columns l, l + 32, ...: RPW x CPL
//   registers a thread (9 x 10 at config 3).  hw[s] is the row's products
//   summed per lane in column order, then a warp butterfly; lane r of the
//   warp makes wu and v of the warp's r-th row and broadcasts v by shuffle;
//   msg[p] is each thread's sum over its rows in row order, then the warps'
//   sums through shared memory in warp order.  The smaller capacity is
//   there because it measured faster on an H100 where both hold the slab:
//   in float 0.0099 ms against 0.0157 at (1024, 32, 128) and 0.0030 against
//   0.0039 at (16, 18, 69), bench config 1's thin level; in double 0.0157
//   against 0.0309 at (1024, 32, 128) (device time).
// * tiled (thin_gibbs_tiled_kernel): any S <= 512, P <= 1024 beyond those
//   capacities.  One thread block per tree block, pass 1 a warp per row
//   against wpar in shared memory, pass 2 a thread per column: it reads the
//   slab twice, the second time mostly from L2.  It is there for the
//   wrapper's contract (the TPU kernel's gate); no bench configuration has
//   a thin level beyond (72, 320).
// In the resident variants every load of H is issued before the first use
// and wpar and the five (B, S) vectors are staged coalesced by cp.async; in
// the rows variant all register indices are static (loops unrolled over the
// capacity, the ragged edge masked to 0).  Measured on an H100 at config 5's
// thin levels, the flat variant with the slab in registers (products staged
// through shared memory) took 1.6x the time of this one; at config 3's the
// rows variant with the slab in shared memory took 2.2x.  No atomics: every
// sum has an order fixed by (S, P), so runs repeat bit for bit.
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

constexpr int kThreads = 256;  // the tiled K3's block
constexpr int kWarps = kThreads / 32;
// K3's flat variant: tree blocks (warps) per thread block, thread blocks
// per SM the registers are capped for (half as many in double), and its
// gate (at most 158 KB of shared memory a thread block, in double)
constexpr int kFlatWarps = 8, kFlatBlocks = 6;
constexpr int kFlatMaxP = 32, kFlatMaxS = 128, kFlatMaxN = 1536;
// K3's rows variant: the resident capacities, smallest first; the launcher
// takes the first that holds (S, P).  Warps per tree block, rows per warp,
// columns per lane, thread blocks per SM the registers are capped for.
#define GIBBS_ROWS_F32(X) X(8, 4, 4, 4) X(8, 9, 10, 2)
#define GIBBS_ROWS_F64(X) X(8, 4, 4, 2) X(16, 5, 10, 1)

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// wu of one row and v = prec (wu - hw), from the row's staged vectors
template <typename T>
__device__ __forceinline__ T gibbs_row(T hw, T pr, T ti, T resid, T z,
                                       T rmask, T* wu_out) {
  const T sig = pr + ti;
  T wu = (pr * hw + resid) / sig + z / sqrt_(sig);
  if (!(rmask > T(0.5))) wu = T(0);
  *wu_out = wu;
  return pr * (wu - hw);
}

// K3, flat variant: one warp per tree block, its slab in shared memory
// (see the header).  vstride: shared-memory elements per warp.
template <typename T>
__global__ void __launch_bounds__(
    32 * kFlatWarps, sizeof(T) == 4 ? kFlatBlocks : kFlatBlocks / 2)
    thin_gibbs_flat_kernel(
    const T* __restrict__ H, const T* __restrict__ prec,
    const T* __restrict__ wpar, const T* __restrict__ z,
    const T* __restrict__ ti, const T* __restrict__ resid,
    const T* __restrict__ rmask, T* __restrict__ wu_out,
    T* __restrict__ msg_out, long long B, int S, int P, int vstride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = static_cast<long long>(blockIdx.x) * kFlatWarps + warp;
  if (b >= B) return;  // warps never meet at a block barrier
  const int PP = P | 1, n = S * P;
  T* sw = reinterpret_cast<T*>(smem_raw) + warp * vstride;  // 32: wpar
  T* svec = sw + 32;     // 5 x S: prec, ti, resid, z, rmask
  T* sv = svec + 5 * S;  // S: prec (wu - hw)
  T* sH = sv + S;        // S x PP: the slab

  cp_async(sw + lane, wpar + b * P + lane, lane < P);
  const T* const vecs[5] = {prec, ti, resid, z, rmask};
#pragma unroll
  for (int j = 0; j < 5; ++j)
    for (int s = lane; s < S; s += 32)
      cp_async(svec + j * S + s, vecs[j] + b * S + s, true);
  // the slab as it lies in device memory, 128 bytes a warp's copy; (s, p)
  // of element e = lane + 32 k is stepped without a division per element
  const T* Hb = H + b * n;
  const int q32 = 32 / P, r32 = 32 % P;
  int s = lane / P, p = lane - s * P;
  for (int e = lane; e < n; e += 32) {
    cp_async(sH + s * PP + p, Hb + e, true);
    s += q32;
    p += r32;
    if (p >= P) { p -= P; ++s; }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncwarp();
  for (int sb = 0; sb < S; sb += 32) {
    const int sr = sb + lane;
    if (sr < S) {
      T hw = T(0);
      for (int c = 0; c < P; ++c) hw += sH[sr * PP + c] * sw[c];
      sv[sr] = gibbs_row(hw, svec[sr], svec[S + sr], svec[2 * S + sr],
                         svec[3 * S + sr], svec[4 * S + sr],
                         wu_out + b * S + sr);
    }
  }
  __syncwarp();
  if (lane < P) {
    T m = T(0);
    for (int r = 0; r < S; ++r) m += sH[r * PP + lane] * sv[r];
    msg_out[b * P + lane] = m;
  }
}

// K3, rows variant: one thread block per tree block, rows over the warps
// and columns over the lanes (see the header)
template <typename T, int WARPS, int RPW, int CPL, int MINB>
__global__ void __launch_bounds__(32 * WARPS, MINB) thin_gibbs_rows_kernel(
    const T* __restrict__ H, const T* __restrict__ prec,
    const T* __restrict__ wpar, const T* __restrict__ z,
    const T* __restrict__ ti, const T* __restrict__ resid,
    const T* __restrict__ rmask, T* __restrict__ wu_out,
    T* __restrict__ msg_out, int S, int P) {
  static_assert(RPW <= 32, "lane r finishes the warp's r-th row");
  constexpr int NT = 32 * WARPS, PC = 32 * CPL, SC = WARPS * RPW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);  // PC: wpar, 0 past P
  T* svec = sw + PC;                       // 5 x SC: prec, ti, resid, z, rmask
  T* spart = svec + 5 * SC;                // WARPS x PC: the warps' column sums

  const long long b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int p = tid; p < PC; p += NT) cp_async(sw + p, wpar + b * P + p, p < P);
  const T* const vecs[5] = {prec, ti, resid, z, rmask};
#pragma unroll
  for (int j = 0; j < 5; ++j)
    for (int s = tid; s < S; s += NT)
      cp_async(svec + j * SC + s, vecs[j] + b * S + s, true);
  cp_async_commit();

  T h[RPW][CPL];  // H[warp + r WARPS, lane + 32 c]
  const T* Hb = H + b * S * P;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int s = warp + r * WARPS;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int p = lane + 32 * c;
      h[r][c] = (s < S && p < P) ? Hb[static_cast<long long>(s) * P + p] : T(0);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  T hw_mine = T(0);  // lane r: hw of row warp + r WARPS
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    T t = T(0);
#pragma unroll
    for (int c = 0; c < CPL; ++c) t += h[r][c] * sw[lane + 32 * c];
    t = warp_sum(t);
    if (lane == r) hw_mine = t;
  }
  T v_mine = T(0);
  const int s_mine = warp + lane * WARPS;
  if (lane < RPW && s_mine < S)
    v_mine = gibbs_row(hw_mine, svec[s_mine], svec[SC + s_mine],
                       svec[2 * SC + s_mine], svec[3 * SC + s_mine],
                       svec[4 * SC + s_mine], wu_out + b * S + s_mine);

  T acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = T(0);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const T v = __shfl_sync(0xffffffffu, v_mine, r);
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] += h[r][c] * v;
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) spart[warp * PC + lane + 32 * c] = acc[c];
  __syncthreads();
  for (int p = tid; p < P; p += NT) {
    T m = T(0);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m += spart[w * PC + p];
    msg_out[b * P + p] = m;
  }
}

// K3, tiled variant: reads the slab twice (see the header)
template <typename T>
__global__ void __launch_bounds__(kThreads) thin_gibbs_tiled_kernel(
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
      // gibbs_row's arithmetic, written out: with the five values loaded
      // as its arguments this variant measured 10 % slower on an H100
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

// K3's arguments as the C entry points take them
template <typename T>
struct GibbsArgs {
  const T *H, *prec, *wpar, *z, *ti, *resid, *rmask;
  T *wu, *msg;
  long long B;
  int S, P;
  cudaStream_t stream;
};

// Dynamic shared memory above 48 KB has to be asked for: once per kernel
// and device, and again only for more than the most asked for so far (the
// attribute is the device's; a race between host threads sets it twice).
constexpr int kMaxDevices = 64;

template <auto Kernel>
cudaError_t allow_smem(size_t smem) {
  static size_t allowed[kMaxDevices];  // 0: the 48 KB every kernel may take
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return err;
}

// Which K3 variant serves (S, P): 0 tiled, 1 flat, 10000 WARPS + 100 RPW +
// CPL rows.  A pure function of (S, P, T).
template <typename T>
int gibbs_variant(int S, int P) {
  if (P <= kFlatMaxP && S <= kFlatMaxS && S * P <= kFlatMaxN) return 1;
#define X(W_, R_, C_, M_) \
  if (S <= W_ * R_ && P <= 32 * C_) return 10000 * W_ + 100 * R_ + C_;
  if constexpr (sizeof(T) == 4) {
    GIBBS_ROWS_F32(X)
  } else {
    GIBBS_ROWS_F64(X)
  }
#undef X
  return 0;
}

template <typename T>
int launch_gibbs_flat(const GibbsArgs<T>& a) {
  const int vstride = 32 + 6 * a.S + a.S * (a.P | 1);
  const size_t smem = sizeof(T) * kFlatWarps * vstride;
  cudaError_t err = allow_smem<thin_gibbs_flat_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int grid =
      static_cast<unsigned int>((a.B + kFlatWarps - 1) / kFlatWarps);
  thin_gibbs_flat_kernel<T><<<grid, 32 * kFlatWarps, smem, a.stream>>>(
      a.H, a.prec, a.wpar, a.z, a.ti, a.resid, a.rmask, a.wu, a.msg, a.B, a.S,
      a.P, vstride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int WARPS, int RPW, int CPL, int MINB>
int launch_gibbs_rows(const GibbsArgs<T>& a) {
  const size_t smem =
      sizeof(T) * (32 * CPL + 5 * WARPS * RPW + WARPS * 32 * CPL);
  cudaError_t err =
      allow_smem<thin_gibbs_rows_kernel<T, WARPS, RPW, CPL, MINB>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  thin_gibbs_rows_kernel<T, WARPS, RPW, CPL, MINB>
      <<<static_cast<unsigned int>(a.B), 32 * WARPS, smem, a.stream>>>(
          a.H, a.prec, a.wpar, a.z, a.ti, a.resid, a.rmask, a.wu, a.msg, a.S,
          a.P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gibbs(const void* H, const void* prec, const void* wpar,
                 const void* z, const void* ti, const void* resid,
                 const void* rmask, void* wu, void* msg, long long B, int S,
                 int P, void* stream) {
  const GibbsArgs<T> a{
      static_cast<const T*>(H),     static_cast<const T*>(prec),
      static_cast<const T*>(wpar),  static_cast<const T*>(z),
      static_cast<const T*>(ti),    static_cast<const T*>(resid),
      static_cast<const T*>(rmask), static_cast<T*>(wu),
      static_cast<T*>(msg),         B, S, P,
      static_cast<cudaStream_t>(stream)};
  const int var = gibbs_variant<T>(S, P);
  if (var == 1) return launch_gibbs_flat<T>(a);
#define X(W_, R_, C_, M_)                     \
  if (var == 10000 * W_ + 100 * R_ + C_)      \
    return launch_gibbs_rows<T, W_, R_, C_, M_>(a);
  if constexpr (sizeof(T) == 4) {
    GIBBS_ROWS_F32(X)
  } else {
    GIBBS_ROWS_F64(X)
  }
#undef X
  const size_t smem = sizeof(T) * (static_cast<size_t>(P) + S);
  thin_gibbs_tiled_kernel<T><<<static_cast<unsigned int>(B), kThreads, smem,
                               a.stream>>>(a.H, a.prec, a.wpar, a.z, a.ti,
                                           a.resid, a.rmask, a.wu, a.msg, S, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_decision(const void* Kxc, const void* joint, const void* lp_pos,
                    const void* wpar, const void* w_r, const void* prevH,
                    const void* prevprec, const void* kdiag, const void* rmask,
                    void* part, long long B, int S, int P, void* stream) {
  const size_t smem = decision_smem<T>();
  cudaError_t err = allow_smem<thin_decision_kernel<T>>(smem);
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

// which K3 variant the launcher takes at (S, P): see gibbs_variant
extern "C" int st_thin_gibbs_variant_f32(int S, int P) {
  return gibbs_variant<float>(S, P);
}

extern "C" int st_thin_gibbs_variant_f64(int S, int P) {
  return gibbs_variant<double>(S, P);
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
