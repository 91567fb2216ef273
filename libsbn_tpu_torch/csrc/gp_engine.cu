// Generalized-pruning kernels for NVIDIA Hopper (sm_90a), the GP engine's
// two hot loops (libsbn_tpu_torch/gp/engine_kernels.py):
//   K7 gp_populate_kernel:     the whole PLV population pass over the subsplit
//                              DAG, from two host-built edge streams, with a
//                              tile of patterns' PLVs in shared memory
//                              (gp_populate_slab_kernel, its first design over
//                              device-memory PLVs, for DAGs beyond the plan);
//   K8 gp_golden_sweep_kernel: a fixed golden-section search of every edge's
//                              log branch length against its JC69 objective,
//                              a block per edge over rows staged in shared
//                              memory (gp_golden_sweep_slab_kernel, its first
//                              design, a warp per edge over device-memory
//                              rows, for rows beyond the plan).
//
// Built by libsbn_tpu_torch/ops/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// (never --use_fast_math: exp(NEG - m) must underflow to exactly 0, and the
// log-scales are compared across routes) into a shared library with a plain
// C interface, bound with ctypes. Each entry point launches on the caller's
// stream, allocates nothing, and returns a CUDA error code (0 on success).
//
// Layout (row-major, patterns innermost so that a warp's accesses to one row
// are coalesced):
//   rootward  (T_rw, 5) int32  dest row in PH, src node, gpcsp, finish flag, node
//   leafward  (T_lw, 5) int32  dest node in rhat, src row in RB, gpcsp, finish
//                              flag, node
//   roots     (R, 2) int32     rootsplit node, its gpcsp
//   q         (E,)             SBN parameters per GPCSP
//   P         (E, 4, 4)        JC69 transition matrices (exp taken in f64)
//   tips      (L, 4, S)        tip partials
//   p, rhat   (N, 4, S)        outputs; lsp, lsrhat (N, S) their log-scales
//   PH, RB    (2N, 4, S)       outputs [phat; phattilde] and [r; rtilde];
//                              lsPH, lsRB (2N, S)
//   A, B      (E, S)           K8: per-edge rows of r P(b) p = A + e^{-4b/3} B
//   w         (S,)             pattern weights
//   cur, out  (E,)             K8: current and new log branch lengths
//
// The arithmetic follows libsbn_tpu/gp/engine_pallas.py; the plain PyTorch
// twins (populate_plvs_twin, golden_sweep_twin) repeat its order.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxShared = 232448;  // bytes a block may use on sm_90
constexpr double kNeg = -1e30;         // log-scale of an empty accumulator
constexpr int kGoldenIters = 70;       // GOLDEN_ITERS
constexpr double kMinLogBl = -13.9;    // MIN_LOG_BL
constexpr double kMaxLogBl = 1.1;      // MAX_LOG_BL
constexpr double kInvPhi = 0.6180339887498949;  // (sqrt(5) - 1) / 2

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
// A product that is never contracted into an FMA, so K8's bracket and
// objective round as the twin's separate tensor ops do.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// One element copied from device memory to shared memory without passing
// through registers (cp.async, cache-all; kBytes is 4 or 8), and the wait for
// all of this thread's copies.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst_shared, const void* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src),
               "n"(kBytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // Butterfly: every lane ends with the same, order-fixed sum.
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// ---------------------------------------------------------------------------
// K7's slab route: its first design, kept for DAGs whose on-chip plan
// (gp_populate_kernel below) cannot hold one pattern; gp/engine_kernels.py
// chooses it from the plan and counts it as "populate_plvs_slab".
//
// Every pattern's recursion is independent (the finish max is over the 4
// states of one pattern), so one thread owns one pattern column of every
// PLV and walks the three streams in order; no thread reads another's data
// and there is no barrier after staging. The stream rows, q and P are the
// same for every thread: the block stages them in shared memory when they
// fit (reads are then broadcasts), else reads them from device memory.
// Bound on this card: the dependent chain of the T_rw + R + T_lw sequential
// steps (each reads its source column and its destination's accumulator,
// written a few steps earlier, then writes it back), not bandwidth; with
// few patterns (fluA: 238) the grid is two blocks and most SMs are idle.
// ---------------------------------------------------------------------------

// One thread's pattern column of a (rows, 4, S) PLV slab and of its
// (rows, S) log-scales.
template <typename T>
struct Column {
  T* v;
  T* ls;
  size_t S;
  __device__ T& at(int row, int i) const { return v[(size_t(row) * 4 + i) * S]; }
  __device__ T& scale(int row) const { return ls[size_t(row) * S]; }
};

template <typename T>
struct Vec4 {
  T x[4];
};

template <typename T>
__device__ __forceinline__ Vec4<T> load4(const Column<T>& c, int row) {
  Vec4<T> r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.x[i] = c.at(row, i);
  return r;
}

// q_g * P_g v.
template <typename T>
__device__ __forceinline__ Vec4<T> evolve(const T* P, T q, const Vec4<T>& v) {
  Vec4<T> r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T* row = P + 4 * i;
    r.x[i] = q * (row[0] * v.x[0] + row[1] * v.x[1] + row[2] * v.x[2] + row[3] * v.x[3]);
  }
  return r;
}

// buf[row] += contrib at log-scale ls_c, max-aligned (both exponents <= 0).
template <typename T>
__device__ __forceinline__ void accumulate(const Column<T>& buf, int row, const Vec4<T>& contrib,
                                           T ls_c) {
  const T ls_cur = buf.scale(row);
  const T m = ls_cur > ls_c ? ls_cur : ls_c;
  const T f_cur = exp_t(ls_cur - m);
  const T f_c = exp_t(ls_c - m);
#pragma unroll
  for (int i = 0; i < 4; ++i) buf.at(row, i) = buf.at(row, i) * f_cur + contrib.x[i] * f_c;
  buf.scale(row) = m;
}

// dst[row] = prod / max over states (1 where that max is not > 0); the
// log-scale absorbs the max.
template <typename T>
__device__ __forceinline__ void finish(const Column<T>& dst, int row, const Vec4<T>& prod,
                                       T ls_sum) {
  T scale = prod.x[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) scale = prod.x[i] > scale ? prod.x[i] : scale;
  scale = scale > T(0) ? scale : T(1);
#pragma unroll
  for (int i = 0; i < 4; ++i) dst.at(row, i) = prod.x[i] / scale;
  dst.scale(row) = ls_sum + log_t(scale);
}

template <typename T>
__device__ __forceinline__ Vec4<T> times(const Vec4<T>& a, const Vec4<T>& b) {
  Vec4<T> r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.x[i] = a.x[i] * b.x[i];
  return r;
}

// r = rhat * phattilde into RB row node, rtilde = rhat * phat into row node + N.
template <typename T>
__device__ __forceinline__ void finish_r(const Column<T>& rhat, const Column<T>& PH,
                                         const Column<T>& RB, int node, int N) {
  const Vec4<T> rh = load4(rhat, node);
  const T ls_rh = rhat.scale(node);
  finish(RB, node, times(rh, load4(PH, node + N)), ls_rh + PH.scale(node + N));
  finish(RB, node + N, times(rh, load4(PH, node)), ls_rh + PH.scale(node));
}

template <typename T>
__host__ __device__ size_t populate_shared_bytes(int n_rw, int n_lw, int n_roots, int E) {
  return sizeof(T) * 17 * size_t(E) + sizeof(int) * (5 * size_t(n_rw) + 5 * size_t(n_lw) +
                                                     2 * size_t(n_roots));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gp_populate_slab_kernel(const int* __restrict__ rw_g, const int* __restrict__ lw_g,
                   const int* __restrict__ roots_g, const T* __restrict__ q_g,
                   const T* __restrict__ P_g, const T* __restrict__ tips, T* __restrict__ p,
                   T* __restrict__ PH, T* __restrict__ rhat, T* __restrict__ RB,
                   T* __restrict__ lsp, T* __restrict__ lsPH, T* __restrict__ lsrhat,
                   T* __restrict__ lsRB, int n_rw, int n_lw, int n_roots, int E, int N, int L,
                   int S, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T* q = q_g;
  const T* Pm = P_g;
  const int* rw = rw_g;
  const int* lw = lw_g;
  const int* roots = roots_g;
  if (staged) {  // uniform over the block
    T* sq = reinterpret_cast<T*>(smem);
    T* sP = sq + E;
    int* srw = reinterpret_cast<int*>(sP + 16 * size_t(E));
    int* slw = srw + 5 * n_rw;
    int* sroots = slw + 5 * n_lw;
    for (int i = threadIdx.x; i < E; i += kThreads) sq[i] = q_g[i];
    for (int i = threadIdx.x; i < 16 * E; i += kThreads) sP[i] = P_g[i];
    for (int i = threadIdx.x; i < 5 * n_rw; i += kThreads) srw[i] = rw_g[i];
    for (int i = threadIdx.x; i < 5 * n_lw; i += kThreads) slw[i] = lw_g[i];
    for (int i = threadIdx.x; i < 2 * n_roots; i += kThreads) sroots[i] = roots_g[i];
    __syncthreads();
    q = sq;
    Pm = sP;
    rw = srw;
    lw = slw;
    roots = sroots;
  }
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;  // the ragged last tile: masked, not padded
  const size_t SS = size_t(S);
  const Column<T> cp{p + s, lsp + s, SS};
  const Column<T> cPH{PH + s, lsPH + s, SS};
  const Column<T> crhat{rhat + s, lsrhat + s, SS};
  const Column<T> cRB{RB + s, lsRB + s, SS};

  // Leaves hold the tip partials at scale 0; every accumulator is empty.
  for (int row = 0; row < N; ++row) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cp.at(row, i) = row < L ? tips[(size_t(row) * 4 + i) * SS + s] : T(0);
      crhat.at(row, i) = T(0);
    }
    cp.scale(row) = T(0);
    crhat.scale(row) = T(kNeg);
  }
  for (int row = 0; row < 2 * N; ++row) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cPH.at(row, i) = T(0);
      cRB.at(row, i) = T(0);
    }
    cPH.scale(row) = T(kNeg);
    cRB.scale(row) = T(0);
  }

  // Rootward: PH[dest] += q_g P_g p[src]; p[node] = phat * phattilde on the
  // node's last in-edge.
  for (int t = 0; t < n_rw; ++t) {
    const int* r = rw + 5 * t;
    const int dest = r[0], src = r[1], g = r[2], fin = r[3], node = r[4];
    accumulate(cPH, dest, evolve(Pm + 16 * g, q[g], load4(cp, src)), cp.scale(src));
    if (fin) {
      finish(cp, node, times(load4(cPH, node), load4(cPH, node + N)),
             cPH.scale(node) + cPH.scale(node + N));
    }
  }
  // Rootsplit seeds: rhat = q / 4 (the stationary distribution times q).
  for (int i = 0; i < n_roots; ++i) {
    const int node = roots[2 * i], g = roots[2 * i + 1];
#pragma unroll
    for (int k = 0; k < 4; ++k) crhat.at(node, k) = T(0.25) * q[g];
    crhat.scale(node) = T(0);
    finish_r(crhat, cPH, cRB, node, N);
  }
  // Leafward: rhat[dest] += q_g P_g RB[src]; r and rtilde on the last in-edge.
  for (int t = 0; t < n_lw; ++t) {
    const int* r = lw + 5 * t;
    const int dest = r[0], src = r[1], g = r[2], fin = r[3];
    accumulate(crhat, dest, evolve(Pm + 16 * g, q[g], load4(cRB, src)), cRB.scale(src));
    if (fin) finish_r(crhat, cPH, cRB, dest, N);
  }
}

// ---------------------------------------------------------------------------
// K7: GP PLV population. Replaces the TPU kernel
// libsbn_tpu/gp/engine_pallas.py::_kernel (pallas_call in _populate_pallas),
// which kept a pattern tile's PLVs in VMEM scratch.
// Bound on this card: the dependent chain of the population program; bytes
// and operations are tiny (about 1 us of either at fluA). The slab route
// above gave each thread one pattern with the PLVs in device memory, so each
// of the T_rw + R + T_lw steps (fluA: 136 + 1 + 136) waited on L2 round
// trips, and fluA's 238 patterns made 2 blocks on 132 SMs.
// Design. A block owns a tile of TP <= 8 consecutive patterns, and each of
// its kPopulateWarps warps covers the tile with a lane per (pattern,
// state): lane l works on state l % 4 of pattern l / 4 (lanes past 4 TP
// idle). The tile's whole PLV state lives in shared memory, [row][state]
// [pattern] for the values and [row][pattern] for the log-scales (p, PH,
// rhat and RB: 30 N values a pattern), beside q, P, the three streams and
// their level and group offsets, all staged once with cp.async (the tips
// too); nothing on the chain touches device memory, and the block writes
// its tile of the 8 outputs once at the end. The streams come in levels
// (subsplit_dag.level_schedules): a level's sources were finished at
// earlier levels, and its rows fall into groups, one per destination (a
// node's in-edges, rootward; a node's, leafward), each ending at its
// finish flag. The warps share a level's groups (group g to warp g % W),
// each warp walking its groups' rows in stream order, with a block barrier
// between levels; so each destination sees the same operations in the
// same order as in the serial stream and the twin, and the chain is the
// levels' longest group runs (fluA: 33 + 33 levels) rather than 273 steps.
// Within a warp a step is a few shared-memory loads (the source's 4 states
// are broadcasts to its pattern's 4 lanes, and a row access touches 32
// consecutive words), two exps and a few FMAs, the next step's stream row
// and q_g P_g row read ahead; two __syncwarp a step order its reads before
// its writes and its writes before the next step's reads. The finish max
// over a pattern's 4 states is two __shfl_xor steps within its 4 lanes (a
// max is exact, so the order of comparison does not change it); every lane
// of a pattern computes its log-scale and state 0 stores it. The plan
// (gp/engine_kernels.py populate_onchip_plan) takes the largest TP <= 8
// whose state fits: 8 for fluA at float (148 KB, one block an SM: 30 blocks
// where the slab route had 2), 6 at double; a DAG where one pattern does
// not fit takes the slab route. Measured on fluA at float: 0.094-0.114 ms,
// against 0.28 ms for a first on-chip design with one warp a tile walking
// the serial stream, and 0.48-0.51 ms for the slab route, in one run
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md); about 1.2% of the bound, the
// rest is the chain's latency with one block an SM.
// ---------------------------------------------------------------------------

constexpr int kPopulateWarps = 8;  // warps a block of the on-chip K7

// Bytes of shared memory gp_populate_kernel takes for a tile of TP patterns;
// gp/engine_kernels.py populate_onchip_bytes computes the same sum. The
// group and level offsets of a stream of n rows take at most 2 (n + 1)
// int32: the plan reserves that, so that it follows from the shapes alone.
template <typename T>
__host__ __device__ size_t populate_onchip_bytes(int n_rw, int n_lw, int n_roots, int E, int N,
                                                 int TP) {
  return sizeof(T) * (30 * size_t(N) * TP + 17 * size_t(E)) +
         sizeof(int) * (7 * size_t(n_rw) + 7 * size_t(n_lw) + 2 * size_t(n_roots) + 4);
}

// One stream step as a lane needs it: the row's indices and the lane's row
// i of q_g and P_g.
template <typename T>
struct StreamStep {
  int dest, src, fin, node;
  T q, m0, m1, m2, m3;
};

template <typename T>
__device__ __forceinline__ StreamStep<T> read_step(const int* rows, const T* q, const T* P, int t,
                                                   int i) {
  const int* r = rows + 5 * t;
  const int g = r[2];
  const T* m = P + 16 * g + 4 * i;
  return StreamStep<T>{r[0], r[1], r[3], r[4], q[g], m[0], m[1], m[2], m[3]};
}

// out (R, S) <- the tile's (R, TP) block of shared memory, patterns
// s0 .. s0 + TP - 1 less the ragged edge.
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ out, const T* v, int R, int TP, int s0,
                                           int S) {
  for (int k = threadIdx.x; k < R * TP; k += blockDim.x) {
    const int r = k / TP, c = k - r * TP;
    if (s0 + c < S) out[size_t(r) * S + s0 + c] = v[k];
  }
}

// n int32 or T values from device memory to shared memory with cp.async.
template <typename X>
__device__ __forceinline__ void stage(X* dst, const X* src, size_t n) {
  for (size_t k = threadIdx.x; k < n; k += blockDim.x) cp_async<sizeof(X)>(dst + k, src + k);
}

template <typename T>
__global__ void __launch_bounds__(32 * kPopulateWarps)
gp_populate_kernel(const int* __restrict__ rw_g, const int* __restrict__ lw_g,
                   const int* __restrict__ roots_g, const int* __restrict__ rw_grp_g,
                   const int* __restrict__ rw_lev_g, const int* __restrict__ lw_grp_g,
                   const int* __restrict__ lw_lev_g, const T* __restrict__ q_g,
                   const T* __restrict__ P_g, const T* __restrict__ tips, T* __restrict__ p,
                   T* __restrict__ PH, T* __restrict__ rhat, T* __restrict__ RB,
                   T* __restrict__ lsp, T* __restrict__ lsPH, T* __restrict__ lsrhat,
                   T* __restrict__ lsRB, int n_rw, int n_lw, int n_roots, int g_rw, int v_rw,
                   int g_lw, int v_lw, int E, int N, int L, int S, int TP) {
  constexpr int W = kPopulateWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool used = (lane >> 2) < TP;
  const int i = lane & 3;                // the lane's state
  const int pl = used ? lane >> 2 : 0;   // and its pattern in the tile
  const int s0 = blockIdx.x * TP;
  // A lane past the last pattern works on zeros and stores nothing; an idle
  // lane (past 4 TP) reads pattern 0's values and stores nothing.
  const bool active = used && s0 + pl < S;
  const int RS = 4 * TP;          // values a PLV row holds
  const int col = i * TP + pl;    // the lane's value in a row
  // Carve shared memory in populate_onchip_bytes' order: P first, so that
  // its rows are 16-byte aligned.
  T* sP = reinterpret_cast<T*>(smem);
  T* sq = sP + 16 * size_t(E);
  T* vp = sq + E;                     // p: N rows
  T* vPH = vp + size_t(N) * RS;       // [phat; phattilde]: 2N rows
  T* vrh = vPH + size_t(2 * N) * RS;  // rhat: N rows
  T* vRB = vrh + size_t(N) * RS;      // [r; rtilde]: 2N rows
  T* lp = vRB + size_t(2 * N) * RS;   // their log-scales, TP a row
  T* lPH = lp + size_t(N) * TP;
  T* lrh = lPH + size_t(2 * N) * TP;
  T* lRB = lrh + size_t(N) * TP;
  int* srw = reinterpret_cast<int*>(lRB + size_t(2 * N) * TP);
  int* slw = srw + 5 * n_rw;
  int* sroots = slw + 5 * n_lw;
  int* rw_grp = sroots + 2 * n_roots;  // g_rw + 1 row offsets
  int* rw_lev = rw_grp + g_rw + 1;     // v_rw + 1 group offsets
  int* lw_grp = rw_lev + v_rw + 1;
  int* lw_lev = lw_grp + g_lw + 1;
  stage(sP, P_g, 16 * size_t(E));
  stage(sq, q_g, size_t(E));
  stage(srw, rw_g, 5 * size_t(n_rw));
  stage(slw, lw_g, 5 * size_t(n_lw));
  stage(sroots, roots_g, 2 * size_t(n_roots));
  stage(rw_grp, rw_grp_g, size_t(g_rw) + 1);
  stage(rw_lev, rw_lev_g, size_t(v_rw) + 1);
  stage(lw_grp, lw_grp_g, size_t(g_lw) + 1);
  stage(lw_lev, lw_lev_g, size_t(v_lw) + 1);
  // Leaves hold the tip partials at scale 0; every accumulator is empty.
  const size_t SS = size_t(S);
  if (used) {
    for (int row = warp; row < N; row += W) {
      T* x = vp + row * RS + col;
      if (row < L && active) {
        cp_async<sizeof(T)>(x, tips + (size_t(row) * 4 + i) * SS + s0 + pl);
      } else {
        *x = T(0);
      }
      vrh[row * RS + col] = T(0);
      if (i == 0) {
        lp[row * TP + pl] = T(0);
        lrh[row * TP + pl] = T(kNeg);
      }
    }
    for (int row = warp; row < 2 * N; row += W) {
      vPH[row * RS + col] = T(0);
      vRB[row * RS + col] = T(0);
      if (i == 0) {
        lPH[row * TP + pl] = T(kNeg);
        lRB[row * TP + pl] = T(0);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // q_g P_g src for the lane's state i, in the slab route's order.
  auto evolve = [&](const StreamStep<T>& st, const T* v) {
    const T* x = v + st.src * RS + pl;
    return st.q * (st.m0 * x[0] + st.m1 * x[TP] + st.m2 * x[2 * TP] + st.m3 * x[3 * TP]);
  };
  // v[row] += contrib at log-scale ls_c, max-aligned (both exponents <= 0):
  // every lane reads the row's scale before the warp syncs, state 0 stores
  // the new one after.
  auto accumulate = [&](T* v, T* ls, int row, T contrib, T ls_c) {
    const T cur = v[row * RS + col];
    const T ls_cur = ls[row * TP + pl];
    const T m = ls_cur > ls_c ? ls_cur : ls_c;
    const T f_cur = exp_t(ls_cur - m);
    const T f_c = exp_t(ls_c - m);
    __syncwarp();
    if (used) {
      v[row * RS + col] = cur * f_cur + contrib * f_c;
      if (i == 0) ls[row * TP + pl] = m;
    }
    __syncwarp();
  };
  // v[row] = prod / max over the pattern's 4 states (1 where that max is
  // not > 0); the log-scale absorbs the max.
  auto finish = [&](T* v, T* ls, int row, T prod, T ls_sum) {
    T scale = prod;
    const T x1 = __shfl_xor_sync(0xffffffffu, scale, 1);
    scale = x1 > scale ? x1 : scale;
    const T x2 = __shfl_xor_sync(0xffffffffu, scale, 2);
    scale = x2 > scale ? x2 : scale;
    scale = scale > T(0) ? scale : T(1);
    if (used) {
      v[row * RS + col] = prod / scale;
      if (i == 0) ls[row * TP + pl] = ls_sum + log_t(scale);
    }
  };
  // r = rhat * phattilde into RB row node, rtilde = rhat * phat into row
  // node + N.
  auto finish_r = [&](int node) {
    const T rh = vrh[node * RS + col];
    const T ls_rh = lrh[node * TP + pl];
    finish(vRB, lRB, node, rh * vPH[(node + N) * RS + col], ls_rh + lPH[(node + N) * TP + pl]);
    finish(vRB, lRB, node + N, rh * vPH[node * RS + col], ls_rh + lPH[node * TP + pl]);
  };
  // A stream level by level: the warps share each level's destination
  // groups, each walking its groups' rows in order; then the block syncs.
  auto walk = [&](const int* rows, const int* grp, const int* lev, int n_lev, auto&& step) {
    for (int v = 0; v < n_lev; ++v) {
      for (int g = lev[v] + warp; g < lev[v + 1]; g += W) {
        const int t1 = grp[g + 1];
        StreamStep<T> next = read_step(rows, sq, sP, grp[g], i);
        for (int t = grp[g]; t < t1; ++t) {
          const StreamStep<T> st = next;
          if (t + 1 < t1) next = read_step(rows, sq, sP, t + 1, i);
          step(st);
        }
      }
      __syncthreads();
    }
  };

  // Rootward: PH[dest] += q_g P_g p[src]; p[node] = phat * phattilde on the
  // node's last in-edge.
  walk(srw, rw_grp, rw_lev, v_rw, [&](const StreamStep<T>& st) {
    accumulate(vPH, lPH, st.dest, evolve(st, vp), lp[st.src * TP + pl]);
    if (st.fin) {
      const int a = st.node, b = st.node + N;
      finish(vp, lp, a, vPH[a * RS + col] * vPH[b * RS + col],
             lPH[a * TP + pl] + lPH[b * TP + pl]);
      __syncwarp();
    }
  });
  // Rootsplit seeds: rhat = q / 4 (the stationary distribution times q).
  for (int r = warp; r < n_roots; r += W) {
    const int node = sroots[2 * r], g = sroots[2 * r + 1];
    if (used) {
      vrh[node * RS + col] = T(0.25) * sq[g];
      if (i == 0) lrh[node * TP + pl] = T(0);
    }
    __syncwarp();
    finish_r(node);
    __syncwarp();
  }
  __syncthreads();
  // Leafward: rhat[dest] += q_g P_g RB[src]; r and rtilde on the last
  // in-edge.
  walk(slw, lw_grp, lw_lev, v_lw, [&](const StreamStep<T>& st) {
    accumulate(vrh, lrh, st.dest, evolve(st, vRB), lRB[st.src * TP + pl]);
    if (st.fin) {
      finish_r(st.dest);
      __syncwarp();
    }
  });

  store_tile(p, vp, 4 * N, TP, s0, S);
  store_tile(PH, vPH, 8 * N, TP, s0, S);
  store_tile(rhat, vrh, 4 * N, TP, s0, S);
  store_tile(RB, vRB, 8 * N, TP, s0, S);
  store_tile(lsp, lp, N, TP, s0, S);
  store_tile(lsPH, lPH, 2 * N, TP, s0, S);
  store_tile(lsrhat, lrh, N, TP, s0, S);
  store_tile(lsRB, lRB, 2 * N, TP, s0, S);
}

// ---------------------------------------------------------------------------
// K8: golden-section branch sweep. Replaces the TPU kernel
// libsbn_tpu/gp/engine_pallas.py::_sweep_kernel (pallas_call in
// _optimize_pallas): per edge, f(cur), then GOLDEN_ITERS iterations each
// evaluating f at both interior points c and d, of
// f(lb) = -sum_s w log(A + exp(-4/3 e^lb) B); the better of c and d unless
// it is worse than f(cur).
//
// Bound on this card: the chain of 1 + 1 + GOLDEN_ITERS dependent steps per
// edge (each step's bracket depends on the last step's fc < fd), not the
// bytes (A and B are read once: about 0.35 us of traffic at fluA f32).
//
// gp_golden_sweep_kernel, the main design: one block per edge, of
// kSweepWarps warps (gp/engine_kernels.py SWEEP_WARPS), so that fluA's 137
// edges give about one block on each SM.
// The block stages its edge's A and B rows and w into shared memory once
// with cp.async (fluA f32: 2.9 KB), and its threads stride the patterns (8
// warps at 238 patterns: one each). Each step evaluates two points
// together: every thread takes the two scalars e(x), e(y), forms its
// partial sums for f(x) and f(y) side by side (two independent log
// chains), each warp reduces both by one interleaved butterfly and writes
// its two sums to shared memory, and after one __syncthreads every thread
// adds the block's warp sums in warp order. So every thread holds the
// same f(c) and f(d) and takes the same branch, there are no atomics,
// and the result repeats exactly from launch to launch. The warp sums
// alternate between two buffers from step to step:
// a warp can only write a buffer again after the next barrier, which every
// warp reaches only when it has read that buffer. The steps are f(cur)
// (paired with itself, so that every step is the same code: one redundant
// log chain in 72 steps), (f(c), f(d)) of the first bracket, and one pair
// per iteration: the reference's sequence of points, with neither evaluation
// reused (the new c is not bit-equal to the old d). The rows need 3 S values
// of shared memory (golden_sweep_bytes); gp/engine_kernels.py
// golden_sweep_plan refuses more than that, and such edges take the slab
// route below.
//
// gp_golden_sweep_slab_kernel, the first design, kept as the route beyond
// the plan (counted as "golden_sweep_slab"): one warp per edge, lanes
// striding the patterns, each objective a butterfly warp sum over A and B
// read from L1/L2 at every evaluation, the evaluations one after another.
// At fluA that is 35 blocks of 4 warps, one warp on each of 35 SMs, through
// 143 evaluations of about 1,500 cycles each.
// ---------------------------------------------------------------------------
constexpr int kSweepWarps = 8;  // warps a block of the main K8, one edge a block

// Bytes of shared memory the main K8 takes for rows of S patterns: A, B and
// w, then two buffers of kSweepWarps pairs of warp sums.
// gp/engine_kernels.py golden_sweep_bytes computes the same sum.
template <typename T>
__host__ __device__ size_t golden_sweep_bytes(int S) {
  return sizeof(T) * (3 * size_t(S) + 2 * 2 * kSweepWarps);
}

template <typename T>
__global__ void __launch_bounds__(32 * kSweepWarps)
gp_golden_sweep_kernel(const T* __restrict__ A, const T* __restrict__ B,
                       const T* __restrict__ w, const T* __restrict__ cur_log_bl,
                       T* __restrict__ out, int S) {
  constexpr int nt = 32 * kSweepWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  // Carve shared memory in golden_sweep_bytes' order and stage the rows.
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + S;
  T* sw = sB + S;
  T* sums = sw + S;  // [2][kSweepWarps][2]
  const int edge = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* a_row = A + size_t(edge) * S;
  const T* b_row = B + size_t(edge) * S;
  for (int s = tid; s < S; s += nt) {
    cp_async<sizeof(T)>(sA + s, a_row + s);
    cp_async<sizeof(T)>(sB + s, b_row + s);
    cp_async<sizeof(T)>(sw + s, w + s);
  }
  cp_async_wait_all();
  __syncthreads();

  int buf = 0;
  // (f(x), f(y)) for two log branch lengths, the same in every thread.
  auto objective2 = [&](T x, T y, T& fx, T& fy) {
    const T ex = exp_t(mul_rn(T(-4.0 / 3.0), exp_t(x)));
    const T ey = exp_t(mul_rn(T(-4.0 / 3.0), exp_t(y)));
    T px = T(0), py = T(0);
    for (int s = tid; s < S; s += nt) {
      const T a = sA[s], b = sB[s], ws = sw[s];
      px += mul_rn(log_t(a + mul_rn(ex, b)), ws);
      py += mul_rn(log_t(a + mul_rn(ey, b)), ws);
    }
    for (int off = 16; off > 0; off >>= 1) {
      px += __shfl_xor_sync(0xffffffffu, px, off);
      py += __shfl_xor_sync(0xffffffffu, py, off);
    }
    T* slot = sums + buf * 2 * kSweepWarps;
    if (lane == 0) {
      slot[2 * warp] = px;
      slot[2 * warp + 1] = py;
    }
    __syncthreads();
    T sx = slot[0], sy = slot[1];
#pragma unroll
    for (int v = 1; v < kSweepWarps; ++v) {
      sx += slot[2 * v];
      sy += slot[2 * v + 1];
    }
    buf ^= 1;
    fx = -sx;
    fy = -sy;
  };

  const T cur = cur_log_bl[edge];
  T fcur, fc, fd;
  objective2(cur, cur, fcur, fc);
  const T invphi = T(kInvPhi);
  T a = T(kMinLogBl);
  T b = T(kMaxLogBl);
  T c = b - mul_rn(invphi, b - a);
  T d = a + mul_rn(invphi, b - a);
  objective2(c, d, fc, fd);
  for (int it = 0; it < kGoldenIters; ++it) {
    const bool left = fc < fd;
    const T b2 = left ? d : b;
    const T a2 = left ? a : c;
    c = b2 - mul_rn(invphi, b2 - a2);
    d = a2 + mul_rn(invphi, b2 - a2);
    a = a2;
    b = b2;
    objective2(c, d, fc, fd);
  }
  const T best = fc < fd ? c : d;
  const T fbest = fc < fd ? fc : fd;
  // Reject a step that makes the objective worse.
  if (tid == 0) out[edge] = fbest < fcur ? best : cur;
}

template <typename T>
__device__ __forceinline__ T golden_objective(const T* A, const T* B, const T* w, int S, int lane,
                                              T lb) {
  const T e = exp_t(mul_rn(T(-4.0 / 3.0), exp_t(lb)));
  T acc = T(0);
  for (int s = lane; s < S; s += 32) acc += mul_rn(log_t(A[s] + mul_rn(e, B[s])), w[s]);
  return -warp_sum(acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gp_golden_sweep_slab_kernel(const T* __restrict__ A, const T* __restrict__ B,
                            const T* __restrict__ w, const T* __restrict__ cur_log_bl,
                            T* __restrict__ out, int E, int S) {
  const int edge = blockIdx.x * kWarps + threadIdx.x / 32;
  if (edge >= E) return;  // a whole warp: no shuffle is left waiting
  const int lane = threadIdx.x % 32;
  const T* a_row = A + size_t(edge) * S;
  const T* b_row = B + size_t(edge) * S;
  const T cur = cur_log_bl[edge];
  const T fcur = golden_objective(a_row, b_row, w, S, lane, cur);
  const T invphi = T(kInvPhi);
  T a = T(kMinLogBl);
  T b = T(kMaxLogBl);
  T c = b - mul_rn(invphi, b - a);
  T d = a + mul_rn(invphi, b - a);
  T fc = golden_objective(a_row, b_row, w, S, lane, c);
  T fd = golden_objective(a_row, b_row, w, S, lane, d);
  for (int it = 0; it < kGoldenIters; ++it) {
    const bool left = fc < fd;
    const T b2 = left ? d : b;
    const T a2 = left ? a : c;
    c = b2 - mul_rn(invphi, b2 - a2);
    d = a2 + mul_rn(invphi, b2 - a2);
    a = a2;
    b = b2;
    fc = golden_objective(a_row, b_row, w, S, lane, c);
    fd = golden_objective(a_row, b_row, w, S, lane, d);
  }
  const T best = fc < fd ? c : d;
  const T fbest = fc < fd ? fc : fd;
  // Reject a step that makes the objective worse.
  if (lane == 0) out[edge] = fbest < fcur ? best : cur;
}

template <typename Kern>
cudaError_t prepare(Kern kernel, size_t smem) {
  if (smem > kMaxShared) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  }
  return cudaSuccess;
}

// The on-chip K7 takes the plan's tile TP and shared-memory bytes from the
// caller, and refuses a plan that does not hold what it carves.
template <typename T>
int populate_entry(const void* rw, const void* lw, const void* roots, const void* rw_grp,
                   const void* rw_lev, const void* lw_grp, const void* lw_lev, const void* q,
                   const void* P, const void* tips, void* p, void* PH, void* rhat, void* RB,
                   void* lsp, void* lsPH, void* lsrhat, void* lsRB, int n_rw, int n_lw,
                   int n_roots, int g_rw, int v_rw, int g_lw, int v_lw, int E, int N, int L,
                   int S, int TP, int smem, void* stream) {
  if (TP < 1 || TP > 8 || smem < 0 || g_rw > n_rw || v_rw > g_rw || g_lw > n_lw ||
      v_lw > g_lw || size_t(smem) < populate_onchip_bytes<T>(n_rw, n_lw, n_roots, E, N, TP)) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare(gp_populate_kernel<T>, size_t(smem));
  if (err != cudaSuccess) return int(err);
  const int grid = (S + TP - 1) / TP;
  gp_populate_kernel<T><<<grid, 32 * kPopulateWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rw), static_cast<const int*>(lw), static_cast<const int*>(roots),
      static_cast<const int*>(rw_grp), static_cast<const int*>(rw_lev),
      static_cast<const int*>(lw_grp), static_cast<const int*>(lw_lev), static_cast<const T*>(q),
      static_cast<const T*>(P), static_cast<const T*>(tips), static_cast<T*>(p),
      static_cast<T*>(PH), static_cast<T*>(rhat), static_cast<T*>(RB), static_cast<T*>(lsp),
      static_cast<T*>(lsPH), static_cast<T*>(lsrhat), static_cast<T*>(lsRB), n_rw, n_lw, n_roots,
      g_rw, v_rw, g_lw, v_lw, E, N, L, S, TP);
  return int(cudaGetLastError());
}

template <typename T>
int populate_slab_entry(const void* rw, const void* lw, const void* roots, const void* q,
                        const void* P, const void* tips, void* p, void* PH, void* rhat,
                        void* RB, void* lsp, void* lsPH, void* lsrhat, void* lsRB, int n_rw,
                        int n_lw, int n_roots, int E, int N, int L, int S, void* stream) {
  const size_t want = populate_shared_bytes<T>(n_rw, n_lw, n_roots, E);
  const int staged = want <= kMaxShared;
  const size_t smem = staged ? want : 0;
  cudaError_t err = prepare(gp_populate_slab_kernel<T>, smem);
  if (err != cudaSuccess) return int(err);
  const int grid = (S + kThreads - 1) / kThreads;
  gp_populate_slab_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rw), static_cast<const int*>(lw), static_cast<const int*>(roots),
      static_cast<const T*>(q), static_cast<const T*>(P), static_cast<const T*>(tips),
      static_cast<T*>(p), static_cast<T*>(PH), static_cast<T*>(rhat), static_cast<T*>(RB),
      static_cast<T*>(lsp), static_cast<T*>(lsPH), static_cast<T*>(lsrhat), static_cast<T*>(lsRB),
      n_rw, n_lw, n_roots, E, N, L, S, staged);
  return int(cudaGetLastError());
}

// The main K8 takes the plan's shared-memory bytes from the caller, and
// refuses bytes that do not hold what it carves.
template <typename T>
int golden_sweep_entry(const void* A, const void* B, const void* w, const void* cur, void* out,
                       int E, int S, int smem, void* stream) {
  if (smem < 0 || size_t(smem) < golden_sweep_bytes<T>(S)) return int(cudaErrorInvalidValue);
  cudaError_t err = prepare(gp_golden_sweep_kernel<T>, size_t(smem));
  if (err != cudaSuccess) return int(err);
  gp_golden_sweep_kernel<T><<<E, 32 * kSweepWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<const T*>(w),
      static_cast<const T*>(cur), static_cast<T*>(out), S);
  return int(cudaGetLastError());
}

template <typename T>
int golden_sweep_slab_entry(const void* A, const void* B, const void* w, const void* cur,
                            void* out, int E, int S, void* stream) {
  const int grid = (E + kWarps - 1) / kWarps;
  gp_golden_sweep_slab_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<const T*>(w),
      static_cast<const T*>(cur), static_cast<T*>(out), E, S);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* lsbn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K7 on chip: the streams' group and level offsets (gp/engine_kernels.py
// edge_streams), and the plan's tile TP and shared-memory bytes
// (populate_onchip_plan), come from the caller.
int lsbn_gp_populate_f32(const void* rw, const void* lw, const void* roots,
                         const void* rw_grp, const void* rw_lev, const void* lw_grp,
                         const void* lw_lev, const void* q, const void* P, const void* tips,
                         void* p, void* PH, void* rhat, void* RB, void* lsp, void* lsPH,
                         void* lsrhat, void* lsRB, int n_rw, int n_lw, int n_roots, int g_rw,
                         int v_rw, int g_lw, int v_lw, int E, int N, int L, int S, int TP,
                         int smem, void* stream) {
  return populate_entry<float>(rw, lw, roots, rw_grp, rw_lev, lw_grp, lw_lev, q, P, tips, p,
                               PH, rhat, RB, lsp, lsPH, lsrhat, lsRB, n_rw, n_lw, n_roots, g_rw,
                               v_rw, g_lw, v_lw, E, N, L, S, TP, smem, stream);
}

int lsbn_gp_populate_f64(const void* rw, const void* lw, const void* roots,
                         const void* rw_grp, const void* rw_lev, const void* lw_grp,
                         const void* lw_lev, const void* q, const void* P, const void* tips,
                         void* p, void* PH, void* rhat, void* RB, void* lsp, void* lsPH,
                         void* lsrhat, void* lsRB, int n_rw, int n_lw, int n_roots, int g_rw,
                         int v_rw, int g_lw, int v_lw, int E, int N, int L, int S, int TP,
                         int smem, void* stream) {
  return populate_entry<double>(rw, lw, roots, rw_grp, rw_lev, lw_grp, lw_lev, q, P, tips, p,
                                PH, rhat, RB, lsp, lsPH, lsrhat, lsRB, n_rw, n_lw, n_roots, g_rw,
                                v_rw, g_lw, v_lw, E, N, L, S, TP, smem, stream);
}

// K7's slab route (a thread per pattern), for DAGs beyond the plan.
int lsbn_gp_populate_slab_f32(const void* rw, const void* lw, const void* roots,
                              const void* q, const void* P, const void* tips, void* p, void* PH,
                              void* rhat, void* RB, void* lsp, void* lsPH, void* lsrhat,
                              void* lsRB, int n_rw, int n_lw, int n_roots, int E, int N, int L,
                              int S, void* stream) {
  return populate_slab_entry<float>(rw, lw, roots, q, P, tips, p, PH, rhat, RB, lsp, lsPH,
                                    lsrhat, lsRB, n_rw, n_lw, n_roots, E, N, L, S, stream);
}

int lsbn_gp_populate_slab_f64(const void* rw, const void* lw, const void* roots,
                              const void* q, const void* P, const void* tips, void* p, void* PH,
                              void* rhat, void* RB, void* lsp, void* lsPH, void* lsrhat,
                              void* lsRB, int n_rw, int n_lw, int n_roots, int E, int N, int L,
                              int S, void* stream) {
  return populate_slab_entry<double>(rw, lw, roots, q, P, tips, p, PH, rhat, RB, lsp, lsPH,
                                     lsrhat, lsRB, n_rw, n_lw, n_roots, E, N, L, S, stream);
}

// K8: the plan's shared-memory bytes (gp/engine_kernels.py
// golden_sweep_plan) come from the caller.
int lsbn_gp_golden_sweep_f32(const void* A, const void* B, const void* w, const void* cur,
                             void* out, int E, int S, int smem, void* stream) {
  return golden_sweep_entry<float>(A, B, w, cur, out, E, S, smem, stream);
}

int lsbn_gp_golden_sweep_f64(const void* A, const void* B, const void* w, const void* cur,
                             void* out, int E, int S, int smem, void* stream) {
  return golden_sweep_entry<double>(A, B, w, cur, out, E, S, smem, stream);
}

// K8's slab route (a warp per edge), for rows beyond the plan.
int lsbn_gp_golden_sweep_slab_f32(const void* A, const void* B, const void* w,
                                  const void* cur, void* out, int E, int S, void* stream) {
  return golden_sweep_slab_entry<float>(A, B, w, cur, out, E, S, stream);
}

int lsbn_gp_golden_sweep_slab_f64(const void* A, const void* B, const void* w,
                                  const void* cur, void* out, int E, int S, void* stream) {
  return golden_sweep_slab_entry<double>(A, B, w, cur, out, E, S, stream);
}

}  // extern "C"
