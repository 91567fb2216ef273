// Generic 4-state pruning kernels for NVIDIA Hopper (sm_90a): any
// substitution model that gives explicit 4x4 transition matrices (GTR, and
// JC69 written out), any number K of rate categories, over a batch of
// trees. Three kernels:
//   K4 generic_ll_grad_kernel: LL and the linear-time branch gradient;
//   K5 generic_ll_kernel:      LL only (the primal of the custom VJP);
//   K6 generic_dp_kernel:      d ll / dP per (node, category), d ll / d freqs
//                              and d ll / d props (its backward).
//
// Built by libsbn_tpu_torch/ops/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// (never --use_fast_math) into a shared library with a plain C interface,
// bound with ctypes. Each entry point launches on the caller's stream,
// allocates nothing, and returns a CUDA error code (0 on success).
//
// Layout (all row-major, patterns innermost so that neighbouring threads
// touch neighbouring addresses):
//   post_children (B, S, 3) int32   child ids of internal node L + s,
//                                   padded with the ones slot N1 - 1
//   Pm            (B, N1, K, 4, 4)  transition matrices, row node*K + k
//   Q             (K, 4, 4)         rate matrix scaled by each category rate
//   tips          (L, 4, P)         tip partials
//   freqs         (B, 4) or (4,)    root frequencies, tree stride fs (4 or 0)
//   props         (B, K) or (K,)    category proportions, tree stride ps
//   weights       (P,)              pattern multiplicities
//   E, U          (B, N1, 4K, P)    scratch: evolved and upper partials
//   M             (B, S, 4K, P)     scratch (K6): rescaled node partials of
//                                   the internal nodes
//   ll_part       (B, T)            per (tree, pattern tile) LL partials
//   grad_part     (B, T, N1)        per (tree, tile) branch gradients
//   dp_part       (B, T, N1*K*16)   per (tree, tile) d ll / dP
//   root_part     (B, T, 4 + K)     per (tree, tile) d ll / d freqs, props
// with T = ceil(P / kThreads); the caller sums the partials over T.
//
// The arithmetic follows libsbn_tpu/ops/pruning_pallas.py and
// pruning_pallas_vjp.py: each combine step multiplies the three children's
// evolved partials, divides by the per-pattern max over all 4K rows (with
// the scale > 0 guard) and applies the node's matrices
// out_i = (m_i0 v_0 + m_i1 v_1) + (m_i2 v_2 + m_i3 v_3); the 1e-30 clamps;
// U[root] = props_k freqs_i; each child's upper partial u rescaled by its own
// max. The plain PyTorch twins (ops/pruning_generic.py, ops/pruning_vjp.py)
// repeat this order.
//
// Design, for all three: one thread per (tree, pattern) walks the node loop
// of its pattern column, E/U/M in device memory (csrc/pruning_jc.cu's
// layout), and the block stages its tree's N1 * K 4x4 matrices (and Q) in
// shared memory, so the 16 coefficient loads of every apply are broadcasts
// from shared memory rather than device-memory loads on the dependent
// chain. Cross-pattern
// sums go warp shuffle -> shared memory -> per-tile partial, with no
// atomics, so results repeat exactly from run to run.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;  // one thread per (tree, pattern); one tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;  // rate categories the templates are built for
constexpr size_t kMaxShared = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // Butterfly: every lane ends with the same, order-fixed sum.
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Shared memory: the tree's transition matrices, Q (K4), freqs and props,
// per-warp partial sums (G per warp: the edge values, and H per warp: the
// root values), and the tree's schedule row.
template <typename T>
struct Shared {
  T* P;      // N1 * K * 16
  T* Q;      // K * 16
  T* freqs;  // 4
  T* props;  // K
  T* gsum;   // kWarps * G
  T* lsum;   // kWarps * H
  int* pc;   // 3 * S
};

template <typename T>
__host__ __device__ size_t shared_bytes(int S, int N1, int K, int G, int H) {
  return sizeof(T) * (size_t(N1) * K * 16 + size_t(K) * 16 + 4 + K +
                      size_t(kWarps) * G + size_t(kWarps) * H) +
         sizeof(int) * 3 * size_t(S);
}

template <typename T>
__device__ Shared<T> load_shared(unsigned char* raw, const int* post_children, const T* Pm,
                                 const T* Q, const T* freqs, const T* props, int fs, int ps,
                                 int b, int S, int N1, int K, int G, int H) {
  Shared<T> sh;
  sh.P = reinterpret_cast<T*>(raw);
  sh.Q = sh.P + N1 * K * 16;
  sh.freqs = sh.Q + K * 16;
  sh.props = sh.freqs + 4;
  sh.gsum = sh.props + K;
  sh.lsum = sh.gsum + kWarps * G;
  sh.pc = reinterpret_cast<int*>(sh.lsum + kWarps * H);
  const int tid = threadIdx.x;
  for (int i = tid; i < 3 * S; i += kThreads) {
    sh.pc[i] = post_children[size_t(b) * 3 * S + i];
  }
  const T* Pb = Pm + size_t(b) * N1 * K * 16;
  for (int i = tid; i < N1 * K * 16; i += kThreads) sh.P[i] = Pb[i];
  for (int i = tid; i < K * 16; i += kThreads) sh.Q[i] = Q == nullptr ? T(0) : Q[i];
  for (int i = tid; i < 4; i += kThreads) sh.freqs[i] = freqs[size_t(b) * fs + i];
  for (int i = tid; i < K; i += kThreads) sh.props[i] = props[size_t(b) * ps + i];
  for (int i = tid; i < kWarps * G; i += kThreads) sh.gsum[i] = T(0);
  __syncthreads();
  return sh;
}

// out = m v for one 4x4 block m (row-major, 16 values) in the kernels' order;
// with kTranspose, out = m^T v (P^T is an index swap, not a second copy).
template <typename T, bool kTranspose>
__device__ __forceinline__ void apply4(const T* m, const T* v, T* out) {
  for (int i = 0; i < 4; ++i) {
    T c[4];
    for (int j = 0; j < 4; ++j) c[j] = kTranspose ? m[j * 4 + i] : m[i * 4 + j];
    out[i] = (c[0] * v[0] + c[1] * v[1]) + (c[2] * v[2] + c[3] * v[3]);
  }
}

// The forward pass for one pattern column (E form): the ones slot, the
// leaves E[l] = P_l tip, then the S combine steps prod = E[c0] E[c1] E[c2],
// scale = max over the 4K rows, E[node] = P_node (prod / scale). With
// kWriteM it also stores prod / scale, the node partial M of the internal
// nodes (a leaf's M is its tip, the ones slot's is 1). Eb/Mb/tp point at
// this thread's pattern; consecutive rows are P apart. Returns the log
// scale.
template <typename T, int K, bool kWriteM>
__device__ T forward_pass(const Shared<T>& sh, const T* tp, T* Eb, T* Mb, int L, int S, int N1,
                          int P) {
  constexpr int R = 4 * K;
  const size_t sP = size_t(P);
  const int ones = N1 - 1;
#define E_AT(n, r) Eb[(size_t(n) * R + (r)) * sP]
  for (int r = 0; r < R; ++r) E_AT(ones, r) = T(1);

  for (int l = 0; l < L; ++l) {
    T tip[4];
    for (int i = 0; i < 4; ++i) tip[i] = tp[(size_t(l) * 4 + i) * sP];
    for (int k = 0; k < K; ++k) {
      T out[4];
      apply4<T, false>(sh.P + (l * K + k) * 16, tip, out);
      for (int i = 0; i < 4; ++i) E_AT(l, 4 * k + i) = out[i];
    }
  }

  T logscale = T(0);
  for (int s = 0; s < S; ++s) {
    const int c0 = sh.pc[3 * s], c1 = sh.pc[3 * s + 1], c2 = sh.pc[3 * s + 2];
    const int node = L + s;
    T prod[R];
    for (int r = 0; r < R; ++r) prod[r] = (E_AT(c0, r) * E_AT(c1, r)) * E_AT(c2, r);
    T scale = prod[0];
    for (int r = 1; r < R; ++r) scale = prod[r] > scale ? prod[r] : scale;
    scale = scale > T(0) ? scale : T(1);
    for (int r = 0; r < R; ++r) prod[r] = prod[r] / scale;
    if constexpr (kWriteM) {
      for (int r = 0; r < R; ++r) Mb[(size_t(s) * R + r) * sP] = prod[r];
    }
    for (int k = 0; k < K; ++k) {
      T out[4];
      apply4<T, false>(sh.P + (node * K + k) * 16, prod + 4 * k, out);
      for (int i = 0; i < 4; ++i) E_AT(node, 4 * k + i) = out[i];
    }
    logscale += log_t(scale);
  }
  return logscale;
#undef E_AT
}

// Scaled site likelihood sum_k sum_i props_k freqs_i X[4k + i], clamped at
// 1e-30; X is the root's E (K4, K5) or M (K6) row, rows P apart.
template <typename T, int K>
__device__ T root_site(const Shared<T>& sh, const T* X, int P) {
  T site = T(0);
  for (int k = 0; k < K; ++k) {
    for (int i = 0; i < 4; ++i) {
      site += (sh.props[k] * sh.freqs[i]) * X[size_t(4 * k + i) * size_t(P)];
    }
  }
  return site > T(1e-30) ? site : T(1e-30);
}

// ---------------------------------------------------------------------------
// K5: LL only.
// Replaces the TPU kernel libsbn_tpu/ops/pruning_pallas_vjp.py::_fwd_kernel.
// Bound on this card: device-memory traffic of E (each combine step reads
// three child slabs of 4K values and writes one per pattern) and the
// dependent loads along the node loop; the matrices come from shared
// memory. The JAX kernel runs one program per tree over all patterns; here
// the patterns tile over blocks of 128.
// ---------------------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
generic_ll_kernel(const int* __restrict__ post_children, const T* __restrict__ Pm,
                  const T* __restrict__ tips, const T* __restrict__ freqs,
                  const T* __restrict__ props, const T* __restrict__ weights,
                  T* __restrict__ E, T* __restrict__ ll_part, int fs, int ps, int L, int S,
                  int N1, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Shared<T> sh = load_shared<T>(smem, post_children, Pm, nullptr, freqs, props, fs, ps, b, S, N1,
                                K, 0, 1);
  T ll = T(0);
  if (p < P) {
    T* Eb = E + size_t(b) * N1 * 4 * K * size_t(P) + p;
    const T logscale = forward_pass<T, K, false>(sh, tips + p, Eb, nullptr, L, S, N1, P);
    const int root = L + S - 1;
    const T site = root_site<T, K>(sh, Eb + size_t(root) * 4 * K * size_t(P), P);
    ll = weights[p] * (log_t(site) + logscale);
  }
  ll = warp_sum(ll);
  if (lane == 0) sh.lsum[warp] = ll;
  __syncthreads();
  if (threadIdx.x == 0) {
    T acc = sh.lsum[0];
    for (int w = 1; w < kWarps; ++w) acc += sh.lsum[w];
    ll_part[size_t(b) * gridDim.x + blockIdx.x] = acc;
  }
}

// ---------------------------------------------------------------------------
// The forward pass, then the upper pass: the body of K4 (kDp = false) and
// K6 (kDp = true). U[root] = props_k freqs_i; from the root down, each
// internal node's ev = P_node^T U[node] and its children's E give every
// child's upper partial u = ev * (product of its two siblings' E), its
// denominator denom = sum_r u_r E_kid,r, and U[kid] = u / max(u). They differ
// in what they emit:
//   K4: the LL at the root; per child edge w (u . Q_k E_kid) / denom, summed
//       over the tile into a per-warp slot per node (each non-root node is a
//       child exactly once);
//   K6: at the root d ll / d freqs_i = sum_p (sum_k props_k M_root,ki) w /
//       site and d ll / d props_k = sum_p (sum_i freqs_i M_root,ki) w / site;
//       per child edge dP[kid, k]_ij = sum_p uw_ki M_kid,kj with
//       uw = u w / denom, 16K values, reduced over the tile after each
//       step (two barriers a step) and written to the tile's partial.
// The root and ones-slot rows of both outputs are written as zeros.
// ---------------------------------------------------------------------------
template <typename T, int K, bool kDp>
__device__ __forceinline__ void forward_and_upper(
    unsigned char* smem, const int* __restrict__ post_children, const T* __restrict__ Pm,
    const T* __restrict__ Q, const T* __restrict__ tips, const T* __restrict__ freqs,
    const T* __restrict__ props, const T* __restrict__ weights, T* __restrict__ E,
    T* __restrict__ M, T* __restrict__ U, T* __restrict__ root_part, T* __restrict__ edge_part,
    int fs, int ps, int L, int S, int N1, int P) {
  constexpr int R = 4 * K;
  constexpr int V = kDp ? 16 * K : 1;  // values per child edge
  constexpr int G = kDp ? 3 * V : 0;   // per-warp edge slots (K4 uses N1)
  constexpr int H = kDp ? 4 + K : 1;   // values at the root
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool active = p < P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int root = L + S - 1;
  const int ones = N1 - 1;
  const size_t sP = size_t(P);
  const size_t blk = size_t(b) * gridDim.x + blockIdx.x;
  const T tiny = T(1e-30);
  Shared<T> sh = load_shared<T>(smem, post_children, Pm, Q, freqs, props, fs, ps, b, S, N1, K,
                                kDp ? G : N1, H);

  T* Eb = E + size_t(b) * N1 * R * sP + p;
  T* Ub = U + size_t(b) * N1 * R * sP + p;
  T* Mb = kDp ? M + size_t(b) * S * R * sP + p : nullptr;
  const T* tp = tips + p;
#define E_AT(n, r) Eb[(size_t(n) * R + (r)) * sP]
#define U_AT(n, r) Ub[(size_t(n) * R + (r)) * sP]

  T hv[H];
  for (int h = 0; h < H; ++h) hv[h] = T(0);
  const T w = active ? weights[p] : T(0);
  if (active) {
    const T logscale = forward_pass<T, K, kDp>(sh, tp, Eb, Mb, L, S, N1, P);
    if constexpr (kDp) {
      const T* Mroot = Mb + size_t(S - 1) * R * sP;
      const T w_over_site = w / root_site<T, K>(sh, Mroot, P);
      for (int i = 0; i < 4; ++i) {
        T row = T(0);
        for (int k = 0; k < K; ++k) row += sh.props[k] * Mroot[size_t(4 * k + i) * sP];
        hv[i] = row * w_over_site;
      }
      for (int k = 0; k < K; ++k) {
        T row = T(0);
        for (int i = 0; i < 4; ++i) row += sh.freqs[i] * Mroot[size_t(4 * k + i) * sP];
        hv[4 + k] = row * w_over_site;
      }
    } else {
      const T site = root_site<T, K>(sh, Eb + size_t(root) * R * sP, P);
      hv[0] = w * (log_t(site) + logscale);
    }
    for (int k = 0; k < K; ++k) {
      for (int i = 0; i < 4; ++i) U_AT(root, 4 * k + i) = sh.props[k] * sh.freqs[i];
    }
  }
  for (int h = 0; h < H; ++h) {
    const T v = warp_sum(hv[h]);
    if (lane == 0) sh.lsum[warp * H + h] = v;
  }

  for (int t = 0; t < S; ++t) {
    const int node = root - t;
    const int s = node - L;
    const int kid[3] = {sh.pc[3 * s], sh.pc[3 * s + 1], sh.pc[3 * s + 2]};
    T ev[R], e0[R], e1[R], e2[R];
    if (active) {
      for (int k = 0; k < K; ++k) {
        T un[4];
        for (int i = 0; i < 4; ++i) un[i] = U_AT(node, 4 * k + i);
        apply4<T, true>(sh.P + (node * K + k) * 16, un, ev + 4 * k);
      }
      for (int r = 0; r < R; ++r) {
        e0[r] = E_AT(kid[0], r);
        e1[r] = E_AT(kid[1], r);
        e2[r] = E_AT(kid[2], r);
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int c = kid[j];
      T u[R];
      T denom = T(0), gval = T(0);
      if (active) {
        // The child's own E row r, and u = ev * (its siblings' E).
#define EK(r) (j == 0 ? e0[r] : (j == 1 ? e1[r] : e2[r]))
        for (int r = 0; r < R; ++r) {
          const T a = j == 0 ? e1[r] : e0[r];
          const T bb = j == 2 ? e1[r] : e2[r];
          u[r] = (ev[r] * a) * bb;
        }
        denom = u[0] * EK(0);
        for (int r = 1; r < R; ++r) denom += u[r] * EK(r);
        if constexpr (!kDp) {
          T num = T(0);
          for (int k = 0; k < K; ++k) {
            T ek[4], qe[4];
            for (int i = 0; i < 4; ++i) ek[i] = EK(4 * k + i);
            apply4<T, false>(sh.Q + k * 16, ek, qe);
            for (int i = 0; i < 4; ++i) {
              const T x = u[4 * k + i] * qe[i];
              num = k == 0 && i == 0 ? x : num + x;
            }
          }
          gval = w * num / (denom > tiny ? denom : tiny);
        }
#undef EK
      }
      if constexpr (kDp) {
        // dP[c, k]_ij = sum_p uw_ki M_c,kj: the child's M is its tip for a
        // leaf (every category), ones for the ones slot, the stored M for an
        // internal node.
        const T winv = active ? w / (denom > tiny ? denom : tiny) : T(0);
        for (int k = 0; k < K; ++k) {
          for (int jj = 0; jj < 4; ++jj) {
            T m = T(0);
            if (active) {
              m = c < L ? tp[(size_t(c) * 4 + jj) * sP]
                        : (c == ones ? T(1) : Mb[(size_t(c - L) * R + 4 * k + jj) * sP]);
            }
            for (int i = 0; i < 4; ++i) {
              const T v = warp_sum(active ? (u[4 * k + i] * winv) * m : T(0));
              if (lane == 0) sh.gsum[(warp * 3 + j) * V + k * 16 + i * 4 + jj] = v;
            }
          }
        }
      } else {
        const T v = warp_sum(gval);
        if (lane == 0) sh.gsum[warp * N1 + c] = v;
      }
      if (active) {
        T sc = u[0];
        for (int r = 1; r < R; ++r) sc = u[r] > sc ? u[r] : sc;
        sc = sc > T(0) ? sc : T(1);
        for (int r = 0; r < R; ++r) U_AT(c, r) = u[r] / sc;
      }
    }
    if constexpr (kDp) {
      // This step's three edges: sum the warps' slots into the tile's
      // partial; the ones slot's rows are skipped (zeroed below).
      __syncthreads();
      for (int i = threadIdx.x; i < 3 * V; i += kThreads) {
        const int c = kid[i / V];
        if (c != ones) {
          T acc = sh.gsum[i];
          for (int v = 1; v < kWarps; ++v) acc += sh.gsum[v * 3 * V + i];
          edge_part[(blk * N1 + c) * V + i % V] = acc;
        }
      }
      __syncthreads();
    }
  }
#undef E_AT
#undef U_AT

  __syncthreads();
  for (int h = threadIdx.x; h < H; h += kThreads) {
    T acc = sh.lsum[h];
    for (int v = 1; v < kWarps; ++v) acc += sh.lsum[v * H + h];
    root_part[blk * H + h] = acc;
  }
  if constexpr (kDp) {
    for (int i = threadIdx.x; i < 2 * V; i += kThreads) {
      const int n = i < V ? root : ones;
      edge_part[(blk * N1 + n) * V + i % V] = T(0);
    }
  } else {
    for (int n = threadIdx.x; n < N1; n += kThreads) {
      T acc = T(0);
      if (n != root && n != ones) {
        acc = sh.gsum[n];
        for (int v = 1; v < kWarps; ++v) acc += sh.gsum[v * N1 + n];
      }
      edge_part[blk * N1 + n] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// K4: LL and the branch gradient d LL / d b_e for every edge, in one pass.
// Replaces the TPU kernel libsbn_tpu/ops/pruning_pallas.py::_kernel.
// Bound on this card: device-memory traffic of E and U (the forward pass as
// in K5, then each upward step reads U of the node and three child slabs of
// E and writes three U slabs) and the dependent loads along both node loops;
// the matrices and Q come from shared memory, so the explicit 4x4 applies
// (and the Q_k E product per edge) cost arithmetic, not loads.
// ---------------------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
generic_ll_grad_kernel(const int* __restrict__ post_children, const T* __restrict__ Pm,
                       const T* __restrict__ Q, const T* __restrict__ tips,
                       const T* __restrict__ freqs, const T* __restrict__ props,
                       const T* __restrict__ weights, T* __restrict__ E, T* __restrict__ U,
                       T* __restrict__ ll_part, T* __restrict__ grad_part, int L, int S, int N1,
                       int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  forward_and_upper<T, K, false>(smem, post_children, Pm, Q, tips, freqs, props, weights, E,
                                 nullptr, U, ll_part, grad_part, 0, 0, L, S, N1, P);
}

// ---------------------------------------------------------------------------
// K6: d ll / dP, d ll / d freqs and d ll / d props, the backward half of the
// LL's custom VJP (its forward half is K5). Replaces the TPU kernel
// libsbn_tpu/ops/pruning_pallas_vjp.py::_bwd_kernel. It recomputes the
// forward pass keeping M (remat: the caller saves only the inputs).
// Bound on this card: the per-edge contraction, 16K sums over the tile's
// patterns for each of three children per step (warp shuffles: 80K per
// child), on top of K4's device-memory traffic plus M (written once and read
// once). M is kept for internal nodes only (a leaf's M is read from tips).
// ---------------------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
generic_dp_kernel(const int* __restrict__ post_children, const T* __restrict__ Pm,
                  const T* __restrict__ tips, const T* __restrict__ freqs,
                  const T* __restrict__ props, const T* __restrict__ weights,
                  T* __restrict__ E, T* __restrict__ M, T* __restrict__ U,
                  T* __restrict__ dp_part, T* __restrict__ root_part, int fs, int ps, int L,
                  int S, int N1, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  forward_and_upper<T, K, true>(smem, post_children, Pm, nullptr, tips, freqs, props, weights, E,
                                M, U, root_part, dp_part, fs, ps, L, S, N1, P);
}

template <typename Kern>
cudaError_t prepare(Kern kernel, size_t smem) {
  if (smem > kMaxShared) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  }
  return cudaSuccess;
}

template <typename T, int K>
int launch_ll(const int* pc, const T* Pm, const T* tips, const T* freqs, const T* props,
              const T* w, T* E, T* ll_part, int fs, int ps, int B, int L, int S, int N1, int P,
              cudaStream_t st) {
  const size_t smem = shared_bytes<T>(S, N1, K, 0, 1);
  cudaError_t err = prepare(generic_ll_kernel<T, K>, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  generic_ll_kernel<T, K><<<grid, kThreads, smem, st>>>(pc, Pm, tips, freqs, props, w, E,
                                                        ll_part, fs, ps, L, S, N1, P);
  return int(cudaGetLastError());
}

template <typename T, int K>
int launch_ll_grad(const int* pc, const T* Pm, const T* Q, const T* tips, const T* freqs,
                   const T* props, const T* w, T* E, T* U, T* ll_part, T* grad_part, int B,
                   int L, int S, int N1, int P, cudaStream_t st) {
  const size_t smem = shared_bytes<T>(S, N1, K, N1, 1);
  cudaError_t err = prepare(generic_ll_grad_kernel<T, K>, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  generic_ll_grad_kernel<T, K><<<grid, kThreads, smem, st>>>(pc, Pm, Q, tips, freqs, props, w,
                                                             E, U, ll_part, grad_part, L, S, N1,
                                                             P);
  return int(cudaGetLastError());
}

template <typename T, int K>
int launch_dp(const int* pc, const T* Pm, const T* tips, const T* freqs, const T* props,
              const T* w, T* E, T* M, T* U, T* dp_part, T* root_part, int fs, int ps, int B,
              int L, int S, int N1, int P, cudaStream_t st) {
  const size_t smem = shared_bytes<T>(S, N1, K, 3 * 16 * K, 4 + K);
  cudaError_t err = prepare(generic_dp_kernel<T, K>, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  generic_dp_kernel<T, K><<<grid, kThreads, smem, st>>>(pc, Pm, tips, freqs, props, w, E, M, U,
                                                        dp_part, root_part, fs, ps, L, S, N1, P);
  return int(cudaGetLastError());
}

// Runtime K -> template K.
#define LSBN_DISPATCH_K(K, CALL)                \
  switch (K) {                                  \
    case 1: return CALL(1);                     \
    case 2: return CALL(2);                     \
    case 3: return CALL(3);                     \
    case 4: return CALL(4);                     \
    case 5: return CALL(5);                     \
    case 6: return CALL(6);                     \
    case 7: return CALL(7);                     \
    case 8: return CALL(8);                     \
    default: return int(cudaErrorInvalidValue); \
  }

template <typename T>
int ll_entry(const void* pc, const void* Pm, const void* tips, const void* freqs,
             const void* props, const void* w, void* E, void* ll_part, int fs, int ps, int B,
             int L, int S, int N1, int K, int P, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define LSBN_CALL(KK)                                                                         \
  launch_ll<T, KK>(static_cast<const int*>(pc), static_cast<const T*>(Pm),                   \
                   static_cast<const T*>(tips), static_cast<const T*>(freqs),                 \
                   static_cast<const T*>(props), static_cast<const T*>(w), static_cast<T*>(E), \
                   static_cast<T*>(ll_part), fs, ps, B, L, S, N1, P, st)
  LSBN_DISPATCH_K(K, LSBN_CALL)
#undef LSBN_CALL
}

template <typename T>
int ll_grad_entry(const void* pc, const void* Pm, const void* Q, const void* tips,
                  const void* freqs, const void* props, const void* w, void* E, void* U,
                  void* ll_part, void* grad_part, int B, int L, int S, int N1, int K, int P,
                  void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define LSBN_CALL(KK)                                                                           \
  launch_ll_grad<T, KK>(static_cast<const int*>(pc), static_cast<const T*>(Pm),                \
                        static_cast<const T*>(Q), static_cast<const T*>(tips),                  \
                        static_cast<const T*>(freqs), static_cast<const T*>(props),             \
                        static_cast<const T*>(w), static_cast<T*>(E), static_cast<T*>(U),       \
                        static_cast<T*>(ll_part), static_cast<T*>(grad_part), B, L, S, N1, P, \
                        st)
  LSBN_DISPATCH_K(K, LSBN_CALL)
#undef LSBN_CALL
}

template <typename T>
int dp_entry(const void* pc, const void* Pm, const void* tips, const void* freqs,
             const void* props, const void* w, void* E, void* M, void* U, void* dp_part,
             void* root_part, int fs, int ps, int B, int L, int S, int N1, int K, int P,
             void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define LSBN_CALL(KK)                                                                          \
  launch_dp<T, KK>(static_cast<const int*>(pc), static_cast<const T*>(Pm),                    \
                   static_cast<const T*>(tips), static_cast<const T*>(freqs),                  \
                   static_cast<const T*>(props), static_cast<const T*>(w), static_cast<T*>(E),  \
                   static_cast<T*>(M), static_cast<T*>(U), static_cast<T*>(dp_part),           \
                   static_cast<T*>(root_part), fs, ps, B, L, S, N1, P, st)
  LSBN_DISPATCH_K(K, LSBN_CALL)
#undef LSBN_CALL
}

}  // namespace

extern "C" {

// Patterns per block: the width of one partial-sum tile.
int lsbn_generic_tile() { return kThreads; }
int lsbn_generic_max_k() { return kMaxK; }
const char* lsbn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int lsbn_generic_ll_f32(const void* pc, const void* Pm, const void* tips, const void* freqs,
                        const void* props, const void* w, void* E, void* ll_part, int fs, int ps,
                        int B, int L, int S, int N1, int K, int P, void* stream) {
  return ll_entry<float>(pc, Pm, tips, freqs, props, w, E, ll_part, fs, ps, B, L, S, N1, K, P,
                         stream);
}

int lsbn_generic_ll_f64(const void* pc, const void* Pm, const void* tips, const void* freqs,
                        const void* props, const void* w, void* E, void* ll_part, int fs, int ps,
                        int B, int L, int S, int N1, int K, int P, void* stream) {
  return ll_entry<double>(pc, Pm, tips, freqs, props, w, E, ll_part, fs, ps, B, L, S, N1, K, P,
                          stream);
}

int lsbn_generic_ll_grad_f32(const void* pc, const void* Pm, const void* Q, const void* tips,
                             const void* freqs, const void* props, const void* w, void* E,
                             void* U, void* ll_part, void* grad_part, int B, int L, int S,
                             int N1, int K, int P, void* stream) {
  return ll_grad_entry<float>(pc, Pm, Q, tips, freqs, props, w, E, U, ll_part, grad_part, B, L,
                              S, N1, K, P, stream);
}

int lsbn_generic_ll_grad_f64(const void* pc, const void* Pm, const void* Q, const void* tips,
                             const void* freqs, const void* props, const void* w, void* E,
                             void* U, void* ll_part, void* grad_part, int B, int L, int S,
                             int N1, int K, int P, void* stream) {
  return ll_grad_entry<double>(pc, Pm, Q, tips, freqs, props, w, E, U, ll_part, grad_part, B, L,
                               S, N1, K, P, stream);
}

int lsbn_generic_dp_f32(const void* pc, const void* Pm, const void* tips, const void* freqs,
                        const void* props, const void* w, void* E, void* M, void* U,
                        void* dp_part, void* root_part, int fs, int ps, int B, int L, int S,
                        int N1, int K, int P, void* stream) {
  return dp_entry<float>(pc, Pm, tips, freqs, props, w, E, M, U, dp_part, root_part, fs, ps, B,
                         L, S, N1, K, P, stream);
}

int lsbn_generic_dp_f64(const void* pc, const void* Pm, const void* tips, const void* freqs,
                        const void* props, const void* w, void* E, void* M, void* U,
                        void* dp_part, void* root_part, int fs, int ps, int B, int L, int S,
                        int N1, int K, int P, void* stream) {
  return dp_entry<double>(pc, Pm, tips, freqs, props, w, E, M, U, dp_part, root_part, fs, ps, B,
                          L, S, N1, K, P, stream);
}

}  // extern "C"
