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
//   E, U          (B, N1, 4K, P)    scratch of the slab routes of K4, K5
//                                   and K6: evolved and upper partials
//   M             (B, S, 4K, P)     scratch of K6's slab route: rescaled
//                                   node partials of the internal nodes
//   ll_part       (B, T or C)       per (tree, tile or chunk) LL partials
//   grad_part     (B, T or C, N1)   per (tree, tile or chunk) branch gradients
//   dp_part       (B, C, N1*K*16)   per (tree, tile or chunk) d ll / dP
//   root_part     (B, C, 4 + K)     per (tree, tile or chunk) d ll / d
//                                   freqs, props
// with T = ceil(P / kThreads) tiles of the slab kernels; the on-chip K4 and
// K6 work in tiles of 32 / K patterns and a block walks `walk` of them, so
// their C = ceil(ceil(P / (32 / K)) / walk) chunks; the on-chip K5's W
// warps walk `walk` tiles each, C = ceil(ceil(P / (32 / K)) / (W walk)).
// The caller sums the partials over T or C.
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
// Design of the slab routes (the first designs of K4, K5 and K6): one
// thread per (tree, pattern) walks the node loop of its pattern column,
// E/U/M in device memory (csrc/pruning_jc.cu's layout), and the block stages
// its tree's N1 * K 4x4 matrices (and Q) in shared memory where they fit a
// block (else it reads them from device memory), so the 16 coefficient
// loads of every apply are broadcasts from shared memory rather than
// device-memory loads on the dependent chain. Cross-pattern sums go warp
// shuffle -> shared memory -> per-tile partial, with no atomics, so results
// repeat exactly from run to run. K4, K5 and K6 on chip keep their tile's state in shared memory
// instead (see generic_dp_kernel, generic_ll_grad_kernel and
// generic_ll_kernel below).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;  // one thread per (tree, pattern); one tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;  // rate categories the templates are built for
constexpr size_t kMaxShared = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }

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

// Shared memory of the slab routes: the tree's transition matrices when
// they fit (`staged`; else P points at them in device memory, as on the
// 256-taxon tree at double K >= 4), Q (K4), freqs and props, per-warp
// partial sums (G per warp: the edge values, and H per warp: the root
// values), and the tree's schedule row.
template <typename T>
struct Shared {
  const T* P;  // N1 * K * 16
  T* Q;      // K * 16
  T* freqs;  // 4
  T* props;  // K
  T* gsum;   // kWarps * G
  T* lsum;   // kWarps * H
  int* pc;   // 3 * S
};

template <typename T>
__host__ __device__ size_t shared_bytes(int S, int N1, int K, int G, int H, bool staged) {
  return sizeof(T) * ((staged ? size_t(N1) * K * 16 : 0) + size_t(K) * 16 + 4 + K +
                      size_t(kWarps) * G + size_t(kWarps) * H) +
         sizeof(int) * 3 * size_t(S);
}

// The slab routes' shared-memory bytes, with the matrices staged when they
// fit a block (*staged set to 1) and left in device memory otherwise.
template <typename T>
size_t slab_shared_bytes(int S, int N1, int K, int G, int H, int* staged) {
  *staged = shared_bytes<T>(S, N1, K, G, H, true) <= kMaxShared;
  return shared_bytes<T>(S, N1, K, G, H, *staged);
}

template <typename T>
__device__ Shared<T> load_shared(unsigned char* raw, const int* post_children, const T* Pm,
                                 const T* Q, const T* freqs, const T* props, int fs, int ps,
                                 int b, int S, int N1, int K, int G, int H, int staged) {
  Shared<T> sh;
  const T* Pb = Pm + size_t(b) * N1 * K * 16;
  T* sP = reinterpret_cast<T*>(raw);
  sh.P = staged ? sP : Pb;
  sh.Q = staged ? sP + N1 * K * 16 : sP;
  sh.freqs = sh.Q + K * 16;
  sh.props = sh.freqs + 4;
  sh.gsum = sh.props + K;
  sh.lsum = sh.gsum + kWarps * G;
  sh.pc = reinterpret_cast<int*>(sh.lsum + kWarps * H);
  const int tid = threadIdx.x;
  for (int i = tid; i < 3 * S; i += kThreads) {
    sh.pc[i] = post_children[size_t(b) * 3 * S + i];
  }
  if (staged) {
    for (int i = tid; i < N1 * K * 16; i += kThreads) sP[i] = Pb[i];
  }
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
// K5's slab route: its first design, kept for trees whose on-chip plan
// (generic_ll_kernel below) cannot hold a tile; ops/pruning_vjp.py chooses it
// from the shapes and counts it as "ll_generic_slab".
// Replaces the TPU kernel libsbn_tpu/ops/pruning_pallas_vjp.py::_fwd_kernel.
// Bound on this card: device-memory traffic of E (each combine step reads
// three child slabs of 4K values and writes one per pattern) and the
// dependent loads along the node loop; the matrices come from shared
// memory. The JAX kernel runs one program per tree over all patterns; here
// the patterns tile over blocks of 128.
// ---------------------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
generic_ll_slab_kernel(const int* __restrict__ post_children, const T* __restrict__ Pm,
                       const T* __restrict__ tips, const T* __restrict__ freqs,
                       const T* __restrict__ props, const T* __restrict__ weights,
                       T* __restrict__ E, T* __restrict__ ll_part, int fs, int ps, int L,
                       int S, int N1, int P, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Shared<T> sh = load_shared<T>(smem, post_children, Pm, nullptr, freqs, props, fs, ps, b, S, N1,
                                K, 0, 1, staged);
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
    int fs, int ps, int L, int S, int N1, int P, int staged) {
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
                                kDp ? G : N1, H, staged);

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
// The slab route of K4: its first design, the body above over device-memory
// E and U slabs (each upward step reads U of the node and three child slabs
// of E and writes three U slabs; the matrices and Q come from shared
// memory). Kept for trees whose on-chip plan (generic_ll_grad_kernel below)
// cannot hold a tile; ops/pruning_generic.py chooses it from the plan and
// counts it as "ll_grad_generic_slab".
// ---------------------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
generic_ll_grad_slab_kernel(const int* __restrict__ post_children, const T* __restrict__ Pm,
                            const T* __restrict__ Q, const T* __restrict__ tips,
                            const T* __restrict__ freqs, const T* __restrict__ props,
                            const T* __restrict__ weights, T* __restrict__ E,
                            T* __restrict__ U, T* __restrict__ ll_part, T* __restrict__ grad_part,
                            int L, int S, int N1, int P, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  forward_and_upper<T, K, false>(smem, post_children, Pm, Q, tips, freqs, props, weights, E,
                                 nullptr, U, ll_part, grad_part, 0, 0, L, S, N1, P, staged);
}

// ---------------------------------------------------------------------------
// The slab route of K6: its first design, the body above over device-memory
// E, M and U slabs, with the per-edge contraction dP[c, k]_ij = sum_p uw_ki
// M_c,kj as 16K warp butterflies per child and a block reduction after each
// step. Kept for trees whose on-chip plan (below) cannot hold a tile;
// ops/pruning_vjp.py chooses it from the plan and counts it as
// "ll_dp_generic_slab". M is kept for internal nodes only (a leaf's M is
// read from tips).
// ---------------------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
generic_dp_slab_kernel(const int* __restrict__ post_children, const T* __restrict__ Pm,
                       const T* __restrict__ tips, const T* __restrict__ freqs,
                       const T* __restrict__ props, const T* __restrict__ weights,
                       T* __restrict__ E, T* __restrict__ M, T* __restrict__ U,
                       T* __restrict__ dp_part, T* __restrict__ root_part, int fs, int ps,
                       int L, int S, int N1, int P, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  forward_and_upper<T, K, true>(smem, post_children, Pm, nullptr, tips, freqs, props, weights, E,
                                M, U, root_part, dp_part, fs, ps, L, S, N1, P, staged);
}

// ---------------------------------------------------------------------------
// K6: d ll / dP, d ll / d freqs and d ll / d props, the backward half of the
// LL's custom VJP (its forward half is K5). Replaces the TPU kernel
// libsbn_tpu/ops/pruning_pallas_vjp.py:111 _bwd_kernel, which recomputed the
// forward pass in VMEM scratch of shape (N1, 4K, tile) and contracted dP
// there. Remat: the caller saves only the inputs.
// Design. A block is one warp and owns one tree. Its lanes run over
// (pattern, rate category): lane l works on category l % K of pattern
// l / K of the tile, so a tile is 32 / K patterns (the lanes past
// K * (32 / K) idle) and each lane carries 4 values of a row where a lane
// per pattern carried 4K. The block walks `walk` tiles in a fixed order and
// keeps a tile's whole pruning state in shared memory: the tree's N1 * K
// 4x4 matrices (staged with cp.async once per block, read as broadcasts),
// and per lane only its 4 values of the E rows of the S - 1 internal nodes
// below the root. In the upper pass U[kid] overwrites E[kid], which is
// last read at its parent's upper step, where all three kids' E rows are
// loaded into registers before any U is written (csrc/pruning_jc.cu's
// argument for K1 and K3). The per-pattern max over the 4K rows, the
// denominator and the site likelihood are reductions over the K lanes of
// a pattern (shuffles from each in category order). What is recomputed
// where it is used, with the same operations in the same order as
// forward_pass, so with the same values:
//   * a leaf's E = P_leaf tip, the tips read through the read-only cache;
//   * the ones slot, the constant 1;
//   * an internal kid's node partial M = (E[c0] E[c1] E[c2]) / max at its
//     parent's upper step, from its children's E, which the upper pass has
//     not overwritten yet (it reaches them after their parent);
//   * the root's M, kept in registers from the last forward step, for
//     d ll / d freqs and d ll / d props.
// The per-edge contraction dP[c, k]_ij = sum_p uw_ki M_c,kj (uw = u w /
// denom) was what the slab design spent its time on: 16K warp butterflies
// of 5 shuffles per child and two block barriers per step. Here each lane
// stages its uw and M values in shared memory (pattern stride 32 / K + 1,
// so the lanes reading one pattern's rows hit distinct banks), the warp
// syncs, and lane l sums the entries e = l, l + 32, ... of the 16K over the
// tile's patterns in order: deterministic, with no atomics. A lane adds its
// entries to the block's partial dp_part[tree, chunk] in device memory (the
// first tile stores; the loads are issued before the edge's work, so their
// latency overlaps it), which it alone touches, so nothing of size
// (B, ., ., P) exists and a call adds B * C * N1 * 16K values,
// C = ceil(tiles / walk). The root and ones-slot rows are zeros.
// Why lanes over categories: the first on-chip design (a lane per pattern,
// 32 patterns a tile) needed 4K values per pattern and node in shared
// memory, 67 KB a block at float K = 4, so an SM held 3 warps; this layout
// holds the same state for 32 / K patterns in 4 values per lane (27 KB at
// float K = 4), so 8 warps an SM, and its code is smaller (2.9k SASS
// instructions and 80 registers at float K = 4, against 7.5k and 255).
// Route for larger trees (the plan cannot hold a tile): the slab route
// above, chosen by ops/pruning_vjp.py from the shapes.
// Bound on this card: arithmetic, about 0.078 ms at the JAX bench's config 2
// (B = 256 DS1.100 f32 Weibull+4; chip_smoke.py computes it from its
// inputs). Measured 2.06 ms there (3.8% of the bound), against 2.41 ms for
// the first on-chip design and 3.95 ms for the slab route (E, M and U
// slabs, about 2 GB a call) in the same run (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md). It issues more instructions than the work needs: the
// per-pattern reductions cross K lanes by shuffles, and every lane repeats
// the schedule, address and division work of its pattern.
// ---------------------------------------------------------------------------

// Bytes of shared memory the on-chip K6 takes (a tile of TP = 32 / K
// patterns); ops/pruning_vjp.py dp_onchip_bytes computes the same sum.
template <typename T>
__host__ __device__ size_t dp_onchip_bytes(int S, int N1, int K, int TP) {
  return sizeof(T) * (size_t(N1) * K * 16 + (size_t(S) - 1) * 4 * 32 +
                      size_t(8) * K * (TP + 1) + 4 + K) +
         sizeof(int) * 3 * size_t(S);
}

// Max and sum over the K lanes base .. base + K - 1 of one pattern, taken
// from each lane in category order, so every lane of the group gets the
// same value; all 32 lanes call them.
template <typename T, int K>
__device__ __forceinline__ T group_max(T v, int base) {
  if constexpr (K == 1) return v;
  T m = __shfl_sync(0xffffffffu, v, base);
#pragma unroll
  for (int j = 1; j < K; ++j) {
    const T x = __shfl_sync(0xffffffffu, v, base + j);
    m = x > m ? x : m;
  }
  return m;
}

template <typename T, int K>
__device__ __forceinline__ T group_sum(T v, int base) {
  if constexpr (K == 1) return v;
  T acc = __shfl_sync(0xffffffffu, v, base);
#pragma unroll
  for (int j = 1; j < K; ++j) acc += __shfl_sync(0xffffffffu, v, base + j);
  return acc;
}

// One lane's view of the on-chip K6 state: the tree's matrices in shared
// memory, its own column of the E/U slots (4 values a node, rows 32
// apart), its category k and the first lane `base` of its pattern, and its
// pattern's tips in device memory (rows P apart, read through the
// read-only cache).
template <typename T, int K>
struct GenericOnChip {
  const T* Pm;     // N1 * K * 16
  T* slot;         // (S - 1) * 4 rows: E, then U, of internal node L + s
  const T* tip;    // L * 4 rows
  const int* pc;   // 3 * S
  int k, base, L, S, N1, P;

  __device__ __forceinline__ T& at(int node, int i) const {
    return slot[((node - L) * 4 + i) * 32];
  }
  __device__ __forceinline__ T tip_at(int leaf, int i) const {
    return __ldg(tip + (leaf * 4 + i) * P);
  }
  __device__ __forceinline__ const T* mat(int node) const {
    return Pm + (node * K + k) * 16;
  }

  // This lane's 4 values of the E row of node c: stored for an internal
  // node, P_c tip for a leaf, the constant 1 for the ones slot.
  __device__ __forceinline__ void row(int c, T* out) const {
    if (c >= L) {
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i] = c == N1 - 1 ? T(1) : at(c, i);
      return;
    }
    T t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i] = tip_at(c, i);
    apply4<T, false>(mat(c), t, out);
  }

  // This lane's 4 values of the node partial of combine step s: prod =
  // (E[c0] E[c1]) E[c2] over its max across all 4K values of the pattern
  // (1 when the max is not positive), as forward_pass computes it; returns
  // that scale.
  __device__ __forceinline__ T combine(int s, T* prod) const {
    T a[4];
    row(pc[3 * s], prod);
    row(pc[3 * s + 1], a);
#pragma unroll
    for (int i = 0; i < 4; ++i) prod[i] = prod[i] * a[i];
    row(pc[3 * s + 2], a);
#pragma unroll
    for (int i = 0; i < 4; ++i) prod[i] = prod[i] * a[i];
    T scale = prod[0];
#pragma unroll
    for (int i = 1; i < 4; ++i) scale = prod[i] > scale ? prod[i] : scale;
    scale = group_max<T, K>(scale, base);
    scale = scale > T(0) ? scale : T(1);
#pragma unroll
    for (int i = 0; i < 4; ++i) prod[i] = prod[i] / scale;
    return scale;
  }
};

template <typename T, int K>
__global__ void __launch_bounds__(32)
generic_dp_kernel(const int* __restrict__ post_children, const T* __restrict__ Pm,
                  const T* __restrict__ tips, const T* __restrict__ freqs,
                  const T* __restrict__ props, const T* __restrict__ weights,
                  T* __restrict__ dp_part, T* __restrict__ root_part, int fs, int ps, int L,
                  int S, int N1, int P, int walk) {
  constexpr int TP = 32 / K;          // patterns a tile
  constexpr int SP = TP + 1;          // pattern stride of the staged values
  constexpr int V = 16 * K;           // dP values per edge
  constexpr int NQ = (V + 31) / 32;   // of which one lane owns at most NQ
  constexpr int H = 4 + K;            // values at the root
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int pl = lane / K;            // the lane's pattern in the tile
  const int k = lane % K;             // and its rate category
  const bool used = pl < TP;
  // The tree is the fast grid index, so the blocks an SM holds at once
  // mostly share one chunk of tiles and its tips stay in cache.
  const int b = blockIdx.x;
  const int chunk = blockIdx.y;
  const int root = L + S - 1;
  const int ones = N1 - 1;
  const T tiny = T(1e-30);

  // Carve shared memory in dp_onchip_bytes' order and stage the tree.
  T* s_P = reinterpret_cast<T*>(smem);
  T* slot = s_P + N1 * K * 16;
  T* uw_s = slot + size_t(S - 1) * 4 * 32;
  T* m_s = uw_s + 4 * K * SP;
  T* s_freqs = m_s + 4 * K * SP;
  T* s_props = s_freqs + 4;
  int* s_pc = reinterpret_cast<int*>(s_props + K);
  for (int i = lane; i < 3 * S; i += 32) {
    cp_async<sizeof(int)>(s_pc + i, post_children + size_t(b) * 3 * S + i);
  }
  const T* Pb = Pm + size_t(b) * N1 * K * 16;
  for (int i = lane; i < N1 * K * 16; i += 32) cp_async<sizeof(T)>(s_P + i, Pb + i);
  for (int i = lane; i < 4; i += 32) s_freqs[i] = freqs[size_t(b) * fs + i];
  for (int i = lane; i < K; i += 32) s_props[i] = props[size_t(b) * ps + i];
  cp_async_wait_all();
  __syncthreads();

  const size_t blk = size_t(b) * gridDim.y + chunk;
  T* dp = dp_part + blk * N1 * V;
  for (int i = lane; i < V; i += 32) {
    dp[size_t(root) * V + i] = T(0);
    dp[size_t(ones) * V + i] = T(0);
  }
  T hacc[H];
#pragma unroll
  for (int h = 0; h < H; ++h) hacc[h] = T(0);
  const T pk = s_props[k];

  const int tiles = (P + TP - 1) / TP;
  const int t0 = chunk * walk;
  const int t1 = t0 + walk < tiles ? t0 + walk : tiles;
  for (int tile = t0; tile < t1; ++tile) {
    const bool first = tile == t0;
    const int p = tile * TP + pl;
    const bool active = used && p < P;
    // Every lane runs every step, so that the shuffles see the whole warp;
    // an inactive lane works on pattern 0 and its results are dropped.
    const GenericOnChip<T, K> o{s_P, slot + lane, tips + (active ? p : 0), s_pc,
                                k, pl * K, L, S, N1, P};
    const T w = active ? weights[p] : T(0);

    // Forward: the S combine steps, each storing E[node]; the root's M
    // stays in registers.
    T mroot[4];
    for (int s = 0; s < S; ++s) {
      T prod[4];
      o.combine(s, prod);
      if (s == S - 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) mroot[i] = prod[i];
        break;
      }
      T out[4];
      apply4<T, false>(o.mat(L + s), prod, out);
#pragma unroll
      for (int i = 0; i < 4; ++i) o.at(L + s, i) = out[i];
    }
    // d ll / d freqs_i and d ll / d props_k at the root, from its rescaled
    // partial (the scales cancel in w / site).
    T site = T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i) site += (pk * s_freqs[i]) * mroot[i];
    site = group_sum<T, K>(site, o.base);
    const T w_over_site = w / (site > tiny ? site : tiny);
    T hv[H];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const T row = group_sum<T, K>(pk * mroot[i], o.base);
      hv[i] = active && k == 0 ? row * w_over_site : T(0);
    }
    T dprop = T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i) dprop += s_freqs[i] * mroot[i];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) hv[4 + kk] = active && k == kk ? dprop * w_over_site : T(0);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const T v = warp_sum(hv[h]);
      hacc[h] = first ? v : hacc[h] + v;
    }

    // Upper pass, from the root down.
    for (int t = 0; t < S; ++t) {
      const int node = root - t;
      const int s = node - L;
      const int kid[3] = {s_pc[3 * s], s_pc[3 * s + 1], s_pc[3 * s + 2]};
      T un[4], ev[4], e0[4], e1[4], e2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) un[i] = node == root ? pk * s_freqs[i] : o.at(node, i);
      apply4<T, true>(o.mat(node), un, ev);
      o.row(kid[0], e0);
      o.row(kid[1], e1);
      o.row(kid[2], e2);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int c = kid[j];
        if (c == ones) continue;  // its edge is no edge: its dP rows are zero
        // This lane's running sums of the edge, loaded before the work below
        // so that their latency overlaps it.
        T* dpc = dp + size_t(c) * V;
        T prev[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int e = lane + 32 * q;
          prev[q] = (!first && e < V) ? dpc[e] : T(0);
        }
        T u[4], m[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const T a = j == 0 ? e1[i] : e0[i];
          const T bb = j == 2 ? e1[i] : e2[i];
          u[i] = (ev[i] * a) * bb;
        }
        const T* ek = j == 0 ? e0 : (j == 1 ? e1 : e2);
        T d = u[0] * ek[0];
#pragma unroll
        for (int i = 1; i < 4; ++i) d += u[i] * ek[i];
        const T denom = group_sum<T, K>(d, o.base);
        const T winv = w / (denom > tiny ? denom : tiny);
        // The kid's M: its tip for a leaf (every category), recomputed from
        // its children for an internal node.
        if (c < L) {
#pragma unroll
          for (int i = 0; i < 4; ++i) m[i] = o.tip_at(c, i);
        } else {
          o.combine(c - L, m);
        }
        if (used) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uw_s[(4 * k + i) * SP + pl] = active ? u[i] * winv : T(0);
            m_s[(4 * k + i) * SP + pl] = active ? m[i] : T(0);
          }
        }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int e = lane + 32 * q;
          if (e < V) {
            const int ke = e >> 4, ie = (e >> 2) & 3, je = e & 3;
            const T* x = uw_s + (4 * ke + ie) * SP;
            const T* y = m_s + (4 * ke + je) * SP;
            T acc = x[0] * y[0];
#pragma unroll
            for (int pp = 1; pp < TP; ++pp) acc += x[pp] * y[pp];
            dpc[e] = first ? acc : prev[q] + acc;
          }
        }
        __syncwarp();
        if (c >= L) {
          T sc = u[0];
#pragma unroll
          for (int i = 1; i < 4; ++i) sc = u[i] > sc ? u[i] : sc;
          sc = group_max<T, K>(sc, o.base);
          sc = sc > T(0) ? sc : T(1);
#pragma unroll
          for (int i = 0; i < 4; ++i) o.at(c, i) = u[i] / sc;
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) root_part[blk * H + h] = hacc[h];
  }
}

// ---------------------------------------------------------------------------
// K4: LL and the branch gradient d LL / d b_e for every edge, in one pass.
// Replaces the TPU kernel libsbn_tpu/ops/pruning_pallas.py::_kernel, which
// kept a pattern tile's E and U in VMEM scratch.
// Design: generic_dp_kernel's (a block is one warp and owns one tree; lane l
// works on category l % K of pattern l / K, a tile of 32 / K patterns; the
// block walks `walk` tiles in a fixed order), with K4's outputs:
//   * the forward pass as K6 runs it, E rows of the S - 1 internal nodes
//     below the root in the lanes' shared-memory columns, leaves recomputed
//     as P_leaf tip, the ones slot the constant 1; at the root, E = P_root M
//     and the LL w (log site + sum log scale), K5's arithmetic;
//   * the upper pass from U[root] = props_k freqs_i down: U[kid] overwrites
//     E[kid] after all three kids' E rows are in registers (K6's argument);
//   * per child edge c, each lane forms u and Q_k E_c (one 4x4 apply from the
//     staged Q), and two group sums over the pattern's K lanes, in category
//     order, give num = u . Q_k E_c and denom = u . E_c; the gradient
//     w num / max(denom, 1e-30) goes into the block's running sum for
//     (c, the lane's pattern slot) in shared memory, which only that lane
//     touches: no atomics, no shuffles. At the end the block sums each
//     edge's pattern slots in order and writes one partial per (tree,
//     chunk), and its LL partial: a call adds B C (N1 + 1) values, where the
//     slab route's E and U scratch took 2 B N1 4K P.
// Bound on this card: arithmetic, about 0.08 ms at the JAX bench's config 2
// (B = 256 DS1.100 f32 Weibull+4; chip_smoke.py computes it from its
// inputs), against device-memory traffic for the slab route. Measured
// 1.40 ms there (5.6% of the bound) against 2.28 ms for the slab route in
// the same run (NVIDIA H100 80GB HBM3, 700 W; PERF.md). Like K6 it issues
// more instructions than the work needs: every lane repeats its pattern's
// schedule, address and division work, and the per-pattern max,
// denominator, numerator and site sums cross K lanes by shuffles.
// Route for larger trees (the plan cannot hold a tile): the slab route above,
// chosen by ops/pruning_generic.py from the shapes.
// ---------------------------------------------------------------------------

// Bytes of shared memory the on-chip K4 takes (a tile of TP = 32 / K
// patterns); ops/pruning_generic.py ll_grad_onchip_bytes computes the same
// sum.
template <typename T>
__host__ __device__ size_t ll_grad_onchip_bytes(int S, int N1, int K, int TP) {
  return sizeof(T) * (size_t(N1) * K * 16 + size_t(K) * 16 + (size_t(S) - 1) * 4 * 32 +
                      size_t(N1) * TP + 4 + K) +
         sizeof(int) * 3 * size_t(S);
}

template <typename T, int K>
__global__ void __launch_bounds__(32)
generic_ll_grad_kernel(const int* __restrict__ post_children, const T* __restrict__ Pm,
                       const T* __restrict__ Q, const T* __restrict__ tips,
                       const T* __restrict__ freqs, const T* __restrict__ props,
                       const T* __restrict__ weights, T* __restrict__ ll_part,
                       T* __restrict__ grad_part, int L, int S, int N1, int P, int walk) {
  constexpr int TP = 32 / K;  // patterns a tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int pl = lane / K;    // the lane's pattern in the tile
  const int k = lane % K;     // and its rate category
  const bool used = pl < TP;
  const int b = blockIdx.x;
  const int chunk = blockIdx.y;
  const int root = L + S - 1;
  const int ones = N1 - 1;
  const T tiny = T(1e-30);

  // Carve shared memory in ll_grad_onchip_bytes' order and stage the tree.
  T* s_P = reinterpret_cast<T*>(smem);
  T* s_Q = s_P + N1 * K * 16;
  T* slot = s_Q + K * 16;
  T* gacc = slot + size_t(S - 1) * 4 * 32;  // (N1, TP) edge sums per pattern slot
  T* s_freqs = gacc + size_t(N1) * TP;
  T* s_props = s_freqs + 4;
  int* s_pc = reinterpret_cast<int*>(s_props + K);
  for (int i = lane; i < 3 * S; i += 32) {
    cp_async<sizeof(int)>(s_pc + i, post_children + size_t(b) * 3 * S + i);
  }
  const T* Pb = Pm + size_t(b) * N1 * K * 16;
  for (int i = lane; i < N1 * K * 16; i += 32) cp_async<sizeof(T)>(s_P + i, Pb + i);
  for (int i = lane; i < K * 16; i += 32) cp_async<sizeof(T)>(s_Q + i, Q + i);
  for (int i = lane; i < 4; i += 32) s_freqs[i] = freqs[i];
  for (int i = lane; i < K; i += 32) s_props[i] = props[i];
  for (int i = lane; i < N1 * TP; i += 32) gacc[i] = T(0);
  cp_async_wait_all();
  __syncthreads();

  T llacc = T(0);
  const T pk = s_props[k];
  const int tiles = (P + TP - 1) / TP;
  const int t0 = chunk * walk;
  const int t1 = t0 + walk < tiles ? t0 + walk : tiles;
  for (int tile = t0; tile < t1; ++tile) {
    const int p = tile * TP + pl;
    const bool active = used && p < P;
    // Every lane runs every step, so that the shuffles see the whole warp;
    // an inactive lane works on pattern 0 and its results are dropped.
    const GenericOnChip<T, K> o{s_P, slot + lane, tips + (active ? p : 0), s_pc,
                                k, pl * K, L, S, N1, P};
    const T w = active ? weights[p] : T(0);

    // Forward: the S combine steps, each storing E[node] but the root's,
    // which stays in registers, with the sum of the log scales.
    T logscale = T(0);
    T eroot[4];
    for (int s = 0; s < S; ++s) {
      T prod[4], out[4];
      logscale += log_t(o.combine(s, prod));
      apply4<T, false>(o.mat(L + s), prod, out);
      if (s == S - 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) eroot[i] = out[i];
        break;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) o.at(L + s, i) = out[i];
    }
    T site = T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i) site += (pk * s_freqs[i]) * eroot[i];
    site = group_sum<T, K>(site, o.base);
    site = site > tiny ? site : tiny;
    if (active && k == 0) llacc += w * (log_t(site) + logscale);

    // Upper pass, from the root down.
    for (int t = 0; t < S; ++t) {
      const int node = root - t;
      const int s = node - L;
      const int kid[3] = {s_pc[3 * s], s_pc[3 * s + 1], s_pc[3 * s + 2]};
      T un[4], ev[4], e0[4], e1[4], e2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) un[i] = node == root ? pk * s_freqs[i] : o.at(node, i);
      apply4<T, true>(o.mat(node), un, ev);
      o.row(kid[0], e0);
      o.row(kid[1], e1);
      o.row(kid[2], e2);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int c = kid[j];
        if (c == ones) continue;  // its edge is no edge: its gradient is zero
        T u[4], qe[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const T a = j == 0 ? e1[i] : e0[i];
          const T bb = j == 2 ? e1[i] : e2[i];
          u[i] = (ev[i] * a) * bb;
        }
        const T* ek = j == 0 ? e0 : (j == 1 ? e1 : e2);
        T d = u[0] * ek[0];
#pragma unroll
        for (int i = 1; i < 4; ++i) d += u[i] * ek[i];
        const T denom = group_sum<T, K>(d, o.base);
        apply4<T, false>(s_Q + k * 16, ek, qe);
        T x = u[0] * qe[0];
#pragma unroll
        for (int i = 1; i < 4; ++i) x += u[i] * qe[i];
        const T num = group_sum<T, K>(x, o.base);
        if (active && k == 0) {
          gacc[c * TP + pl] += w * num / (denom > tiny ? denom : tiny);
        }
        if (c >= L) {
          T sc = u[0];
#pragma unroll
          for (int i = 1; i < 4; ++i) sc = u[i] > sc ? u[i] : sc;
          sc = group_max<T, K>(sc, o.base);
          sc = sc > T(0) ? sc : T(1);
#pragma unroll
          for (int i = 0; i < 4; ++i) o.at(c, i) = u[i] / sc;
        }
      }
    }
  }
  // The chunk's partials: each edge's pattern slots summed in order (the
  // root and ones-slot rows are zero), and the LL over the warp.
  __syncwarp();
  const size_t blk = size_t(b) * gridDim.y + chunk;
  for (int n = lane; n < N1; n += 32) {
    T acc = T(0);
    if (n != root && n != ones) {
      acc = gacc[n * TP];
      for (int q = 1; q < TP; ++q) acc += gacc[n * TP + q];
    }
    grad_part[blk * N1 + n] = acc;
  }
  llacc = warp_sum(llacc);
  if (lane == 0) ll_part[blk] = llacc;
}

// ---------------------------------------------------------------------------
// K5: LL only.
// Replaces the TPU kernel libsbn_tpu/ops/pruning_pallas_vjp.py::_fwd_kernel,
// which kept a pattern tile's E rows in VMEM scratch.
// Design: K4's and K6's on-chip forward pass without an upper pass, with W
// warps a block sharing one staged copy of the tree's matrices:
//   * lane l of a warp works on category l % K of pattern l / K, a tile of
//     TP = 32 / K patterns; the block's W warps take different tiles of the
//     same tree, warp v the tiles t0 + v, t0 + v + W, ... of the block's
//     chunk of W * walk tiles;
//   * the tree's N1 K 4x4 matrices and its schedule row are staged once per
//     block with cp.async, freqs and props beside them;
//   * each lane keeps its 4 E values of the S - 1 internal nodes below the
//     root in its warp's shared-memory column; leaves (P_leaf tip, the tips
//     read through the read-only cache) and the ones slot (the constant 1)
//     are recomputed where they are used (GenericOnChip::row); the root's E
//     stays in registers, and its site sum and the LL w (log site + sum of
//     log scales) are K4's;
//   * each warp sums its lanes' LLs by a butterfly, and the block adds its
//     warps' sums in warp order into one partial per (tree, chunk), which
//     the caller sums: no atomics, the result repeats exactly, and a call
//     adds B C values where the slab route's E scratch took B N1 4K P.
// The tree is the fast grid index, so that the blocks an SM holds at once
// share a chunk of patterns and its tips stay in cache. W comes from
// ops/pruning_vjp.py ll_onchip_plan: the largest W <= 8 whose shared memory
// (ll_onchip_bytes) fits a block and gives an SM at least as many warps as
// W = 1 (config 2 f32 K = 4: 13.6 KB of matrices and 12.3 KB of E rows a
// warp, so W = 8 in 112 KB, 2 blocks and 16 warps an SM, where W = 1 gives 8).
// Bound on this card: arithmetic, about 0.027 ms at the JAX bench's config 2
// (B = 256 DS1.100 f32 Weibull+4; chip_smoke.py computes it from its
// inputs), against the slab route's 1.9 GB of E traffic a call. Like K4 and
// K6 it issues more instructions than the work needs: every lane repeats
// its pattern's schedule, address and division work, and the per-pattern
// max and site sum cross K lanes by shuffles.
// Route for larger trees (the plan cannot hold one warp's tile): the slab
// route above, chosen by ops/pruning_vjp.py from the shapes.
// ---------------------------------------------------------------------------
constexpr int kMaxLlWarps = 8;  // warps a block of the on-chip K5 at most

// Bytes of shared memory the on-chip K5 takes with W warps (a tile of
// TP = 32 / K patterns each); ops/pruning_vjp.py ll_onchip_bytes computes the
// same sum.
template <typename T>
__host__ __device__ size_t ll_onchip_bytes(int S, int N1, int K, int W) {
  return sizeof(T) * (size_t(N1) * K * 16 + size_t(W) * (size_t(S) - 1) * 4 * 32 + W + 4 + K) +
         sizeof(int) * 3 * size_t(S);
}

template <typename T, int K>
__global__ void __launch_bounds__(32 * kMaxLlWarps)
generic_ll_kernel(const int* __restrict__ post_children, const T* __restrict__ Pm,
                  const T* __restrict__ tips, const T* __restrict__ freqs,
                  const T* __restrict__ props, const T* __restrict__ weights,
                  T* __restrict__ ll_part, int fs, int ps, int L, int S, int N1, int P,
                  int walk) {
  constexpr int TP = 32 / K;  // patterns a tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pl = lane / K;    // the lane's pattern in the tile
  const int k = lane % K;     // and its rate category
  const bool used = pl < TP;
  const int b = blockIdx.x;
  const int chunk = blockIdx.y;
  const T tiny = T(1e-30);

  // Carve shared memory in ll_onchip_bytes' order and stage the tree.
  T* s_P = reinterpret_cast<T*>(smem);
  T* slots = s_P + N1 * K * 16;
  T* s_part = slots + size_t(W) * (S - 1) * 4 * 32;  // one LL sum a warp
  T* s_freqs = s_part + W;
  T* s_props = s_freqs + 4;
  int* s_pc = reinterpret_cast<int*>(s_props + K);
  for (int i = tid; i < 3 * S; i += blockDim.x) {
    cp_async<sizeof(int)>(s_pc + i, post_children + size_t(b) * 3 * S + i);
  }
  const T* Pb = Pm + size_t(b) * N1 * K * 16;
  for (int i = tid; i < N1 * K * 16; i += blockDim.x) cp_async<sizeof(T)>(s_P + i, Pb + i);
  for (int i = tid; i < 4; i += blockDim.x) s_freqs[i] = freqs[size_t(b) * fs + i];
  for (int i = tid; i < K; i += blockDim.x) s_props[i] = props[size_t(b) * ps + i];
  cp_async_wait_all();
  __syncthreads();

  T llacc = T(0);
  const T pk = s_props[k];
  const int tiles = (P + TP - 1) / TP;
  const int span = W * walk;  // tiles of the block's chunk
  const int t1 = (chunk + 1) * span < tiles ? (chunk + 1) * span : tiles;
  T* column = slots + size_t(warp) * (S - 1) * 4 * 32 + lane;
  for (int tile = chunk * span + warp; tile < t1; tile += W) {
    const int p = tile * TP + pl;
    const bool active = used && p < P;
    // Every lane runs every step, so that the shuffles see the whole warp;
    // an inactive lane works on pattern 0 and its results are dropped.
    const GenericOnChip<T, K> o{s_P, column, tips + (active ? p : 0), s_pc,
                                k, pl * K, L, S, N1, P};
    const T w = active ? weights[p] : T(0);

    // The S combine steps, each storing E[node] but the root's, which stays
    // in registers, with the sum of the log scales.
    T logscale = T(0);
    T eroot[4];
    for (int s = 0; s < S; ++s) {
      T prod[4], out[4];
      logscale += log_t(o.combine(s, prod));
      apply4<T, false>(o.mat(L + s), prod, out);
      if (s == S - 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) eroot[i] = out[i];
        break;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) o.at(L + s, i) = out[i];
    }
    T site = T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i) site += (pk * s_freqs[i]) * eroot[i];
    site = group_sum<T, K>(site, o.base);
    site = site > tiny ? site : tiny;
    if (active && k == 0) llacc += w * (log_t(site) + logscale);
  }
  // The chunk's partial: the warps' sums in warp order.
  llacc = warp_sum(llacc);
  if (lane == 0) s_part[warp] = llacc;
  __syncthreads();
  if (tid == 0) {
    T acc = s_part[0];
    for (int v = 1; v < W; ++v) acc += s_part[v];
    ll_part[size_t(b) * gridDim.y + chunk] = acc;
  }
}

template <typename Kern>
cudaError_t prepare(Kern kernel, size_t smem) {
  if (smem > kMaxShared) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  }
  return cudaSuccess;
}

// The on-chip K5 takes the plan's warps a block and shared-memory bytes from
// the caller, and refuses a plan that does not hold what it carves.
template <typename T, int K>
int launch_ll(const int* pc, const T* Pm, const T* tips, const T* freqs, const T* props,
              const T* w, T* ll_part, int fs, int ps, int B, int L, int S, int N1, int P, int W,
              int smem, int walk, cudaStream_t st) {
  if (W < 1 || W > kMaxLlWarps || walk < 1 || smem < 0 ||
      size_t(smem) < ll_onchip_bytes<T>(S, N1, K, W)) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare(generic_ll_kernel<T, K>, size_t(smem));
  if (err != cudaSuccess) return int(err);
  const int tiles = (P + 32 / K - 1) / (32 / K);
  const dim3 grid(B, (tiles + W * walk - 1) / (W * walk));
  generic_ll_kernel<T, K><<<grid, 32 * W, smem, st>>>(pc, Pm, tips, freqs, props, w, ll_part,
                                                      fs, ps, L, S, N1, P, walk);
  return int(cudaGetLastError());
}

template <typename T, int K>
int launch_ll_slab(const int* pc, const T* Pm, const T* tips, const T* freqs, const T* props,
                   const T* w, T* E, T* ll_part, int fs, int ps, int B, int L, int S, int N1,
                   int P, cudaStream_t st) {
  int staged;
  const size_t smem = slab_shared_bytes<T>(S, N1, K, 0, 1, &staged);
  cudaError_t err = prepare(generic_ll_slab_kernel<T, K>, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  generic_ll_slab_kernel<T, K><<<grid, kThreads, smem, st>>>(pc, Pm, tips, freqs, props, w, E,
                                                             ll_part, fs, ps, L, S, N1, P, staged);
  return int(cudaGetLastError());
}

template <typename T, int K>
int launch_ll_grad_slab(const int* pc, const T* Pm, const T* Q, const T* tips, const T* freqs,
                        const T* props, const T* w, T* E, T* U, T* ll_part, T* grad_part, int B,
                        int L, int S, int N1, int P, cudaStream_t st) {
  int staged;
  const size_t smem = slab_shared_bytes<T>(S, N1, K, N1, 1, &staged);
  cudaError_t err = prepare(generic_ll_grad_slab_kernel<T, K>, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  generic_ll_grad_slab_kernel<T, K><<<grid, kThreads, smem, st>>>(
      pc, Pm, Q, tips, freqs, props, w, E, U, ll_part, grad_part, L, S, N1, P, staged);
  return int(cudaGetLastError());
}

// The on-chip K4 takes the plan's tile TP and shared-memory bytes from the
// caller, and refuses a plan that does not hold what it carves.
template <typename T, int K>
int launch_ll_grad(const int* pc, const T* Pm, const T* Q, const T* tips, const T* freqs,
                   const T* props, const T* w, T* ll_part, T* grad_part, int B, int L, int S,
                   int N1, int P, int TP, int smem, int walk, cudaStream_t st) {
  if (TP != 32 / K || walk < 1 || smem < 0 ||
      size_t(smem) < ll_grad_onchip_bytes<T>(S, N1, K, TP)) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare(generic_ll_grad_kernel<T, K>, size_t(smem));
  if (err != cudaSuccess) return int(err);
  const int tiles = (P + TP - 1) / TP;
  const dim3 grid(B, (tiles + walk - 1) / walk);
  generic_ll_grad_kernel<T, K><<<grid, 32, smem, st>>>(pc, Pm, Q, tips, freqs, props, w,
                                                       ll_part, grad_part, L, S, N1, P, walk);
  return int(cudaGetLastError());
}

template <typename T, int K>
int launch_dp_slab(const int* pc, const T* Pm, const T* tips, const T* freqs, const T* props,
                   const T* w, T* E, T* M, T* U, T* dp_part, T* root_part, int fs, int ps, int B,
                   int L, int S, int N1, int P, cudaStream_t st) {
  int staged;
  const size_t smem = slab_shared_bytes<T>(S, N1, K, 3 * 16 * K, 4 + K, &staged);
  cudaError_t err = prepare(generic_dp_slab_kernel<T, K>, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  generic_dp_slab_kernel<T, K><<<grid, kThreads, smem, st>>>(
      pc, Pm, tips, freqs, props, w, E, M, U, dp_part, root_part, fs, ps, L, S, N1, P, staged);
  return int(cudaGetLastError());
}

// The on-chip K6 takes the plan's tile TP and shared-memory bytes from the
// caller, and refuses a plan that does not hold what it carves.
template <typename T, int K>
int launch_dp(const int* pc, const T* Pm, const T* tips, const T* freqs, const T* props,
              const T* w, T* dp_part, T* root_part, int fs, int ps, int B, int L, int S, int N1,
              int P, int TP, int smem, int walk, cudaStream_t st) {
  if (TP != 32 / K || walk < 1 || size_t(smem) < dp_onchip_bytes<T>(S, N1, K, TP)) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare(generic_dp_kernel<T, K>, size_t(smem));
  if (err != cudaSuccess) return int(err);
  const int tiles = (P + TP - 1) / TP;
  const dim3 grid(B, (tiles + walk - 1) / walk);
  generic_dp_kernel<T, K><<<grid, 32, smem, st>>>(pc, Pm, tips, freqs, props, w, dp_part,
                                                  root_part, fs, ps, L, S, N1, P, walk);
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
             const void* props, const void* w, void* ll_part, int fs, int ps, int B, int L,
             int S, int N1, int K, int P, int W, int smem, int walk, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define LSBN_CALL(KK)                                                                   \
  launch_ll<T, KK>(static_cast<const int*>(pc), static_cast<const T*>(Pm),             \
                   static_cast<const T*>(tips), static_cast<const T*>(freqs),           \
                   static_cast<const T*>(props), static_cast<const T*>(w),              \
                   static_cast<T*>(ll_part), fs, ps, B, L, S, N1, P, W, smem, walk, st)
  LSBN_DISPATCH_K(K, LSBN_CALL)
#undef LSBN_CALL
}

template <typename T>
int ll_slab_entry(const void* pc, const void* Pm, const void* tips, const void* freqs,
                  const void* props, const void* w, void* E, void* ll_part, int fs, int ps,
                  int B, int L, int S, int N1, int K, int P, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define LSBN_CALL(KK)                                                                      \
  launch_ll_slab<T, KK>(static_cast<const int*>(pc), static_cast<const T*>(Pm),           \
                        static_cast<const T*>(tips), static_cast<const T*>(freqs),         \
                        static_cast<const T*>(props), static_cast<const T*>(w),            \
                        static_cast<T*>(E), static_cast<T*>(ll_part), fs, ps, B, L, S, N1, \
                        P, st)
  LSBN_DISPATCH_K(K, LSBN_CALL)
#undef LSBN_CALL
}

template <typename T>
int ll_grad_entry(const void* pc, const void* Pm, const void* Q, const void* tips,
                  const void* freqs, const void* props, const void* w, void* ll_part,
                  void* grad_part, int B, int L, int S, int N1, int K, int P, int TP, int smem,
                  int walk, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define LSBN_CALL(KK)                                                                          \
  launch_ll_grad<T, KK>(static_cast<const int*>(pc), static_cast<const T*>(Pm),               \
                        static_cast<const T*>(Q), static_cast<const T*>(tips),                 \
                        static_cast<const T*>(freqs), static_cast<const T*>(props),            \
                        static_cast<const T*>(w), static_cast<T*>(ll_part),                    \
                        static_cast<T*>(grad_part), B, L, S, N1, P, TP, smem, walk, st)
  LSBN_DISPATCH_K(K, LSBN_CALL)
#undef LSBN_CALL
}

template <typename T>
int ll_grad_slab_entry(const void* pc, const void* Pm, const void* Q, const void* tips,
                       const void* freqs, const void* props, const void* w, void* E, void* U,
                       void* ll_part, void* grad_part, int B, int L, int S, int N1, int K, int P,
                       void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define LSBN_CALL(KK)                                                                           \
  launch_ll_grad_slab<T, KK>(static_cast<const int*>(pc), static_cast<const T*>(Pm),           \
                             static_cast<const T*>(Q), static_cast<const T*>(tips),             \
                             static_cast<const T*>(freqs), static_cast<const T*>(props),        \
                             static_cast<const T*>(w), static_cast<T*>(E), static_cast<T*>(U),  \
                             static_cast<T*>(ll_part), static_cast<T*>(grad_part), B, L, S, N1, \
                             P, st)
  LSBN_DISPATCH_K(K, LSBN_CALL)
#undef LSBN_CALL
}

template <typename T>
int dp_entry(const void* pc, const void* Pm, const void* tips, const void* freqs,
             const void* props, const void* w, void* dp_part, void* root_part, int fs, int ps,
             int B, int L, int S, int N1, int K, int P, int TP, int smem, int walk,
             void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define LSBN_CALL(KK)                                                                        \
  launch_dp<T, KK>(static_cast<const int*>(pc), static_cast<const T*>(Pm),                  \
                   static_cast<const T*>(tips), static_cast<const T*>(freqs),                \
                   static_cast<const T*>(props), static_cast<const T*>(w),                   \
                   static_cast<T*>(dp_part), static_cast<T*>(root_part), fs, ps, B, L, S, N1, \
                   P, TP, smem, walk, st)
  LSBN_DISPATCH_K(K, LSBN_CALL)
#undef LSBN_CALL
}

template <typename T>
int dp_slab_entry(const void* pc, const void* Pm, const void* tips, const void* freqs,
                  const void* props, const void* w, void* E, void* M, void* U, void* dp_part,
                  void* root_part, int fs, int ps, int B, int L, int S, int N1, int K, int P,
                  void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define LSBN_CALL(KK)                                                                          \
  launch_dp_slab<T, KK>(static_cast<const int*>(pc), static_cast<const T*>(Pm),               \
                        static_cast<const T*>(tips), static_cast<const T*>(freqs),             \
                        static_cast<const T*>(props), static_cast<const T*>(w),                \
                        static_cast<T*>(E), static_cast<T*>(M), static_cast<T*>(U),            \
                        static_cast<T*>(dp_part), static_cast<T*>(root_part), fs, ps, B, L, S, \
                        N1, P, st)
  LSBN_DISPATCH_K(K, LSBN_CALL)
#undef LSBN_CALL
}

}  // namespace

extern "C" {

// Patterns per block of the slab kernels: the width of one partial-sum tile.
int lsbn_generic_tile() { return kThreads; }
int lsbn_generic_max_k() { return kMaxK; }
const char* lsbn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K5 on chip: the plan's warps a block and shared-memory bytes come from the
// caller (ops/pruning_vjp.py ll_onchip_plan), and each warp walks `walk`
// tiles.
int lsbn_generic_ll_f32(const void* pc, const void* Pm, const void* tips, const void* freqs,
                        const void* props, const void* w, void* ll_part, int fs, int ps, int B,
                        int L, int S, int N1, int K, int P, int W, int smem, int walk,
                        void* stream) {
  return ll_entry<float>(pc, Pm, tips, freqs, props, w, ll_part, fs, ps, B, L, S, N1, K, P, W,
                         smem, walk, stream);
}

int lsbn_generic_ll_f64(const void* pc, const void* Pm, const void* tips, const void* freqs,
                        const void* props, const void* w, void* ll_part, int fs, int ps, int B,
                        int L, int S, int N1, int K, int P, int W, int smem, int walk,
                        void* stream) {
  return ll_entry<double>(pc, Pm, tips, freqs, props, w, ll_part, fs, ps, B, L, S, N1, K, P, W,
                          smem, walk, stream);
}

// K5's slab route (tile kThreads), for trees beyond the plan.
int lsbn_generic_ll_slab_f32(const void* pc, const void* Pm, const void* tips,
                             const void* freqs, const void* props, const void* w, void* E,
                             void* ll_part, int fs, int ps, int B, int L, int S, int N1, int K,
                             int P, void* stream) {
  return ll_slab_entry<float>(pc, Pm, tips, freqs, props, w, E, ll_part, fs, ps, B, L, S, N1, K,
                              P, stream);
}

int lsbn_generic_ll_slab_f64(const void* pc, const void* Pm, const void* tips,
                             const void* freqs, const void* props, const void* w, void* E,
                             void* ll_part, int fs, int ps, int B, int L, int S, int N1, int K,
                             int P, void* stream) {
  return ll_slab_entry<double>(pc, Pm, tips, freqs, props, w, E, ll_part, fs, ps, B, L, S, N1,
                               K, P, stream);
}

// K4 on chip: the plan's tile TP and shared-memory bytes come from the
// caller (ops/pruning_generic.py ll_grad_onchip_plan), and each block walks
// `walk` tiles.
int lsbn_generic_ll_grad_f32(const void* pc, const void* Pm, const void* Q, const void* tips,
                             const void* freqs, const void* props, const void* w, void* ll_part,
                             void* grad_part, int B, int L, int S, int N1, int K, int P, int TP,
                             int smem, int walk, void* stream) {
  return ll_grad_entry<float>(pc, Pm, Q, tips, freqs, props, w, ll_part, grad_part, B, L, S, N1,
                              K, P, TP, smem, walk, stream);
}

int lsbn_generic_ll_grad_f64(const void* pc, const void* Pm, const void* Q, const void* tips,
                             const void* freqs, const void* props, const void* w, void* ll_part,
                             void* grad_part, int B, int L, int S, int N1, int K, int P, int TP,
                             int smem, int walk, void* stream) {
  return ll_grad_entry<double>(pc, Pm, Q, tips, freqs, props, w, ll_part, grad_part, B, L, S,
                               N1, K, P, TP, smem, walk, stream);
}

// K4's slab route (tile kThreads), for trees beyond the plan.
int lsbn_generic_ll_grad_slab_f32(const void* pc, const void* Pm, const void* Q,
                                  const void* tips, const void* freqs, const void* props,
                                  const void* w, void* E, void* U, void* ll_part,
                                  void* grad_part, int B, int L, int S, int N1, int K, int P,
                                  void* stream) {
  return ll_grad_slab_entry<float>(pc, Pm, Q, tips, freqs, props, w, E, U, ll_part, grad_part, B,
                                   L, S, N1, K, P, stream);
}

int lsbn_generic_ll_grad_slab_f64(const void* pc, const void* Pm, const void* Q,
                                  const void* tips, const void* freqs, const void* props,
                                  const void* w, void* E, void* U, void* ll_part,
                                  void* grad_part, int B, int L, int S, int N1, int K, int P,
                                  void* stream) {
  return ll_grad_slab_entry<double>(pc, Pm, Q, tips, freqs, props, w, E, U, ll_part, grad_part,
                                    B, L, S, N1, K, P, stream);
}

// K6 on chip: the plan's tile TP and shared-memory bytes come from the
// caller (ops/pruning_vjp.py dp_onchip_plan), and each block walks `walk`
// tiles.
int lsbn_generic_dp_f32(const void* pc, const void* Pm, const void* tips, const void* freqs,
                        const void* props, const void* w, void* dp_part, void* root_part, int fs,
                        int ps, int B, int L, int S, int N1, int K, int P, int TP, int smem,
                        int walk, void* stream) {
  return dp_entry<float>(pc, Pm, tips, freqs, props, w, dp_part, root_part, fs, ps, B, L, S, N1,
                         K, P, TP, smem, walk, stream);
}

int lsbn_generic_dp_f64(const void* pc, const void* Pm, const void* tips, const void* freqs,
                        const void* props, const void* w, void* dp_part, void* root_part, int fs,
                        int ps, int B, int L, int S, int N1, int K, int P, int TP, int smem,
                        int walk, void* stream) {
  return dp_entry<double>(pc, Pm, tips, freqs, props, w, dp_part, root_part, fs, ps, B, L, S,
                          N1, K, P, TP, smem, walk, stream);
}

// K6's slab route (tile kThreads), for trees beyond the plan.
int lsbn_generic_dp_slab_f32(const void* pc, const void* Pm, const void* tips,
                             const void* freqs, const void* props, const void* w, void* E,
                             void* M, void* U, void* dp_part, void* root_part, int fs, int ps,
                             int B, int L, int S, int N1, int K, int P, void* stream) {
  return dp_slab_entry<float>(pc, Pm, tips, freqs, props, w, E, M, U, dp_part, root_part, fs, ps,
                              B, L, S, N1, K, P, stream);
}

int lsbn_generic_dp_slab_f64(const void* pc, const void* Pm, const void* tips,
                             const void* freqs, const void* props, const void* w, void* E,
                             void* M, void* U, void* dp_part, void* root_part, int fs, int ps,
                             int B, int L, int S, int N1, int K, int P, void* stream) {
  return dp_slab_entry<double>(pc, Pm, tips, freqs, props, w, E, M, U, dp_part, root_part, fs,
                               ps, B, L, S, N1, K, P, stream);
}

}  // extern "C"
