// JC69 pruning kernels for NVIDIA Hopper (sm_90a): log-likelihood, the
// linear-time branch gradient, and the likelihood's derivative with respect
// to the exp factors, over a batch of trees.
//
// Built by libsbn_tpu_torch/ops/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// (never --use_fast_math) into a shared library with a plain C interface,
// bound with ctypes. Each entry point launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError().
//
// Layout (all row-major, patterns innermost so that neighbouring threads
// touch neighbouring addresses):
//   post_children (B, S, 3) int32   child ids of internal node L + s,
//                                   padded with the ones slot N1 - 1
//   em            (B, N1, K)        m = 1 - e, e = exp(-4 b r_k / 3), per
//                                   node and rate category, computed in f64
//                                   (expm1) by the caller
//   rates, props  (K,)              site-rate categories
//   tips          (L, 4, P)         tip partials
//   weights       (P,)              pattern multiplicities
//   E, U          (B, N1, 4K, P)    scratch of the slab routes only:
//                                   evolved and upper partials
//   ES            (B, N1, K, P)     the same: per-category row sums of E
//   M             (B, S, 4K, P)     scratch of K3's slab route: pre-apply
//                                   partials of the internal nodes, at E's
//                                   scale
//   ll_part       (B, T)            per (tree, pattern tile) LL partials
//   grad_part     (B, T, N1)        per (tree, pattern tile) edge gradients
//   dprops_part   (B, T, K)         per (tree, pattern tile) d ll / d props
//   dea_part      (B, T, N1 * K)    per (tree, pattern tile) d ll / d e
// with T = ceil(P / tile); the caller sums the partials over T. K1, K2 and
// K3 keep their whole pruning state in shared memory, a tile of kOnchipTile
// (32) patterns a block (ops/pruning_jc.py onchip_plan checks that it
// fits), and take no scratch at all; a tree beyond that plan takes the slab
// route of the same kernel, the first design, whose tile is kThreads
// patterns.
//
// The arithmetic follows libsbn_tpu/ops/pruning_pallas_jc.py step for step:
// the matrix-free apply P v = e v + (1 - e)/4 sum(v), row-sum rescaling on
// alternate combine steps (with the scale > 0 guard), the 1e-30 clamps, U
// rows normalised by their own row sum, and for K = 1 the scalar-1 row sum
// of U in the upward apply. One departure: the kernels read m = 1 - e and
// form e = 1 - m, where the Pallas kernels read e and form 1 - e. On a
// short branch (e near 1) 1 - e is a difference of nearly equal numbers:
// in f32, at 4 b r / 3 = 2e-5, it keeps 3 of its digits, and the site
// likelihood of a column that changes on the branch, which it sets, loses
// the rest; 1 - m keeps e to the type's precision.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;  // one thread per (tree, pattern); one tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;  // rate categories the templates are built for
constexpr int kOnchipTile = 32;  // patterns (threads) per block of the on-chip K1/K3
constexpr size_t kMaxShared = 232448;  // bytes a block may use on sm_90

// Full-precision logarithm for each working type (no fast-math variants).
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

// Shared memory: the tree's schedule row and exp factors, the category
// tables, and per-warp partial sums: up to K values at the root (the LL, or
// d ll / d props) and G values per node (the branch gradient, G = 1, or
// d ll / d e per category, G = K).
template <typename T>
struct Shared {
  T* em;     // N1 * K
  T* rates;  // K
  T* props;  // K
  T* gsum;   // kWarps * N1 * G
  T* lsum;   // kWarps * K
  int* pc;   // 3 * S
};

template <typename T>
__host__ __device__ size_t shared_bytes(int S, int N1, int K, int G) {
  return sizeof(T) * (size_t(N1) * K + 2 * K + size_t(kWarps) * N1 * G +
                      size_t(kWarps) * K) +
         sizeof(int) * 3 * size_t(S);
}

template <typename T>
__device__ Shared<T> load_shared(unsigned char* raw, const int* post_children,
                                 const T* em, const T* rates, const T* props,
                                 int b, int S, int N1, int K, int G) {
  Shared<T> sh;
  T* f = reinterpret_cast<T*>(raw);
  sh.em = f;
  sh.rates = sh.em + N1 * K;
  sh.props = sh.rates + K;
  sh.gsum = sh.props + K;
  sh.lsum = sh.gsum + kWarps * N1 * G;
  sh.pc = reinterpret_cast<int*>(sh.lsum + kWarps * K);
  const int tid = threadIdx.x;
  for (int i = tid; i < 3 * S; i += kThreads) {
    sh.pc[i] = post_children[size_t(b) * 3 * S + i];
  }
  for (int i = tid; i < N1 * K; i += kThreads) {
    sh.em[i] = em[size_t(b) * N1 * K + i];
  }
  for (int i = tid; i < K; i += kThreads) {
    sh.rates[i] = rates == nullptr ? T(0) : rates[i];
    sh.props[i] = props[i];
  }
  for (int i = tid; i < kWarps * N1 * G; i += kThreads) sh.gsum[i] = T(0);
  __syncthreads();
  return sh;
}

// The forward pass for one pattern column: ones slot, leaves, then the S
// combine steps with alternate-step rescaling. Eb/ESb/Mb/tips point at this
// thread's pattern; consecutive rows are P apart. With kWriteM it also
// stores each internal node's pre-apply product M at E's scale (prod * inv
// on rescaled steps, prod otherwise); the leaves' M is their tip partial,
// which the upper pass reads from tips. Returns the log scale.
template <typename T, int K, bool kWriteM>
__device__ T forward_pass(const Shared<T>& sh, const T* tips, T* Eb, T* ESb,
                          T* Mb, int L, int S, int N1, int P) {
  constexpr int R = 4 * K;
  const T quarter = T(0.25);
  const size_t sP = size_t(P);
  const int ones = N1 - 1;
#define E_AT(n, r) Eb[(size_t(n) * R + (r)) * sP]
#define ES_AT(n, k) ESb[(size_t(n) * K + (k)) * sP]
  for (int r = 0; r < R; ++r) E_AT(ones, r) = T(1);
  for (int k = 0; k < K; ++k) ES_AT(ones, k) = T(4);

  for (int l = 0; l < L; ++l) {
    T tip[4];
    for (int i = 0; i < 4; ++i) tip[i] = tips[(size_t(l) * 4 + i) * sP];
    const T rt = ((tip[0] + tip[1]) + tip[2]) + tip[3];
    for (int k = 0; k < K; ++k) {
      const T m = sh.em[l * K + k];
      const T e = T(1) - m;
      const T c = (m * quarter) * rt;
      for (int i = 0; i < 4; ++i) E_AT(l, 4 * k + i) = e * tip[i] + c;
      ES_AT(l, k) = rt;
    }
  }

  T logscale = T(0);
  for (int s = 0; s < S; ++s) {
    const int c0 = sh.pc[3 * s], c1 = sh.pc[3 * s + 1], c2 = sh.pc[3 * s + 2];
    const int node = L + s;
    T prod[R];
    for (int r = 0; r < R; ++r) prod[r] = (E_AT(c0, r) * E_AT(c1, r)) * E_AT(c2, r);
    T rs[K];
    for (int k = 0; k < K; ++k) {
      rs[k] = ((prod[4 * k] + prod[4 * k + 1]) + prod[4 * k + 2]) + prod[4 * k + 3];
    }
    // Odd steps and the last step rescale (one unscaled level cannot
    // leave range: post-scale values are <= 1 and products of three <= 1).
    const bool do_scale = (s & 1) || (s == S - 1);
    T inv = T(1);
    if (do_scale) {
      T scale = rs[0];
      for (int k = 1; k < K; ++k) scale += rs[k];
      scale = scale > T(0) ? scale : T(1);
      inv = T(1) / scale;
      logscale += log_t(scale);
    }
    for (int k = 0; k < K; ++k) {
      const T m = sh.em[node * K + k];
      const T e = T(1) - m;
      const T c = (m * quarter) * rs[k];
      for (int i = 0; i < 4; ++i) {
        const T v = e * prod[4 * k + i] + c;
        E_AT(node, 4 * k + i) = do_scale ? v * inv : v;
      }
      ES_AT(node, k) = do_scale ? rs[k] * inv : rs[k];
    }
    if constexpr (kWriteM) {
      for (int r = 0; r < R; ++r) {
        Mb[(size_t(s) * R + r) * sP] = do_scale ? prod[r] * inv : prod[r];
      }
    }
  }
  return logscale;
#undef E_AT
#undef ES_AT
}

// Scaled site likelihood (1/4) sum_k props_k S_E,k[root], clamped at 1e-30.
template <typename T, int K>
__device__ T root_site(const Shared<T>& sh, const T* ESb, int root, int P) {
  T site = T(0);
  for (int k = 0; k < K; ++k) {
    site += (sh.props[k] * T(0.25)) * ESb[(size_t(root) * K + k) * size_t(P)];
  }
  return site > T(1e-30) ? site : T(1e-30);
}

template <typename T>
__device__ void write_ll_partial(Shared<T>& sh, T ll, T* ll_part, int b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
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
// The slab route of K2: its first design, one thread per (tree, pattern) and
// all scratch (E, ES) in device memory, bound by that traffic and by the
// dependent loads along the node loop. Kept for trees whose on-chip plan
// cannot hold a tile of 32 patterns; ops/pruning_jc.py chooses it from the
// plan and counts it as "ll_jc69_slab". Its arithmetic is the on-chip K2's,
// value for value.
// ---------------------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
jc69_ll_slab_kernel(const int* __restrict__ post_children, const T* __restrict__ em,
                    const T* __restrict__ props, const T* __restrict__ tips,
                    const T* __restrict__ weights, T* __restrict__ E,
                    T* __restrict__ ES, T* __restrict__ ll_part, int L, int S,
                    int N1, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  Shared<T> sh = load_shared<T>(smem, post_children, em, nullptr, props, b, S,
                                N1, K, 1);
  T ll = T(0);
  if (p < P) {
    T* Eb = E + size_t(b) * N1 * 4 * K * size_t(P) + p;
    T* ESb = ES + size_t(b) * N1 * K * size_t(P) + p;
    const T logscale =
        forward_pass<T, K, false>(sh, tips + p, Eb, ESb, nullptr, L, S, N1, P);
    const T site = root_site<T, K>(sh, ESb, L + S - 1, P);
    ll = weights[p] * (log_t(site) + logscale);
  }
  write_ll_partial(sh, ll, ll_part, b);
}

// ---------------------------------------------------------------------------
// The forward pass, then the upper pass: the body of K1 (kDea = false) and
// K3 (kDea = true). Both run the forward pass, set U[root] = props / 4 and
// walk the internal nodes from the root down, evolving U[node] up through
// the node's edge and forming each child's upper partial u from it and the
// two siblings' E (one shared denominator d = u . E per node). They differ
// in what they emit:
//   K1: at the root the LL; per child edge the branch gradient
//       w r_k [(1/3) S_u,k S_E,k - (4/3) d_k] / denom (G = 1 value);
//   K3: at the root d ll / d props_k = sum_p (w / site) (1/4) S_E,k[root];
//       per child edge d ll / d e_k = rowsum4(uw M)_k - (1/4) rowsum4(uw)_k
//       S_E,k with uw = u w / denom and M the child's pre-apply partial
//       (G = K values); the root and ones-slot rows are zero.
// Per-edge sums over the block's patterns go warp shuffle -> shared memory
// (each non-root node is a child exactly once, so each warp writes its slot
// once; the ones slot's is overwritten and zeroed at the end), so the
// partials are deterministic (no atomics).
// ---------------------------------------------------------------------------
template <typename T, int K, bool kDea>
__device__ __forceinline__ void forward_and_upper(
    unsigned char* smem, const int* __restrict__ post_children, const T* __restrict__ em,
    const T* __restrict__ rates, const T* __restrict__ props,
    const T* __restrict__ tips, const T* __restrict__ weights, T* __restrict__ E,
    T* __restrict__ ES, T* __restrict__ M, T* __restrict__ U,
    T* __restrict__ root_part, T* __restrict__ edge_part, int L, int S, int N1,
    int P) {
  constexpr int R = 4 * K;
  constexpr int G = kDea ? K : 1;  // values per edge
  constexpr int H = kDea ? K : 1;  // values at the root
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool active = p < P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int root = L + S - 1;
  const int ones = N1 - 1;
  const size_t sP = size_t(P);
  const T quarter = T(0.25);
  const T tiny = T(1e-30);
  const T third = T(1.0 / 3.0);
  const T four_thirds = T(4.0 / 3.0);
  Shared<T> sh = load_shared<T>(smem, post_children, em, rates, props, b, S,
                                N1, K, G);

  T* Eb = E + size_t(b) * N1 * R * sP + p;
  T* ESb = ES + size_t(b) * N1 * K * sP + p;
  T* Ub = U + size_t(b) * N1 * R * sP + p;
  T* Mb = kDea ? M + size_t(b) * S * R * sP + p : nullptr;
  const T* tp = tips + p;
#define E_AT(n, r) Eb[(size_t(n) * R + (r)) * sP]
#define ES_AT(n, k) ESb[(size_t(n) * K + (k)) * sP]
#define U_AT(n, r) Ub[(size_t(n) * R + (r)) * sP]

  T hv[H];
  for (int h = 0; h < H; ++h) hv[h] = T(0);
  const T w = active ? weights[p] : T(0);
  if (active) {
    const T logscale = forward_pass<T, K, kDea>(sh, tp, Eb, ESb, Mb, L, S, N1, P);
    const T site = root_site<T, K>(sh, ESb, root, P);
    if constexpr (kDea) {
      const T w_over_site = w / site;
      for (int k = 0; k < K; ++k) hv[k] = (quarter * ES_AT(root, k)) * w_over_site;
    } else {
      hv[0] = w * (log_t(site) + logscale);
    }
    // U[root] = props_k / 4 (the root frequencies folded in).
    for (int k = 0; k < K; ++k) {
      for (int i = 0; i < 4; ++i) U_AT(root, 4 * k + i) = sh.props[k] * quarter;
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
    T g[3][G];
    for (int j = 0; j < 3; ++j) {
      for (int i = 0; i < G; ++i) g[j][i] = T(0);
    }
    if (active) {
      // P^T U[node] = P U[node] (JC69 is symmetric). For K = 1 the rows
      // of U sum to exactly 1, so the row-sum operand is the scalar 1.
      T ev[R];
      for (int k = 0; k < K; ++k) {
        T un[4];
        for (int i = 0; i < 4; ++i) un[i] = U_AT(node, 4 * k + i);
        const T m = sh.em[node * K + k];
        const T e = T(1) - m;
        const T rsu = K == 1 ? T(1) : ((un[0] + un[1]) + un[2]) + un[3];
        const T c = (m * quarter) * rsu;
        for (int i = 0; i < 4; ++i) ev[4 * k + i] = e * un[i] + c;
      }
      T e0[R], e1[R], e2[R];
      for (int r = 0; r < R; ++r) {
        e0[r] = E_AT(kid[0], r);
        e1[r] = E_AT(kid[1], r);
        e2[r] = E_AT(kid[2], r);
      }
      // Shared denominator: u_c . E_c = ev . e0 e1 e2 for every child c.
      T d[K];
      T denom = T(0);
      for (int k = 0; k < K; ++k) {
        T acc[4];
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * k + i;
          acc[i] = ev[r] * ((e0[r] * e1[r]) * e2[r]);
        }
        d[k] = ((acc[0] + acc[1]) + acc[2]) + acc[3];
        denom = k == 0 ? d[0] : denom + d[k];
      }
      const T winv = w / (denom > tiny ? denom : tiny);
      for (int j = 0; j < 3; ++j) {
        T u[R];
        for (int r = 0; r < R; ++r) {
          const T mab = j == 0 ? e1[r] * e2[r] : (j == 1 ? e0[r] * e2[r] : e0[r] * e1[r]);
          u[r] = ev[r] * mab;
        }
        T su = T(0);
        if constexpr (kDea) {
          // The child's M: its tip partial for a leaf (every category),
          // ones for the ones slot, the stored M for an internal node.
          const int c = kid[j];
          for (int k = 0; k < K; ++k) {
            T uw[4], um[4];
            for (int i = 0; i < 4; ++i) {
              const int r = 4 * k + i;
              const T m = c < L ? tp[(size_t(c) * 4 + i) * sP]
                                : (c == ones ? T(1) : Mb[(size_t(c - L) * R + r) * sP]);
              uw[i] = u[r] * winv;
              um[i] = uw[i] * m;
            }
            const T suw = ((uw[0] + uw[1]) + uw[2]) + uw[3];
            const T su_k = ((u[4 * k] + u[4 * k + 1]) + u[4 * k + 2]) + u[4 * k + 3];
            su = k == 0 ? su_k : su + su_k;
            g[j][k] = (((um[0] + um[1]) + um[2]) + um[3]) - quarter * (suw * ES_AT(c, k));
          }
        } else {
          T num = T(0);
          for (int k = 0; k < K; ++k) {
            const T su_k = ((u[4 * k] + u[4 * k + 1]) + u[4 * k + 2]) + u[4 * k + 3];
            su = k == 0 ? su_k : su + su_k;
            num += sh.rates[k] * (third * (su_k * ES_AT(kid[j], k)) - four_thirds * d[k]);
          }
          g[j][0] = winv * num;
        }
        const T sc = su > T(0) ? su : T(1);
        for (int r = 0; r < R; ++r) U_AT(kid[j], r) = u[r] / sc;
      }
    }
    for (int j = 0; j < 3; ++j) {
      for (int i = 0; i < G; ++i) {
        const T v = warp_sum(g[j][i]);
        if (lane == 0) sh.gsum[(warp * N1 + kid[j]) * G + i] = v;
      }
    }
  }
#undef E_AT
#undef ES_AT
#undef U_AT

  __syncthreads();
  const size_t blk = size_t(b) * gridDim.x + blockIdx.x;
  for (int h = threadIdx.x; h < H; h += kThreads) {
    T acc = sh.lsum[h];
    for (int v = 1; v < kWarps; ++v) acc += sh.lsum[v * H + h];
    root_part[blk * H + h] = acc;
  }
  for (int i = threadIdx.x; i < N1 * G; i += kThreads) {
    const int n = i / G;
    T acc = T(0);
    if (n != root && n != ones) {
      acc = sh.gsum[i];
      for (int v = 1; v < kWarps; ++v) acc += sh.gsum[v * N1 * G + i];
    }
    edge_part[blk * N1 * G + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// The slab route of K1 and K3: the first design of both, one thread per
// (tree, pattern) over (B, N1, 4K, P) scratch slabs in device memory, bound
// by that traffic and by the dependent loads along both node loops. It is
// kept only for trees whose on-chip plan (below) cannot hold a tile of 32
// patterns in shared memory (at double precision and K = 8, beyond 30 taxa;
// at float and K = 1, beyond 433 taxa); ops/pruning_jc.py
// chooses it from the plan and counts it as "ll_grad_jc69_slab" /
// "ll_dea_jc69_slab". Its arithmetic is the on-chip kernels', value for
// value.
// ---------------------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
jc69_ll_grad_slab_kernel(const int* __restrict__ post_children,
                         const T* __restrict__ em, const T* __restrict__ rates,
                         const T* __restrict__ props, const T* __restrict__ tips,
                         const T* __restrict__ weights, T* __restrict__ E,
                         T* __restrict__ ES, T* __restrict__ U,
                         T* __restrict__ ll_part, T* __restrict__ grad_part, int L,
                         int S, int N1, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  forward_and_upper<T, K, false>(smem, post_children, em, rates, props, tips, weights, E, ES,
                                 nullptr, U, ll_part, grad_part, L, S, N1, P);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
jc69_dea_slab_kernel(const int* __restrict__ post_children, const T* __restrict__ em,
                     const T* __restrict__ props, const T* __restrict__ tips,
                     const T* __restrict__ weights, T* __restrict__ E,
                     T* __restrict__ ES, T* __restrict__ M, T* __restrict__ U,
                     T* __restrict__ dprops_part, T* __restrict__ dea_part, int L,
                     int S, int N1, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  forward_and_upper<T, K, true>(smem, post_children, em, nullptr, props, tips, weights, E, ES, M,
                                U, dprops_part, dea_part, L, S, N1, P);
}

// ---------------------------------------------------------------------------
// The on-chip design of K1 and K3 (K2 runs its forward half). A block owns
// one tree and one tile of kOnchipTile = 32 patterns (one warp, a thread per
// pattern) and keeps the tile's whole pruning state in shared memory
// across both passes, pattern innermost, so that the 32 lanes of a warp hit
// 32 banks. Nothing of size (B, ., ., P) exists. What is stored, per
// pattern, is only what cannot be recomputed exactly: the E rows of the
// internal nodes other than the root, S - 1 rows of 4K values. In the upper
// pass U[kid] overwrites E[kid]: E[kid] is last read at its parent's upper
// step, where all three kids' E are loaded into registers before any U is
// written. The root's E is never read (the root is nobody's child), nor is
// any U of a leaf. The tree's schedule row and exp factors are staged with
// cp.async at block start.
// What is recomputed where it is used, with the same operations in the same
// order as the slab route stores it, so with the same values:
//   * a leaf's E, from its tip and em (e tip_i + (m/4) rowsum(tip)),
//     and its row sum S_E, the tip's row sum. The tips are read from device
//     memory through the read-only cache, not staged: a staged tips tile
//     (4L values per pattern) more than doubled the state at DS1 K = 1 and
//     halved the blocks an SM holds, and K1 ran 0.50 ms with it against
//     0.41 ms without (B = 512 f32, H100 80GB HBM3 at 700 W; PERF.md). The
//     tree is the fast grid index, so the blocks an SM holds mostly share a
//     tile's tips;
//   * the ones slot, the constant 1 (S_E = 4);
//   * S_E of an internal kid c at its parent's upper step, and K3's
//     pre-apply partial M[c] = ((E[c0] E[c1]) E[c2]) inv_c there too, from
//     c's children's E, which the upper pass has not overwritten yet (it
//     reaches c only after c's parent);
//   * U[root] = props / 4, and S_E[root], kept in registers from the last
//     forward step.
// The per-pattern state is (S - 1) 4K values (DS1 f32 K = 1: 384 B, so a
// tile takes 12 KB and 16 blocks share an SM; DS1 f64 K = 8: 6.1 KB, so a
// tile takes 197 KB of the 227 KB a block may use). Shared memory caps an
// SM at about 16 warps whatever the tile's width, so the tile is the
// smallest, a compile-time 32: every shared row's offset is then an
// immediate, where a runtime width cost an address computation per load. Each
// thread reads and writes only its own pattern column, so the node loops
// need no barrier; the cross-pattern sums go warp butterfly -> per-warp
// shared slot -> per-tile partial, in a fixed order, with no atomics.
// Route for larger trees (the plan cannot hold 32 patterns): the slab
// route above, chosen by ops/pruning_jc.py from the plan, rather than rows
// spilled to a global scratch: it keeps one body per route and refuses no
// shape the first design took.
// Bound on this card: the arithmetic of the work, about 0.021 ms (K1) and
// 0.024 ms (K3) at B = 512 DS1 f32 K = 1, above the on-chip design's
// shared-memory traffic (about 1.1 GB, 0.037 ms at the SMs' aggregate
// 29.7 TB/s); chip_smoke.py computes both from its inputs. Measured about
// 0.35 ms (6% of the bound): each thread walks 50 dependent node steps, and
// the SASS of K1<float, 1> holds 1.2k integer and address instructions
// (leaf, internal and ones-slot cases of every row, device-memory tip
// addresses) beside 0.5k floating-point ones; the design does nothing about
// that instruction overhead yet (PERF.md, open questions).
// ---------------------------------------------------------------------------

// Bytes of shared memory the on-chip K2 (G = 0), K1 (G = 1) or K3 (G = K)
// takes for a tile of TP patterns; ops/pruning_jc.py onchip_plan computes
// the same sum.
template <typename T>
__host__ __device__ size_t onchip_bytes(int S, int N1, int K, int G, int TP) {
  const size_t W = size_t(TP) / 32;
  return sizeof(T) * (size_t(N1) * K + 2 * size_t(K) + W * N1 * G + W * K +
                      (size_t(S) - 1) * 4 * K * TP) +
         sizeof(int) * 3 * size_t(S);
}

// One thread's view of the on-chip state: the shared tables, its own
// pattern column of the E/U slots (rows kOnchipTile apart) and of the tips
// in device memory (rows P apart, read through the read-only cache).
template <typename T, int K>
struct OnChip {
  const T* em;     // N1 * K
  const T* props;  // K
  T* slot;         // (S - 1) * 4K rows: E, then U, of internal node L + s
  const T* tip;    // L * 4 rows
  const int* pc;   // 3 * S
  int L, S, N1, P;

  __device__ __forceinline__ T& at(int node, int r) const {
    return slot[((node - L) * 4 * K + r) * kOnchipTile];
  }
  __device__ __forceinline__ T tip_at(int leaf, int i) const {
    return __ldg(tip + (leaf * 4 + i) * P);
  }

  // E row of node c (4K values) for this thread's pattern: stored for an
  // internal node, recomputed for a leaf, the constant 1 for the ones slot.
  __device__ __forceinline__ void row(int c, T* out) const {
    if (c >= L) {
      if (c == N1 - 1) {
#pragma unroll
        for (int r = 0; r < 4 * K; ++r) out[r] = T(1);
      } else {
#pragma unroll
        for (int r = 0; r < 4 * K; ++r) out[r] = at(c, r);
      }
      return;
    }
    T t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i] = tip_at(c, i);
    const T rt = ((t[0] + t[1]) + t[2]) + t[3];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T m = em[c * K + k];
      const T e = T(1) - m;
      const T cl = (m * T(0.25)) * rt;
#pragma unroll
      for (int i = 0; i < 4; ++i) out[4 * k + i] = e * t[i] + cl;
    }
  }

  // prod = (E[c0] E[c1]) E[c2] of combine step s, its per-category row sums
  // rs and the step's rescale: returns inv (1 on steps that do not rescale)
  // and adds log(scale) to *logscale when it is given.
  __device__ __forceinline__ T combine(int s, T* prod, T* rs, T* logscale) const {
    T a[4 * K];
    row(pc[3 * s], prod);
    row(pc[3 * s + 1], a);
#pragma unroll
    for (int r = 0; r < 4 * K; ++r) prod[r] = prod[r] * a[r];
    row(pc[3 * s + 2], a);
#pragma unroll
    for (int r = 0; r < 4 * K; ++r) prod[r] = prod[r] * a[r];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      rs[k] = ((prod[4 * k] + prod[4 * k + 1]) + prod[4 * k + 2]) + prod[4 * k + 3];
    }
    // Odd steps and the last step rescale (as forward_pass).
    if ((s & 1) || (s == S - 1)) {
      T scale = rs[0];
#pragma unroll
      for (int k = 1; k < K; ++k) scale += rs[k];
      scale = scale > T(0) ? scale : T(1);
      if (logscale != nullptr) *logscale += log_t(scale);
      return T(1) / scale;
    }
    return T(1);
  }
};

// The forward pass of one pattern column: the S combine steps, each storing
// E[node] (the root's is not stored). Returns the log scale and leaves the
// root's S_E in es_root.
template <typename T, int K>
__device__ __forceinline__ T forward_onchip(const OnChip<T, K>& o, T* es_root) {
  T logscale = T(0);
  for (int s = 0; s < o.S; ++s) {
    T prod[4 * K], rs[K];
    const bool do_scale = (s & 1) || (s == o.S - 1);
    const T inv = o.combine(s, prod, rs, &logscale);
    if (s == o.S - 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) es_root[k] = do_scale ? rs[k] * inv : rs[k];
      break;
    }
    const int node = o.L + s;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T m = o.em[node * K + k];
      const T e = T(1) - m;
      const T c = (m * T(0.25)) * rs[k];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const T v = e * prod[4 * k + i] + c;
        o.at(node, 4 * k + i) = do_scale ? v * inv : v;
      }
    }
  }
  return logscale;
}

// The on-chip kernels' shared memory, carved in onchip_bytes' order: the
// tree's exp factors, rates and props, the warps' G values per node and K at
// the root, the E/U slot rows, and the schedule row.
template <typename T>
struct OnChipShared {
  T* em;     // N1 * K
  T* rates;  // K
  T* props;  // K
  T* gsum;   // W * N1 * G
  T* lsum;   // W * K
  T* slot;   // (S - 1) * 4K * kOnchipTile
  int* pc;   // 3 * S
};

// Carve shared memory, stage the tree's schedule row and exp factors with
// cp.async, set the category tables and zero the edge sums.
template <typename T, int K, int G>
__device__ __forceinline__ OnChipShared<T> stage_onchip(
    unsigned char* smem, const int* __restrict__ post_children, const T* __restrict__ em,
    const T* __restrict__ rates, const T* __restrict__ props, int b, int S, int N1) {
  constexpr int TP = kOnchipTile;
  constexpr int W = TP / 32;
  const int tid = threadIdx.x;
  OnChipShared<T> sh;
  sh.em = reinterpret_cast<T*>(smem);
  sh.rates = sh.em + N1 * K;
  sh.props = sh.rates + K;
  sh.gsum = sh.props + K;
  sh.lsum = sh.gsum + W * N1 * G;
  sh.slot = sh.lsum + W * K;
  sh.pc = reinterpret_cast<int*>(sh.slot + size_t(S - 1) * 4 * K * TP);
  for (int i = tid; i < 3 * S; i += TP) {
    cp_async<sizeof(int)>(sh.pc + i, post_children + size_t(b) * 3 * S + i);
  }
  for (int i = tid; i < N1 * K; i += TP) {
    cp_async<sizeof(T)>(sh.em + i, em + size_t(b) * N1 * K + i);
  }
  for (int i = tid; i < K; i += TP) {
    sh.rates[i] = rates == nullptr ? T(0) : rates[i];
    sh.props[i] = props[i];
  }
  for (int i = tid; i < W * N1 * G; i += TP) sh.gsum[i] = T(0);
  cp_async_wait_all();
  __syncthreads();
  return sh;
}

// The body of the on-chip K1 (kDea = false) and K3 (kDea = true): what
// forward_and_upper computes, value for value, with the state on chip.
template <typename T, int K, bool kDea>
__device__ __forceinline__ void forward_and_upper_onchip(
    unsigned char* smem, const int* __restrict__ post_children, const T* __restrict__ em,
    const T* __restrict__ rates, const T* __restrict__ props, const T* __restrict__ tips,
    const T* __restrict__ weights, T* __restrict__ root_part, T* __restrict__ edge_part,
    int L, int S, int N1, int P) {
  constexpr int R = 4 * K;
  constexpr int G = kDea ? K : 1;  // values per edge
  constexpr int H = kDea ? K : 1;  // values at the root
  constexpr int TP = kOnchipTile;
  constexpr int W = TP / 32;
  const int tid = threadIdx.x;
  // The tree is the fast grid index, so the blocks an SM holds at once
  // mostly share one tile and its tips stay in cache.
  const int b = blockIdx.x;
  const int p = blockIdx.y * TP + tid;
  const bool active = p < P;
  const int warp = tid >> 5, lane = tid & 31;
  const int root = L + S - 1;
  const int ones = N1 - 1;
  const T quarter = T(0.25);
  const T tiny = T(1e-30);
  const T third = T(1.0 / 3.0);
  const T four_thirds = T(4.0 / 3.0);

  const OnChipShared<T> sh =
      stage_onchip<T, K, G>(smem, post_children, em, rates, props, b, S, N1);
  const T* s_em = sh.em;
  const T* s_rates = sh.rates;
  const T* s_props = sh.props;
  T* gsum = sh.gsum;
  T* lsum = sh.lsum;
  const int* s_pc = sh.pc;
  const OnChip<T, K> o{s_em, s_props, sh.slot + tid, tips + p, s_pc, L, S, N1, P};

  T hv[H];
#pragma unroll
  for (int h = 0; h < H; ++h) hv[h] = T(0);
  const T w = active ? weights[p] : T(0);
  if (active) {
    T es_root[K] = {};
    const T logscale = forward_onchip<T, K>(o, es_root);
    T site = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) site += (s_props[k] * quarter) * es_root[k];
    site = site > tiny ? site : tiny;
    if constexpr (kDea) {
      const T w_over_site = w / site;
#pragma unroll
      for (int k = 0; k < K; ++k) hv[k] = (quarter * es_root[k]) * w_over_site;
    } else {
      hv[0] = w * (log_t(site) + logscale);
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const T v = warp_sum(hv[h]);
    if (lane == 0) lsum[warp * H + h] = v;
  }

  for (int t = 0; t < S; ++t) {
    const int node = root - t;
    const int s = node - L;
    const int kid[3] = {s_pc[3 * s], s_pc[3 * s + 1], s_pc[3 * s + 2]};
    T g[3][G];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int i = 0; i < G; ++i) g[j][i] = T(0);
    }
    if (active) {
      // P^T U[node] = P U[node]; U[root] = props / 4. For K = 1 the rows of
      // U sum to exactly 1, so the row-sum operand is the scalar 1.
      T ev[R];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        T un[4];
        if (node == root) {
#pragma unroll
          for (int i = 0; i < 4; ++i) un[i] = s_props[k] * quarter;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) un[i] = o.at(node, 4 * k + i);
        }
        const T m = s_em[node * K + k];
        const T e = T(1) - m;
        const T rsu = K == 1 ? T(1) : ((un[0] + un[1]) + un[2]) + un[3];
        const T c = (m * quarter) * rsu;
#pragma unroll
        for (int i = 0; i < 4; ++i) ev[4 * k + i] = e * un[i] + c;
      }
      T e0[R], e1[R], e2[R];
      o.row(kid[0], e0);
      o.row(kid[1], e1);
      o.row(kid[2], e2);
      // Shared denominator: u_c . E_c = ev . e0 e1 e2 for every child c.
      T d[K];
      T denom = T(0);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        T acc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * k + i;
          acc[i] = ev[r] * ((e0[r] * e1[r]) * e2[r]);
        }
        d[k] = ((acc[0] + acc[1]) + acc[2]) + acc[3];
        denom = k == 0 ? d[0] : denom + d[k];
      }
      const T winv = w / (denom > tiny ? denom : tiny);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int c = kid[j];
        if (c == ones) continue;  // its edge is no edge; its U is never read
        T u[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T mab = j == 0 ? e1[r] * e2[r] : (j == 1 ? e0[r] * e2[r] : e0[r] * e1[r]);
          u[r] = ev[r] * mab;
        }
        // The kid's S_E and (K3) its pre-apply partial M: the tip for a
        // leaf (every category), recomputed from its children for an
        // internal node.
        T es[K], m[R];
        if (c < L) {
          T tp[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) tp[i] = o.tip_at(c, i);
          const T rt = ((tp[0] + tp[1]) + tp[2]) + tp[3];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            es[k] = rt;
#pragma unroll
            for (int i = 0; i < 4; ++i) m[4 * k + i] = tp[i];
          }
        } else {
          T rs[K];
          const int sc_ = c - L;
          const bool do_scale = (sc_ & 1) || (sc_ == S - 1);
          const T inv = o.combine(sc_, m, rs, nullptr);
#pragma unroll
          for (int k = 0; k < K; ++k) es[k] = do_scale ? rs[k] * inv : rs[k];
          if constexpr (kDea) {
            if (do_scale) {
#pragma unroll
              for (int r = 0; r < R; ++r) m[r] = m[r] * inv;
            }
          }
        }
        T su = T(0);
        if constexpr (kDea) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            T uw[4], um[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              uw[i] = u[4 * k + i] * winv;
              um[i] = uw[i] * m[4 * k + i];
            }
            const T suw = ((uw[0] + uw[1]) + uw[2]) + uw[3];
            const T su_k = ((u[4 * k] + u[4 * k + 1]) + u[4 * k + 2]) + u[4 * k + 3];
            su = k == 0 ? su_k : su + su_k;
            g[j][k] = (((um[0] + um[1]) + um[2]) + um[3]) - quarter * (suw * es[k]);
          }
        } else {
          T num = T(0);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const T su_k = ((u[4 * k] + u[4 * k + 1]) + u[4 * k + 2]) + u[4 * k + 3];
            su = k == 0 ? su_k : su + su_k;
            num += s_rates[k] * (third * (su_k * es[k]) - four_thirds * d[k]);
          }
          g[j][0] = winv * num;
        }
        if (c >= L) {
          const T sc = su > T(0) ? su : T(1);
#pragma unroll
          for (int r = 0; r < R; ++r) o.at(c, r) = u[r] / sc;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const T v = warp_sum(g[j][i]);
        if (lane == 0) gsum[(warp * N1 + kid[j]) * G + i] = v;
      }
    }
  }

  __syncthreads();
  const size_t blk = size_t(b) * gridDim.y + blockIdx.y;
  for (int h = tid; h < H; h += TP) {
    T acc = lsum[h];
    for (int v = 1; v < W; ++v) acc += lsum[v * H + h];
    root_part[blk * H + h] = acc;
  }
  for (int i = tid; i < N1 * G; i += TP) {
    const int n = i / G;
    T acc = T(0);
    if (n != root && n != ones) {
      acc = gsum[i];
      for (int v = 1; v < W; ++v) acc += gsum[v * N1 * G + i];
    }
    edge_part[blk * N1 * G + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// K2: LL only, the primal of the LL's custom VJP (its backward is K3).
// Replaces the TPU kernel libsbn_tpu/ops/pruning_pallas_jc.py:431
// _fwd_ll_kernel, which kept E and ES in VMEM scratch of shape (N1, 4K,
// tile). Design: the on-chip K1's forward pass alone (forward_onchip), in
// the same shared-memory plan with no edge sums (G = 0): a block owns one
// tree and one tile of 32 patterns, stores the E rows of the S - 1 internal
// nodes below the root, recomputes leaves and the ones slot where they are
// read, keeps the root's S_E in registers and sums the tile's LL with one
// warp butterfly. Nothing of size (B, ., ., P) exists; a tree beyond the
// plan takes jc69_ll_slab_kernel.
// Bound on this card: arithmetic, about 0.0075 ms at B = 512 DS1 f32 K = 1
// (chip_smoke.py computes it from its inputs). Measured 0.10 ms there (7%
// of the bound) and 0.45 ms at Weibull+4, against 0.52 and 2.80 ms for
// the first design, which was bound by its E and ES slab traffic (about
// 0.5 GB a call), in the same run (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// Like K1 it is held back by its instruction stream: 984 SASS
// instructions, 562 of them integer and address work.
// ---------------------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(kOnchipTile)
jc69_ll_kernel(const int* __restrict__ post_children, const T* __restrict__ em,
               const T* __restrict__ props, const T* __restrict__ tips,
               const T* __restrict__ weights, T* __restrict__ ll_part, int L, int S, int N1,
               int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;  // the tree is the fast grid index, as in K1
  const int p = blockIdx.y * kOnchipTile + tid;
  const OnChipShared<T> sh =
      stage_onchip<T, K, 0>(smem, post_children, em, nullptr, props, b, S, N1);
  T ll = T(0);
  if (p < P) {
    const OnChip<T, K> o{sh.em, sh.props, sh.slot + tid, tips + p, sh.pc, L, S, N1, P};
    T es_root[K] = {};
    const T logscale = forward_onchip<T, K>(o, es_root);
    T site = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) site += (sh.props[k] * T(0.25)) * es_root[k];
    site = site > T(1e-30) ? site : T(1e-30);
    ll = weights[p] * (log_t(site) + logscale);
  }
  ll = warp_sum(ll);
  if (tid == 0) ll_part[size_t(b) * gridDim.y + blockIdx.y] = ll;
}

// ---------------------------------------------------------------------------
// K1: LL and the branch gradient d LL / d b_e for every edge, in one pass.
// Replaces the TPU kernel libsbn_tpu/ops/pruning_pallas_jc.py:214 _kernel,
// which kept E, ES, U and G in VMEM scratch of shape (N1, 4K, tile); this
// design keeps the same working set in shared memory (see above).
// Bound on this card: arithmetic, about 0.021 ms at B = 512 DS1 f32 K = 1
// (shared-memory traffic 0.037 ms); measured about 0.35 ms (see above). The
// first design was bound by device-memory slab traffic (2.57 GB, 0.77 ms)
// and took 0.99 ms in the same run.
// ---------------------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(kOnchipTile)
jc69_ll_grad_kernel(const int* __restrict__ post_children, const T* __restrict__ em,
                    const T* __restrict__ rates, const T* __restrict__ props,
                    const T* __restrict__ tips, const T* __restrict__ weights,
                    T* __restrict__ ll_part, T* __restrict__ grad_part, int L, int S,
                    int N1, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  forward_and_upper_onchip<T, K, false>(smem, post_children, em, rates, props, tips, weights,
                                        ll_part, grad_part, L, S, N1, P);
}

// ---------------------------------------------------------------------------
// K3: d ll / d e per (node, category) and d ll / d props, the backward half
// of the LL's custom VJP (its forward half is K2). Replaces the TPU kernel
// libsbn_tpu/ops/pruning_pallas_jc.py:447 _bwd_dea_kernel. It recomputes the
// forward pass (remat: the caller saves only the inputs) and stores no M:
// each internal kid's M is recomputed at its parent's upper step.
// Bound on this card: arithmetic, about 0.024 ms at B = 512 DS1 f32 K = 1
// (shared-memory traffic as K1's); measured about 0.35 ms (see above). The
// first design was bound by device-memory slab traffic (E, ES, U and M,
// about 1.3x K1's) and took 1.26 ms in the same run.
// ---------------------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(kOnchipTile)
jc69_dea_kernel(const int* __restrict__ post_children, const T* __restrict__ em,
                const T* __restrict__ props, const T* __restrict__ tips,
                const T* __restrict__ weights, T* __restrict__ dprops_part,
                T* __restrict__ dea_part, int L, int S, int N1, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  forward_and_upper_onchip<T, K, true>(smem, post_children, em, nullptr, props, tips, weights,
                                       dprops_part, dea_part, L, S, N1, P);
}

template <typename Kern>
cudaError_t prepare(Kern kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(smem));
  }
  return cudaSuccess;
}

template <typename T, int K>
int launch_ll_slab(const int* pc, const T* em, const T* props, const T* tips, const T* w, T* E,
                   T* ES, T* ll_part, int B, int L, int S, int N1, int P, cudaStream_t st) {
  const size_t smem = shared_bytes<T>(S, N1, K, 1);
  cudaError_t err = prepare(jc69_ll_slab_kernel<T, K>, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  jc69_ll_slab_kernel<T, K><<<grid, kThreads, smem, st>>>(pc, em, props, tips, w, E, ES, ll_part,
                                                          L, S, N1, P);
  return int(cudaGetLastError());
}

template <typename T, int K>
int launch_ll_grad_slab(const int* pc, const T* em, const T* rates, const T* props,
                        const T* tips, const T* w, T* E, T* ES, T* U, T* ll_part, T* grad_part,
                        int B, int L, int S, int N1, int P, cudaStream_t st) {
  const size_t smem = shared_bytes<T>(S, N1, K, 1);
  cudaError_t err = prepare(jc69_ll_grad_slab_kernel<T, K>, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  jc69_ll_grad_slab_kernel<T, K><<<grid, kThreads, smem, st>>>(
      pc, em, rates, props, tips, w, E, ES, U, ll_part, grad_part, L, S, N1, P);
  return int(cudaGetLastError());
}

template <typename T, int K>
int launch_dea_slab(const int* pc, const T* em, const T* props, const T* tips, const T* w,
                    T* E, T* ES, T* M, T* U, T* dprops_part, T* dea_part, int B, int L, int S,
                    int N1, int P, cudaStream_t st) {
  const size_t smem = shared_bytes<T>(S, N1, K, K);
  cudaError_t err = prepare(jc69_dea_slab_kernel<T, K>, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  jc69_dea_slab_kernel<T, K><<<grid, kThreads, smem, st>>>(pc, em, props, tips, w, E, ES, M, U,
                                                           dprops_part, dea_part, L, S, N1, P);
  return int(cudaGetLastError());
}

// The on-chip kernels take the plan's tile TP and shared-memory bytes from
// the caller, and refuse a plan that does not hold what they carve.
inline bool plan_ok(int TP, size_t smem, size_t need) {
  return TP == kOnchipTile && smem >= need && smem <= kMaxShared;
}

template <typename T, int K>
int launch_ll(const int* pc, const T* em, const T* props, const T* tips, const T* w, T* ll_part,
              int B, int L, int S, int N1, int P, int TP, int smem, cudaStream_t st) {
  if (!plan_ok(TP, size_t(smem), onchip_bytes<T>(S, N1, K, 0, TP))) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare(jc69_ll_kernel<T, K>, size_t(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(B, (P + TP - 1) / TP);
  jc69_ll_kernel<T, K><<<grid, TP, smem, st>>>(pc, em, props, tips, w, ll_part, L, S, N1, P);
  return int(cudaGetLastError());
}

template <typename T, int K>
int launch_ll_grad(const int* pc, const T* em, const T* rates, const T* props, const T* tips,
                   const T* w, T* ll_part, T* grad_part, int B, int L, int S, int N1, int P,
                   int TP, int smem, cudaStream_t st) {
  if (!plan_ok(TP, size_t(smem), onchip_bytes<T>(S, N1, K, 1, TP))) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare(jc69_ll_grad_kernel<T, K>, size_t(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(B, (P + TP - 1) / TP);
  jc69_ll_grad_kernel<T, K><<<grid, TP, smem, st>>>(pc, em, rates, props, tips, w, ll_part,
                                                    grad_part, L, S, N1, P);
  return int(cudaGetLastError());
}

template <typename T, int K>
int launch_dea(const int* pc, const T* em, const T* props, const T* tips, const T* w,
               T* dprops_part, T* dea_part, int B, int L, int S, int N1, int P, int TP, int smem,
               cudaStream_t st) {
  if (!plan_ok(TP, size_t(smem), onchip_bytes<T>(S, N1, K, K, TP))) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare(jc69_dea_kernel<T, K>, size_t(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(B, (P + TP - 1) / TP);
  jc69_dea_kernel<T, K><<<grid, TP, smem, st>>>(pc, em, props, tips, w, dprops_part, dea_part, L,
                                                S, N1, P);
  return int(cudaGetLastError());
}

// Runtime K -> template K.
#define LSBN_DISPATCH_K(K, CALL) \
  switch (K) {                   \
    case 1: return CALL(1);      \
    case 2: return CALL(2);      \
    case 3: return CALL(3);      \
    case 4: return CALL(4);      \
    case 5: return CALL(5);      \
    case 6: return CALL(6);      \
    case 7: return CALL(7);      \
    case 8: return CALL(8);      \
    default: return int(cudaErrorInvalidValue); \
  }

template <typename T>
int ll_entry(const void* pc, const void* em, const void* props, const void* tips, const void* w,
             void* ll_part, int B, int L, int S, int N1, int K, int P, int TP, int smem,
             void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define LSBN_CALL(KK)                                                                      \
  launch_ll<T, KK>(static_cast<const int*>(pc), static_cast<const T*>(em),                \
                   static_cast<const T*>(props), static_cast<const T*>(tips),              \
                   static_cast<const T*>(w), static_cast<T*>(ll_part), B, L, S, N1, P, TP, \
                   smem, st)
  LSBN_DISPATCH_K(K, LSBN_CALL)
#undef LSBN_CALL
}

template <typename T>
int ll_slab_entry(const void* pc, const void* em, const void* props, const void* tips,
                  const void* w, void* E, void* ES, void* ll_part, int B, int L, int S, int N1,
                  int K, int P, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define LSBN_CALL(KK)                                                                       \
  launch_ll_slab<T, KK>(static_cast<const int*>(pc), static_cast<const T*>(em),            \
                        static_cast<const T*>(props), static_cast<const T*>(tips),          \
                        static_cast<const T*>(w), static_cast<T*>(E), static_cast<T*>(ES),  \
                        static_cast<T*>(ll_part), B, L, S, N1, P, st)
  LSBN_DISPATCH_K(K, LSBN_CALL)
#undef LSBN_CALL
}

template <typename T>
int ll_grad_entry(const void* pc, const void* em, const void* rates, const void* props,
                  const void* tips, const void* w, void* ll_part, void* grad_part, int B, int L,
                  int S, int N1, int K, int P, int TP, int smem, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define LSBN_CALL(KK)                                                                       \
  launch_ll_grad<T, KK>(static_cast<const int*>(pc), static_cast<const T*>(em),            \
                        static_cast<const T*>(rates), static_cast<const T*>(props),         \
                        static_cast<const T*>(tips), static_cast<const T*>(w),              \
                        static_cast<T*>(ll_part), static_cast<T*>(grad_part), B, L, S, N1, \
                        P, TP, smem, st)
  LSBN_DISPATCH_K(K, LSBN_CALL)
#undef LSBN_CALL
}

template <typename T>
int dea_entry(const void* pc, const void* em, const void* props, const void* tips, const void* w,
              void* dprops_part, void* dea_part, int B, int L, int S, int N1, int K, int P,
              int TP, int smem, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define LSBN_CALL(KK)                                                                   \
  launch_dea<T, KK>(static_cast<const int*>(pc), static_cast<const T*>(em),            \
                    static_cast<const T*>(props), static_cast<const T*>(tips),          \
                    static_cast<const T*>(w), static_cast<T*>(dprops_part),             \
                    static_cast<T*>(dea_part), B, L, S, N1, P, TP, smem, st)
  LSBN_DISPATCH_K(K, LSBN_CALL)
#undef LSBN_CALL
}

template <typename T>
int ll_grad_slab_entry(const void* pc, const void* em, const void* rates, const void* props,
                       const void* tips, const void* w, void* E, void* ES, void* U,
                       void* ll_part, void* grad_part, int B, int L, int S, int N1, int K, int P,
                       void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define LSBN_CALL(KK)                                                                         \
  launch_ll_grad_slab<T, KK>(static_cast<const int*>(pc), static_cast<const T*>(em),         \
                             static_cast<const T*>(rates), static_cast<const T*>(props),      \
                             static_cast<const T*>(tips), static_cast<const T*>(w),           \
                             static_cast<T*>(E), static_cast<T*>(ES), static_cast<T*>(U),     \
                             static_cast<T*>(ll_part), static_cast<T*>(grad_part), B, L, S,  \
                             N1, P, st)
  LSBN_DISPATCH_K(K, LSBN_CALL)
#undef LSBN_CALL
}

template <typename T>
int dea_slab_entry(const void* pc, const void* em, const void* props, const void* tips,
                   const void* w, void* E, void* ES, void* M, void* U, void* dprops_part,
                   void* dea_part, int B, int L, int S, int N1, int K, int P, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define LSBN_CALL(KK)                                                                        \
  launch_dea_slab<T, KK>(static_cast<const int*>(pc), static_cast<const T*>(em),            \
                         static_cast<const T*>(props), static_cast<const T*>(tips),          \
                         static_cast<const T*>(w), static_cast<T*>(E), static_cast<T*>(ES),  \
                         static_cast<T*>(M), static_cast<T*>(U),                              \
                         static_cast<T*>(dprops_part), static_cast<T*>(dea_part), B, L, S,   \
                         N1, P, st)
  LSBN_DISPATCH_K(K, LSBN_CALL)
#undef LSBN_CALL
}

}  // namespace

extern "C" {

// Patterns per block of the slab routes: the width of one partial-sum tile.
int lsbn_jc69_tile() { return kThreads; }
int lsbn_jc69_max_k() { return kMaxK; }
const char* lsbn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K2 on chip: the plan's tile TP and shared-memory bytes come from the
// caller (ops/pruning_jc.py onchip_plan, kind "ll").
int lsbn_jc69_ll_f32(const void* pc, const void* em, const void* props, const void* tips,
                     const void* w, void* ll_part, int B, int L, int S, int N1, int K, int P,
                     int TP, int smem, void* stream) {
  return ll_entry<float>(pc, em, props, tips, w, ll_part, B, L, S, N1, K, P, TP, smem, stream);
}

int lsbn_jc69_ll_f64(const void* pc, const void* em, const void* props, const void* tips,
                     const void* w, void* ll_part, int B, int L, int S, int N1, int K, int P,
                     int TP, int smem, void* stream) {
  return ll_entry<double>(pc, em, props, tips, w, ll_part, B, L, S, N1, K, P, TP, smem, stream);
}

// K1 on chip: the plan's tile TP and shared-memory bytes come from the
// caller (ops/pruning_jc.py onchip_plan).
int lsbn_jc69_ll_grad_f32(const void* pc, const void* em, const void* rates, const void* props,
                          const void* tips, const void* w, void* ll_part, void* grad_part,
                          int B, int L, int S, int N1, int K, int P, int TP, int smem,
                          void* stream) {
  return ll_grad_entry<float>(pc, em, rates, props, tips, w, ll_part, grad_part, B, L, S, N1, K,
                              P, TP, smem, stream);
}

int lsbn_jc69_ll_grad_f64(const void* pc, const void* em, const void* rates, const void* props,
                          const void* tips, const void* w, void* ll_part, void* grad_part,
                          int B, int L, int S, int N1, int K, int P, int TP, int smem,
                          void* stream) {
  return ll_grad_entry<double>(pc, em, rates, props, tips, w, ll_part, grad_part, B, L, S, N1,
                               K, P, TP, smem, stream);
}

// K3 on chip.
int lsbn_jc69_dea_f32(const void* pc, const void* em, const void* props, const void* tips,
                      const void* w, void* dprops_part, void* dea_part, int B, int L, int S,
                      int N1, int K, int P, int TP, int smem, void* stream) {
  return dea_entry<float>(pc, em, props, tips, w, dprops_part, dea_part, B, L, S, N1, K, P, TP,
                          smem, stream);
}

int lsbn_jc69_dea_f64(const void* pc, const void* em, const void* props, const void* tips,
                      const void* w, void* dprops_part, void* dea_part, int B, int L, int S,
                      int N1, int K, int P, int TP, int smem, void* stream) {
  return dea_entry<double>(pc, em, props, tips, w, dprops_part, dea_part, B, L, S, N1, K, P, TP,
                           smem, stream);
}

// The slab route of K2, K1 and K3 (tile kThreads), for trees beyond the
// plan.
int lsbn_jc69_ll_slab_f32(const void* pc, const void* em, const void* props, const void* tips,
                          const void* w, void* E, void* ES, void* ll_part, int B, int L, int S,
                          int N1, int K, int P, void* stream) {
  return ll_slab_entry<float>(pc, em, props, tips, w, E, ES, ll_part, B, L, S, N1, K, P, stream);
}

int lsbn_jc69_ll_slab_f64(const void* pc, const void* em, const void* props, const void* tips,
                          const void* w, void* E, void* ES, void* ll_part, int B, int L, int S,
                          int N1, int K, int P, void* stream) {
  return ll_slab_entry<double>(pc, em, props, tips, w, E, ES, ll_part, B, L, S, N1, K, P,
                               stream);
}

int lsbn_jc69_ll_grad_slab_f32(const void* pc, const void* em, const void* rates,
                               const void* props, const void* tips, const void* w, void* E,
                               void* ES, void* U, void* ll_part, void* grad_part, int B, int L,
                               int S, int N1, int K, int P, void* stream) {
  return ll_grad_slab_entry<float>(pc, em, rates, props, tips, w, E, ES, U, ll_part, grad_part,
                                   B, L, S, N1, K, P, stream);
}

int lsbn_jc69_ll_grad_slab_f64(const void* pc, const void* em, const void* rates,
                               const void* props, const void* tips, const void* w, void* E,
                               void* ES, void* U, void* ll_part, void* grad_part, int B, int L,
                               int S, int N1, int K, int P, void* stream) {
  return ll_grad_slab_entry<double>(pc, em, rates, props, tips, w, E, ES, U, ll_part, grad_part,
                                    B, L, S, N1, K, P, stream);
}

int lsbn_jc69_dea_slab_f32(const void* pc, const void* em, const void* props, const void* tips,
                           const void* w, void* E, void* ES, void* M, void* U, void* dprops_part,
                           void* dea_part, int B, int L, int S, int N1, int K, int P,
                           void* stream) {
  return dea_slab_entry<float>(pc, em, props, tips, w, E, ES, M, U, dprops_part, dea_part, B, L,
                               S, N1, K, P, stream);
}

int lsbn_jc69_dea_slab_f64(const void* pc, const void* em, const void* props, const void* tips,
                           const void* w, void* E, void* ES, void* M, void* U, void* dprops_part,
                           void* dea_part, int B, int L, int S, int N1, int K, int P,
                           void* stream) {
  return dea_slab_entry<double>(pc, em, props, tips, w, E, ES, M, U, dprops_part, dea_part, B, L,
                                S, N1, K, P, stream);
}

}  // extern "C"
