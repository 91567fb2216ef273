// The heights layer of rooted time trees for NVIDIA Hopper (sm_90a): the
// sweeps from height ratios to node heights, and their adjoint from the
// branch gradient to the ratio and clock gradients, one block a tree.
//
// Built by libsbn_tpu_torch/ops/_kernels.py as the other sources are (a
// plain C interface, bound with ctypes). Each entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
//
// No TPU kernel: the JAX package's heights (libsbn_tpu/ops/heights.py) are
// array ops that XLA fuses into the jitted rooted program. In PyTorch they
// are four small kernels a sweep and as many an adjoint sweep, a few
// hundred launches a call for fluA's 32 sweeps each way. The work is tiny
// (fluA x 256: 32 sweeps of 68 float64 updates a tree each way); each
// sweep waits on the last, so what bounds it is latency. The design keeps
// a tree's per-node values in shared memory, so a sweep costs a
// __syncthreads and not a launch, and the casts, pads and the rate scaling
// around the sweeps happen in the same pass.
//
// A tree whose per-node values do not fit a block's shared memory (more
// than 557 nodes need the opt-in above 48 KB; past 2,640 nodes the adjoint's
// do not fit at all, past 6,455 the forward's) runs the same code on a slab
// of global memory per tree, which the caller allocates (ops/heights.py
// tree_bytes): one block still walks one tree, so __syncthreads orders the
// slab's reads and writes as it does shared memory's. The route changes
// where the values live, not the arithmetic: both give the same bits.
//
// Layout (row-major; B trees of N nodes, leaves 0..L-1, internal nodes
// L..N-2, the root N-1; slot N is the ones slot):
//   ratios        (B, N - L)     f64  ratio of node L + j, the root height last
//   bounds        (B, N)         f64  each node's largest tip date below it
//   rates         (B, N - 1)     f64  per-branch clock rates
//   parent        (B, N - 1)     int32 each non-root node's parent
//   post_children (B, N - L, 3)  int32 children of node L + s, padded with N
//   heights       (B, N)         f64  the forward kernel's output
//   operand       (B, N + 1)     T    K1's branch lengths: (h[parent] - h)
//                                     rates rounded to T, then two zeros
//   grad          (B, N - 1)     T    K1's branch gradient, rows grad_stride
//                                     apart
//   dratios       (B, N - L)     T    d (LL + log-det-Jacobian) / d ratios
//   clock         (B, 1) or (B, N - 1) T  d LL / d rates, summed under a
//                                     strict clock
//   slab          (B, tree_bytes)     the slab route's per-tree values, or null
//
// The arithmetic is ops/heights.py's, step for step, in float64 whatever T
// is (forward_plain and adjoint_plain there are the twins): every product,
// sum and difference is rounded on its own (__dmul_rn, __dadd_rn,
// __dsub_rn: no contraction into fused multiply-adds), so the heights and
// K1's operand equal the torch sweeps' bit for bit. The adjoint sums a
// node's three children left to right, and the strict clock's sum runs in
// one warp: lane l adds the branches l, l + 32, ... in order, then the
// lanes fold by halves. No atomics: two runs agree bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;  // a block walks a tree's N + 1 slots in strides
constexpr int kMaxShared = 232448;  // bytes a block may use on sm_90

// A tree's per-node values (N + 1 slots each), from the front of its
// scratch: the forward kernel's two height buffers, bounds and ratios (f64)
// and parents (int32); the adjoint's heights, bounds, ratios, g rates,
// g_bl, the Jacobian's terms, two w buffers and W (f64), parents and the
// three children (int32). ops/heights.py tree_bytes gives their size; the
// caller passes it as tree_bytes, the shared memory of a launch on the
// shared route and the slab's stride on the slab route.
template <bool kSlab>
__device__ unsigned char* tree_scratch(unsigned char* shared, unsigned char* slab,
                                       int tree_bytes) {
  return kSlab ? slab + size_t(blockIdx.x) * size_t(tree_bytes) : shared;
}

template <typename T, bool kSlab>
__global__ void __launch_bounds__(kThreads)
heights_forward_kernel(const double* __restrict__ ratios, const double* __restrict__ bounds,
                       const double* __restrict__ rates, const int* __restrict__ parent,
                       double* __restrict__ heights, T* __restrict__ operand,
                       unsigned char* __restrict__ slab, int tree_bytes, int L, int N,
                       int n_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n1 = N + 1;
  const int R = N - L;
  double* h0 = reinterpret_cast<double*>(tree_scratch<kSlab>(smem, slab, tree_bytes));
  double* h1 = h0 + n1;
  double* b = h1 + n1;
  double* r = b + n1;
  int* p = reinterpret_cast<int*>(r + n1);
  const size_t tree = blockIdx.x;
  const double* rt = ratios + tree * R;
  const double root_height = rt[R - 1];
  // Leaves keep their bounds (their ratio is 0); the root and the ones slot
  // start at the root height, the root's parent is the slot, and the slot
  // (bound 0, ratio 1) keeps its value.
  for (int v = threadIdx.x; v < n1; v += blockDim.x) {
    const double bv = v < N ? bounds[tree * N + v] : 0.0;
    b[v] = bv;
    r[v] = v < L ? 0.0 : (v < N - 1 ? rt[v - L] : 1.0);
    p[v] = v < N - 1 ? parent[tree * (N - 1) + v] : N;
    const double hv = v < N - 1 ? bv : root_height;
    h0[v] = hv;
    h1[v] = hv;
  }
  __syncthreads();
  // h_v <- b_v + r_v (h[p_v] - b_v) over the internal nodes and the root,
  // from the last sweep's buffer into the other.
  double* src = h0;
  double* dst = h1;
  for (int it = 0; it < n_iters; ++it) {
    for (int v = L + threadIdx.x; v < N; v += blockDim.x) {
      dst[v] = __dadd_rn(b[v], __dmul_rn(r[v], __dsub_rn(src[p[v]], b[v])));
    }
    __syncthreads();
    double* t = src;
    src = dst;
    dst = t;
  }
  for (int v = threadIdx.x; v < n1; v += blockDim.x) {
    if (v < N) heights[tree * N + v] = src[v];
    operand[tree * n1 + v] =
        v < N - 1 ? T(__dmul_rn(__dsub_rn(src[p[v]], src[v]), rates[tree * (N - 1) + v]))
                  : T(0);
  }
}

template <typename T, bool kSlab>
__global__ void __launch_bounds__(kThreads)
heights_adjoint_kernel(const T* __restrict__ grad, const double* __restrict__ heights,
                       const double* __restrict__ bounds, const double* __restrict__ ratios,
                       const double* __restrict__ rates, const int* __restrict__ post_children,
                       const int* __restrict__ parent, T* __restrict__ dratios,
                       T* __restrict__ clock, unsigned char* __restrict__ slab, int tree_bytes,
                       int grad_stride, int L, int N, int n_iters, int strict) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n1 = N + 1;
  const int R = N - L;
  double* h = reinterpret_cast<double*>(tree_scratch<kSlab>(smem, slab, tree_bytes));
  double* b = h + n1;
  double* r = b + n1;
  double* c = r + n1;   // g, then d LL / d rate a branch: g (h[p] - h)
  double* x = c + n1;   // g_bl = g rates
  double* y = x + n1;   // the Jacobian's 1 / (h[p] - b) at internal non-root nodes
  double* w0 = y + n1;
  double* w1 = w0 + n1;
  double* W = w1 + n1;
  int* p = reinterpret_cast<int*>(W + n1);
  int* k0 = p + n1;
  int* k1 = k0 + n1;
  int* k2 = k1 + n1;
  const size_t tree = blockIdx.x;
  const double* rt = ratios + tree * R;
  for (int v = threadIdx.x; v < n1; v += blockDim.x) {
    b[v] = v < N ? bounds[tree * N + v] : 0.0;
    h[v] = v < N ? heights[tree * N + v] : 0.0;
    // r as the adjoint reads it: the root's 1, the ones slot's 0.
    r[v] = v < L ? 0.0 : (v < N - 1 ? rt[v - L] : (v == N - 1 ? 1.0 : 0.0));
    p[v] = v < N - 1 ? parent[tree * (N - 1) + v] : N;
    if (v >= L && v < N) {
      const int* kids = post_children + (tree * R + (v - L)) * 3;
      k0[v] = kids[0];
      k1[v] = kids[1];
      k2[v] = kids[2];
    } else {  // leaves and the ones slot: three zeros, from the slot
      k0[v] = N;
      k1[v] = N;
      k2[v] = N;
    }
    const double g = v < N - 1 ? double(grad[tree * grad_stride + v]) : 0.0;
    c[v] = g;
    x[v] = v < N - 1 ? __dmul_rn(g, rates[tree * (N - 1) + v]) : 0.0;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < n1; v += blockDim.x) {
    if (v < N - 1) {
      const double hp = h[p[v]];
      c[v] = __dmul_rn(c[v], __dsub_rn(hp, h[v]));
      // Masked at the leaves: a leaf at its parent's height would give inf.
      y[v] = v >= L ? __ddiv_rn(1.0, __dsub_rn(hp, b[v])) : 0.0;
    } else {
      c[v] = 0.0;
      y[v] = 0.0;
    }
  }
  __syncthreads();
  // g_h = (sum over children of g_bl - g_bl) + sum over children of the
  // Jacobian's terms; it starts the adjoint sweeps w and their sum W.
  for (int v = threadIdx.x; v < n1; v += blockDim.x) {
    const double sx = __dadd_rn(__dadd_rn(x[k0[v]], x[k1[v]]), x[k2[v]]);
    const double sy = __dadd_rn(__dadd_rn(y[k0[v]], y[k1[v]]), y[k2[v]]);
    const double g = __dadd_rn(__dsub_rn(sx, x[v]), sy);
    w0[v] = g;
    W[v] = g;
  }
  __syncthreads();
  // w <- sum over children of r w; the root (r = 1, its own parent) keeps
  // its own w besides, as its third child.
  double* src = w0;
  double* dst = w1;
  for (int it = 0; it < n_iters; ++it) {
    for (int v = threadIdx.x; v < n1; v += blockDim.x) {
      const int a = k0[v];
      const int e = k1[v];
      const int f = v == N - 1 ? N - 1 : k2[v];
      const double wv = __dadd_rn(__dadd_rn(__dmul_rn(r[a], src[a]), __dmul_rn(r[e], src[e])),
                                  __dmul_rn(r[f], src[f]));
      dst[v] = wv;
      W[v] = __dadd_rn(W[v], wv);
    }
    __syncthreads();
    double* t = src;
    src = dst;
    dst = t;
  }
  // d sweep / d r_v = h[p_v] - b_v at internal non-root v; the root height
  // is the root slot's initial condition, its gradient the last w.
  for (int j = threadIdx.x; j < R; j += blockDim.x) {
    const int v = L + j;
    const double d = j < R - 1 ? __dmul_rn(W[v], __dsub_rn(h[p[v]], b[v])) : src[N - 1];
    dratios[tree * R + j] = T(d);
  }
  if (!strict) {
    for (int v = threadIdx.x; v < N - 1; v += blockDim.x) {
      clock[tree * (N - 1) + v] = T(c[v]);
    }
  } else if (threadIdx.x < 32) {
    double s = 0.0;
    for (int v = threadIdx.x; v < N - 1; v += 32) s = __dadd_rn(s, c[v]);
    for (int off = 16; off > 0; off >>= 1) {
      s = __dadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    }
    if (threadIdx.x == 0) clock[tree] = T(s);
  }
}

// The shared route's launch setting: a block above 48 KB must opt in.
template <typename Kern>
cudaError_t prepare(Kern kernel, int tree_bytes) {
  if (tree_bytes > kMaxShared) return cudaErrorInvalidValue;
  if (tree_bytes > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                tree_bytes);
  }
  return cudaSuccess;
}

template <typename T>
int forward_entry(const void* ratios, const void* bounds, const void* rates, const void* parent,
                  void* heights, void* operand, void* slab, int tree_bytes, int B, int L, int N,
                  int n_iters, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* rt = static_cast<const double*>(ratios);
  const auto* bd = static_cast<const double*>(bounds);
  const auto* ra = static_cast<const double*>(rates);
  const auto* pa = static_cast<const int*>(parent);
  auto* h = static_cast<double*>(heights);
  auto* op = static_cast<T*>(operand);
  auto* sl = static_cast<unsigned char*>(slab);
  if (sl != nullptr) {
    heights_forward_kernel<T, true><<<B, kThreads, 0, s>>>(rt, bd, ra, pa, h, op, sl, tree_bytes,
                                                           L, N, n_iters);
  } else {
    cudaError_t err = prepare(heights_forward_kernel<T, false>, tree_bytes);
    if (err != cudaSuccess) return int(err);
    heights_forward_kernel<T, false><<<B, kThreads, tree_bytes, s>>>(
        rt, bd, ra, pa, h, op, nullptr, tree_bytes, L, N, n_iters);
  }
  return int(cudaGetLastError());
}

template <typename T>
int adjoint_entry(const void* grad, const void* heights, const void* bounds, const void* ratios,
                  const void* rates, const void* pc, const void* parent, void* dratios,
                  void* clock, void* slab, int tree_bytes, int grad_stride, int B, int L, int N,
                  int n_iters, int strict, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const T*>(grad);
  const auto* h = static_cast<const double*>(heights);
  const auto* bd = static_cast<const double*>(bounds);
  const auto* rt = static_cast<const double*>(ratios);
  const auto* ra = static_cast<const double*>(rates);
  const auto* ch = static_cast<const int*>(pc);
  const auto* pa = static_cast<const int*>(parent);
  auto* dr = static_cast<T*>(dratios);
  auto* ck = static_cast<T*>(clock);
  auto* sl = static_cast<unsigned char*>(slab);
  if (sl != nullptr) {
    heights_adjoint_kernel<T, true><<<B, kThreads, 0, s>>>(
        g, h, bd, rt, ra, ch, pa, dr, ck, sl, tree_bytes, grad_stride, L, N, n_iters, strict);
  } else {
    cudaError_t err = prepare(heights_adjoint_kernel<T, false>, tree_bytes);
    if (err != cudaSuccess) return int(err);
    heights_adjoint_kernel<T, false><<<B, kThreads, tree_bytes, s>>>(
        g, h, bd, rt, ra, ch, pa, dr, ck, nullptr, tree_bytes, grad_stride, L, N, n_iters, strict);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* lsbn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int lsbn_heights_forward_f32(const void* ratios, const void* bounds, const void* rates,
                             const void* parent, void* heights, void* operand, void* slab,
                             int tree_bytes, int B, int L, int N, int n_iters, void* stream) {
  return forward_entry<float>(ratios, bounds, rates, parent, heights, operand, slab, tree_bytes,
                              B, L, N, n_iters, stream);
}

int lsbn_heights_forward_f64(const void* ratios, const void* bounds, const void* rates,
                             const void* parent, void* heights, void* operand, void* slab,
                             int tree_bytes, int B, int L, int N, int n_iters, void* stream) {
  return forward_entry<double>(ratios, bounds, rates, parent, heights, operand, slab, tree_bytes,
                               B, L, N, n_iters, stream);
}

int lsbn_heights_adjoint_f32(const void* grad, const void* heights, const void* bounds,
                             const void* ratios, const void* rates, const void* pc,
                             const void* parent, void* dratios, void* clock, void* slab,
                             int tree_bytes, int grad_stride, int B, int L, int N, int n_iters,
                             int strict, void* stream) {
  return adjoint_entry<float>(grad, heights, bounds, ratios, rates, pc, parent, dratios, clock,
                              slab, tree_bytes, grad_stride, B, L, N, n_iters, strict, stream);
}

int lsbn_heights_adjoint_f64(const void* grad, const void* heights, const void* bounds,
                             const void* ratios, const void* rates, const void* pc,
                             const void* parent, void* dratios, void* clock, void* slab,
                             int tree_bytes, int grad_stride, int B, int L, int N, int n_iters,
                             int strict, void* stream) {
  return adjoint_entry<double>(grad, heights, bounds, ratios, rates, pc, parent, dratios, clock,
                               slab, tree_bytes, grad_stride, B, L, N, n_iters, strict, stream);
}

}  // extern "C"
