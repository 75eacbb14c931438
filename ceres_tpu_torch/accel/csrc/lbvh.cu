// The LBVH build on the card, one thread a node: the hierarchy of T
// morton-sorted leaves (Karras 2012, "Maximizing parallelism in the
// construction of BVHs, octrees, and k-d trees") and its boxes bottom-up.
//
// They replace no TPU kernel. They take the place of the JAX package's
// jitted whole-array build (ceres_tpu/accel/lbvh.py build_lbvh and
// _refit_boxes), which XLA fuses into a few loops; eager PyTorch runs the
// same formulation (accel/lbvh.py, the plain version) as ~8,300 launches
// of whole-tensor gathers, wheres and shifts over the 1.27M nodes of the
// 4x bunny. Here each internal node's searches and each leaf's climb run
// in one thread, and every array equals the plain version's bit for bit.
//
// Bound: bytes. The hierarchy reads the (T,) int64 sorted keys and writes
// seven int32 arrays; a thread's ~100 key reads lie near its own node and
// are served from the 50 MB L2. The boxes read the corners and the
// topology once and write the (T, 3) and (T - 1, 3) boxes; each node is
// finished by the second of its two children to arrive.
//
// Built by ops/_build.py (nvcc for sm_90a, --fmad=false, a plain C
// interface bound with ctypes); launched on the caller's stream, with no
// allocation and no synchronisation, so a CUDA graph captures both.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// delta(i, j): the common-prefix length of the (code, index) keys of
// sorted positions i and j, -1 for j outside [0, n - 1]. Leading zeros of
// the low 32 bits of the xor, as the plain version's _clz32 counts them
// (__clz of 0 is 32).
__device__ __forceinline__ int delta(const long long* __restrict__ keys,
                                     long long n, long long i, long long ki,
                                     long long j) {
  if (j < 0 || j > n - 1) return -1;
  const long long hx = ki ^ keys[j];
  if (hx != 0) return __clz(static_cast<int>(static_cast<unsigned>(hx)));
  return 32 + __clz(static_cast<int>(static_cast<unsigned>(i ^ j)));
}

// One thread an internal node i: its direction, range, split, children
// and its children's parent entries. The loops keep the plain version's
// trips (32 doublings, 33 steps of each binary search, with its step
// rules) and leave early only once a trip changes nothing and the next
// one would read the same: every later trip then changes nothing either.
// Index products are 64-bit, as in the plain version.
__global__ void __launch_bounds__(kThreads)
    hierarchy_kernel(const long long* __restrict__ keys, long long n,
                     int* __restrict__ left, int* __restrict__ right,
                     int* __restrict__ range_lo, int* __restrict__ range_hi,
                     int* __restrict__ parent, int* __restrict__ leaf_parent) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n - 1) return;
  const long long ki = keys[i];
  // Direction: toward the longer common prefix.
  const long long d =
      delta(keys, n, i, ki, i + 1) >= delta(keys, n, i, ki, i - 1) ? 1 : -1;
  const int delta_min = delta(keys, n, i, ki, i - d);

  // Upper bound of the range length by doubling.
  long long lmax = 2;
  for (int t = 0; t < 32; ++t) {
    if (delta(keys, n, i, ki, i + lmax * d) <= delta_min) break;
    lmax *= 2;
  }
  // Binary search of the other end j = i + l * d.
  long long l = 0;
  long long step = lmax;
  for (int t = 0; t < 33; ++t) {
    step = step / 2 > 1 ? step / 2 : 1;
    if (delta(keys, n, i, ki, i + (l + step) * d) > delta_min) {
      l += step;
    } else if (step == 1) {
      break;
    }
  }
  const long long j = i + l * d;

  // Split position gamma by binary search on the node's own prefix.
  const int delta_node = delta(keys, n, i, ki, j);
  long long s = 0;
  step = l;
  for (int t = 0; t < 33; ++t) {
    step = (step + 1) / 2;
    if (delta(keys, n, i, ki, i + (s + step) * d) > delta_node &&
        s + step < l) {
      s += step;
    } else if (step <= 1) {
      break;
    }
  }
  const long long gamma = i + s * d + (d < 0 ? d : 0);

  const long long rlo = i < j ? i : j;
  const long long rhi = i < j ? j : i;
  const bool left_is_leaf = rlo == gamma;
  const bool right_is_leaf = rhi == gamma + 1;
  left[i] = static_cast<int>(left_is_leaf ? -(gamma + 1) : gamma);
  right[i] = static_cast<int>(right_is_leaf ? -(gamma + 2) : gamma + 1);
  range_lo[i] = static_cast<int>(rlo);
  range_hi[i] = static_cast<int>(rhi);
  // A node has one parent, so each entry is written once. The root (node
  // 0) is no node's child: its left child gamma = 0 is always a leaf.
  (left_is_leaf ? leaf_parent : parent)[gamma] = static_cast<int>(i);
  (right_is_leaf ? leaf_parent : parent)[gamma + 1] = static_cast<int>(i);
  if (i == 0) parent[0] = -1;
}

// utils/minmax.py's ordered keys: signed int order is XLA's float order
// (-0 below +0), so a union is an integer min/max, exact in any order.
template <typename F>
struct Key;

template <>
struct Key<float> {
  using K = int;
  static __device__ __forceinline__ K of(float x) {
    const int b = __float_as_int(x);
    return b ^ ((b >> 31) & 0x7FFFFFFF);
  }
  static __device__ __forceinline__ float to(K k) {
    return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
  }
};

template <>
struct Key<double> {
  using K = long long;
  static __device__ __forceinline__ K of(double x) {
    const long long b = __double_as_longlong(x);
    return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFFLL);
  }
  static __device__ __forceinline__ double to(K k) {
    return __longlong_as_double(k ^ ((k >> 63) & 0x7FFFFFFFFFFFFFFFLL));
  }
};

// One thread a leaf k (sorted position): its box from the corners p0[t],
// p0[t] - e1[t], p0[t] + e2[t] of triangle t = order[k] (min/max with
// XLA's signed zeros, as the plain _corner_bounds), then up the tree.
// At each internal node the first child to arrive stops; the second,
// after a fence, takes the union of both children's boxes and goes on to
// the node's parent. A thread publishes its box before its arrival
// (fence, then atomicAdd), and reads its sibling's through L2 (ld.cg),
// so the second arrival sees the first's box.
template <typename F>
__global__ void __launch_bounds__(kThreads)
    boxes_kernel(const int* __restrict__ order, const int* __restrict__ left,
                 const int* __restrict__ right, const int* __restrict__ parent,
                 const int* __restrict__ leaf_parent,
                 const F* __restrict__ p0, const F* __restrict__ e1,
                 const F* __restrict__ e2, int* __restrict__ arrivals,
                 F* leaf_lo, F* leaf_hi, F* node_lo, F* node_hi, int n) {
  using K = typename Key<F>::K;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const long long t = order[k];
  K lo[3], hi[3];
  for (int a = 0; a < 3; ++a) {
    const F q0 = p0[3 * t + a];
    const K c0 = Key<F>::of(q0);
    const K c1 = Key<F>::of(q0 - e1[3 * t + a]);
    const K c2 = Key<F>::of(q0 + e2[3 * t + a]);
    lo[a] = min(min(c0, c1), c2);
    hi[a] = max(max(c0, c1), c2);
    leaf_lo[3LL * k + a] = Key<F>::to(lo[a]);
    leaf_hi[3LL * k + a] = Key<F>::to(hi[a]);
  }
  int from = -(k + 1);
  int node = leaf_parent[k];
  while (node >= 0) {
    __threadfence();
    if (atomicAdd(&arrivals[node], 1) == 0) return;
    __threadfence();
    const int sib = left[node] == from ? right[node] : left[node];
    const long long at = 3LL * (sib < 0 ? -sib - 1 : sib);
    const F* sib_lo = (sib < 0 ? leaf_lo : node_lo) + at;
    const F* sib_hi = (sib < 0 ? leaf_hi : node_hi) + at;
    for (int a = 0; a < 3; ++a) {
      lo[a] = min(lo[a], Key<F>::of(__ldcg(sib_lo + a)));
      hi[a] = max(hi[a], Key<F>::of(__ldcg(sib_hi + a)));
      node_lo[3LL * node + a] = Key<F>::to(lo[a]);
      node_hi[3LL * node + a] = Key<F>::to(hi[a]);
    }
    from = node;
    node = parent[node];
  }
}

int blocks(long long threads) {
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// keys (n,) int64 the sorted 30-bit morton codes; left, right, range_lo,
// range_hi, parent (n - 1,) and leaf_parent (n,) int32 outputs, encoded as
// accel/lbvh.py's Lbvh. n >= 2. Returns a cudaError_t.
extern "C" int ceres_lbvh_hierarchy(const long long* keys, int* left,
                                    int* right, int* range_lo, int* range_hi,
                                    int* parent, int* leaf_parent, int n,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  hierarchy_kernel<<<blocks(n - 1), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      keys, n, left, right, range_lo, range_hi, parent, leaf_parent);
  return (int)cudaGetLastError();
}

// order (n,) int32 sorted position -> triangle; left, right, parent
// (n - 1,) and leaf_parent (n,) int32 from ceres_lbvh_hierarchy; p0, e1,
// e2 (triangles, 3) float32, or float64 with f64 != 0; arrivals (n - 1,)
// int32 zeroed; leaf_lo, leaf_hi (n, 3) and node_lo, node_hi (n - 1, 3)
// outputs of the corners' type. Returns a cudaError_t.
extern "C" int ceres_lbvh_boxes(const int* order, const int* left,
                                const int* right, const int* parent,
                                const int* leaf_parent, const void* p0,
                                const void* e1, const void* e2, int* arrivals,
                                void* leaf_lo, void* leaf_hi, void* node_lo,
                                void* node_hi, int n, int f64, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    boxes_kernel<double><<<blocks(n), kThreads, 0, s>>>(
        order, left, right, parent, leaf_parent,
        static_cast<const double*>(p0), static_cast<const double*>(e1),
        static_cast<const double*>(e2), arrivals,
        static_cast<double*>(leaf_lo), static_cast<double*>(leaf_hi),
        static_cast<double*>(node_lo), static_cast<double*>(node_hi), n);
  } else {
    boxes_kernel<float><<<blocks(n), kThreads, 0, s>>>(
        order, left, right, parent, leaf_parent,
        static_cast<const float*>(p0), static_cast<const float*>(e1),
        static_cast<const float*>(e2), arrivals,
        static_cast<float*>(leaf_lo), static_cast<float*>(leaf_hi),
        static_cast<float*>(node_lo), static_cast<float*>(node_hi), n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ceres_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
