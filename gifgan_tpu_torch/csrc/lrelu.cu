// Leaky ReLU, y = max(x, leak * x), one pass forward and one backward, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package writes lrelu as
// jnp.maximum(x, leak * x) (gifgan_tpu/ops/nn.py lrelu) and XLA fuses it
// into its neighbours. The port's plain expression, torch.maximum(x, leak *
// x), runs as two kernels forward and about twelve backward (the
// derivatives of maximum and mul through autograd, and autograd's sum of
// the two edges). These two kernels give the same numbers bit for bit.
//
// Numerics. opmath is float for float32, bfloat16 and float16, double for
// float64 (as PyTorch's kernels compute); rnd() rounds to the tensor's
// dtype, where PyTorch stores an intermediate tensor. Every product and
// sum is its own rounded operation (__fmul_rn, __fadd_rn): nvcc would
// otherwise contract a + leak * b into one FMA, which rounds once.
//
//   forward   t = rnd(leak * x);  y = x if x is NaN or x > t, else t
//             (torch.maximum: a NaN propagates);
//   backward  from the saved x, never from y (a tiny negative x rounds
//             leak * x to -0, so y no longer tells the sides apart):
//             h = rnd(g / 2)
//             a = x == t ? h : (x < t ? 0 : g)     maximum's gradient to x
//             b = x == t ? h : (x > t ? 0 : g)     its gradient to t
//             dx = rnd(a + rnd(leak * b))          mul's backward, summed
//
// so dx is g where x > t, rnd(leak * g) where x < t, rnd(h + rnd(leak * h))
// where x == t (x = 0: 0.6 g, jnp.maximum's tie rule) and rnd(g + rnd(leak
// * g)) for a NaN x. Kept as the sum, a -0 comes out as +0 exactly where
// autograd's sum with the other edge's +0 makes it so.
//
// Bound: memory. Forward reads x and writes y, backward reads x and g and
// writes dx: 2 and 3 times the tensor's bytes (at the image D tap's h0,
// 4,096 x 32 x 32 x 64 bfloat16, 1.074 GB and 1.611 GB, 0.320 ms and 0.481
// ms at 3.35 TB/s). A handful of operations an element is far below the
// card's rate.
//
// Design: the tensor runs flat over its storage (the wrapper hands a
// non-overlapping dense tensor and outputs of its strides). Each thread
// moves kUnroll 16-byte vectors (8 bfloat16 or float16, 4 float32, 2
// float64 values), consecutive threads on consecutive vectors, all loads
// issued before the first store. The vectors start at the first element
// where every pointer is 16-byte aligned; a scalar head before it and a
// scalar tail after the last whole vector take the rest. Pointers that
// are not aligned alike (an input at an odd storage offset beside a fresh
// output) leave no common vector start: the head is then the whole range,
// still coalesced one element a thread. Offsets are 64-bit. Launched on
// the caller's stream; each entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kVecBytes = 16;

// Each dtype's opmath type O, and its conversions: up() exact, down()
// rounding to nearest even.
template <typename T> struct Num;
template <> struct Num<float> {
  using O = float;
  static __device__ __forceinline__ float up(float v) { return v; }
  static __device__ __forceinline__ float down(float v) { return v; }
};
template <> struct Num<__nv_bfloat16> {
  using O = float;
  static __device__ __forceinline__ float up(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 down(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <> struct Num<__half> {
  using O = float;
  static __device__ __forceinline__ float up(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half down(float v) {
    return __float2half_rn(v);
  }
};
template <> struct Num<double> {
  using O = double;
  static __device__ __forceinline__ double up(double v) { return v; }
  static __device__ __forceinline__ double down(double v) { return v; }
};

template <typename T>
__device__ __forceinline__ typename Num<T>::O rnd(typename Num<T>::O v) {
  return Num<T>::up(Num<T>::down(v));
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T forward_one(T xv, typename Num<T>::O leak) {
  using O = typename Num<T>::O;
  const O x = Num<T>::up(xv);
  const O t = rnd<T>(mul(leak, x));
  return (x != x || x > t) ? xv : Num<T>::down(t);
}

template <typename T>
__device__ __forceinline__ T backward_one(T xv, T gv,
                                          typename Num<T>::O leak) {
  using O = typename Num<T>::O;
  const O x = Num<T>::up(xv), g = Num<T>::up(gv);
  const O t = rnd<T>(mul(leak, x));
  const O h = rnd<T>(mul(g, O(0.5)));
  const O a = x == t ? h : (x < t ? O(0) : g);
  const O b = x == t ? h : (x > t ? O(0) : g);
  return Num<T>::down(add(a, rnd<T>(mul(leak, b))));
}

template <typename T>
struct alignas(kVecBytes) Vec {
  T v[kVecBytes / sizeof(T)];
};

// The scalar elements of a launch: [0, head) and [head + nvec * V, n).
__device__ __forceinline__ int64_t scalar_index(int64_t k, int64_t head,
                                                int64_t tail0) {
  return k < head ? k : tail0 + (k - head);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrelu_elementwise_fwd(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                      int64_t head, double leak_in) {
  constexpr int V = kVecBytes / sizeof(T);
  using O = typename Num<T>::O;
  const O leak = static_cast<O>(leak_in);
  const int64_t nvec = (n - head) / V;
  const int64_t tail0 = head + nvec * V;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll +
                        threadIdx.x;
  const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x + head);
  Vec<T>* yv = reinterpret_cast<Vec<T>*>(y + head);
  Vec<T> r[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t i = first + static_cast<int64_t>(k) * kThreads;
    if (i < nvec) r[k] = xv[i];
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t i = first + static_cast<int64_t>(k) * kThreads;
    if (i < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) r[k].v[j] = forward_one(r[k].v[j], leak);
      yv[i] = r[k];
    }
  }
  const int64_t nscalar = head + (n - tail0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       k < nscalar; k += stride) {
    const int64_t e = scalar_index(k, head, tail0);
    y[e] = forward_one(x[e], leak);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrelu_elementwise_bwd(const T* __restrict__ x, const T* __restrict__ g,
                      T* __restrict__ dx, int64_t n, int64_t head,
                      double leak_in) {
  constexpr int V = kVecBytes / sizeof(T);
  using O = typename Num<T>::O;
  const O leak = static_cast<O>(leak_in);
  const int64_t nvec = (n - head) / V;
  const int64_t tail0 = head + nvec * V;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll +
                        threadIdx.x;
  const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x + head);
  const Vec<T>* gv = reinterpret_cast<const Vec<T>*>(g + head);
  Vec<T>* dv = reinterpret_cast<Vec<T>*>(dx + head);
  Vec<T> rx[kUnroll], rg[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t i = first + static_cast<int64_t>(k) * kThreads;
    if (i < nvec) {
      rx[k] = xv[i];
      rg[k] = gv[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t i = first + static_cast<int64_t>(k) * kThreads;
    if (i < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        rg[k].v[j] = backward_one(rx[k].v[j], rg[k].v[j], leak);
      dv[i] = rg[k];
    }
  }
  const int64_t nscalar = head + (n - tail0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       k < nscalar; k += stride) {
    const int64_t e = scalar_index(k, head, tail0);
    dx[e] = backward_one(x[e], g[e], leak);
  }
}

// The elements before the vectors start: up to the first 16-byte boundary
// of `ptrs[0]`, if every pointer is as far from one; else all n.
template <typename T>
int64_t head_of(const void* const* ptrs, int count, int64_t n) {
  const uintptr_t off = reinterpret_cast<uintptr_t>(ptrs[0]) % kVecBytes;
  for (int i = 1; i < count; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % kVecBytes != off) return n;
  const int64_t head = static_cast<int64_t>(
      (kVecBytes - off) % kVecBytes / sizeof(T));
  return head < n ? head : n;
}

unsigned blocks_for(int64_t n, int64_t head, int V) {
  const int64_t nvec = (n - head) / V;
  const int64_t nscalar = n - nvec * V;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kUnroll;
  const int64_t work = nvec > nscalar ? nvec : nscalar;
  const int64_t blocks = (work + per_block - 1) / per_block;
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

template <typename T>
void forward_as(const void* x, void* y, int64_t n, double leak,
                cudaStream_t s) {
  const void* ptrs[] = {x, y};
  const int64_t head = head_of<T>(ptrs, 2, n);
  lrelu_elementwise_fwd<T><<<blocks_for(n, head, kVecBytes / sizeof(T)),
                             kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, head, leak);
}

template <typename T>
void backward_as(const void* x, const void* g, void* dx, int64_t n,
                 double leak, cudaStream_t s) {
  const void* ptrs[] = {x, g, dx};
  const int64_t head = head_of<T>(ptrs, 3, n);
  lrelu_elementwise_bwd<T><<<blocks_for(n, head, kVecBytes / sizeof(T)),
                             kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
      n, head, leak);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16, 3 float64 (kernels/lrelu.py
// DTYPES). Launches on `stream`; returns cudaGetLastError() (0 = launched;
// cudaErrorInvalidValue for an unknown dtype).
extern "C" int lrelu_forward(const void* x, void* y, long long n, int dtype,
                             double leak, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: forward_as<float>(x, y, n, leak, s); break;
    case 1: forward_as<__nv_bfloat16>(x, y, n, leak, s); break;
    case 2: forward_as<__half>(x, y, n, leak, s); break;
    case 3: forward_as<double>(x, y, n, leak, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lrelu_backward(const void* x, const void* g, void* dx,
                              long long n, int dtype, double leak,
                              void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: backward_as<float>(x, g, dx, n, leak, s); break;
    case 1: backward_as<__nv_bfloat16>(x, g, dx, n, leak, s); break;
    case 2: backward_as<__half>(x, g, dx, n, leak, s); break;
    case 3: backward_as<double>(x, g, dx, n, leak, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
