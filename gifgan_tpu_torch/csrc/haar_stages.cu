// K3: the first stages of a Haar cascade for every window of a packed
// pyramid canvas, for Hopper (sm_90a).
//
// Replaces the Pallas kernel gifgan_tpu/track/haar_device.py
// DeviceHaarDetector._build_stage_kernel (:426, pallas_call at :573). For
// every frame t and window origin (gy, gx) of the stride-`stride` grid over
// the canvas, with y = gy * stride, x = gx * stride and
// rect(img, x0, y0, rw, rh) = (img[y+y0][x+x0] + img[y+y0+rh][x+x0+rw])
//                             - img[y+y0][x+x0+rw] - img[y+y0+rh][x+x0]:
//
//     s1 = rect(ii, 0, 0, ww, wh)        s2 = rect(ii2, 0, 0, ww, wh)
//     mean_c = s1 * inv_area - 128       (ii2 integrates (g - 128)^2)
//     var = s2 * inv_area - mean_c * mean_c
//     nf = var > 0 ? sqrt(max(var, 0)) : 1
//     per tree, in order:
//       f(n) = (sum over the node's rects r = 0, 1, 2 with a weight, in
//               order, of rect(ii, geo[n][r]) * wts[n][r]) * inv_area
//       go0 = f(0) < thr[0] * nf
//       child = go0 ? left : right; a leaf child gives its value (leaf[0] or
//       leaf[1]), else node 1: f(1) < thr[1] * nf ? leaf[2] : leaf[3]
//       total += value; at a stage's last tree: alive &= total >= sthr,
//       total = 0
//     alive[t][gy][gx] = valid[gy][gx] and every stage passed
//
// ii, ii2 (T, canvas_h, canvas_w); valid (ny, nx) int8; geo (N, 2, 3) int32,
// each rect packed as x0 | y0 << 5 | rw << 10 | rh << 15; wts (N, 2, 3),
// thr (N, 2), leaf (N, 4), flg (N, 2) (1 where node 0's left / right child
// is a leaf), is_last (N,), sthr (N,) in the canvases' type; alive
// (T, ny, nx) int8. The type is float32 or float64 (a template parameter):
// above 2^24 / 255 pixels a float32 integral image no longer holds its sums
// exactly, and the caller builds float64 canvases.
//
// Every operation is rounded on its own, in the order above: the file is
// built with -fmad=false (kernels/_build.py), because the plain PyTorch
// version runs one rounded operation per elementwise kernel and a
// comparison with a threshold flips on one ulp. sqrt is IEEE (no fast
// math).
//
// Bound: with no exit the work is 20 + 35 operations a tree and window
// (1.3 ms of float32 rate for 253 trees over the 10 M windows of a
// 16x256x256 clip) against 98 MB of canvases and mask (0.03 ms of HBM). With
// the exit a window sees a few trees on average, so the operations shrink to
// the order of the bytes, and what the kernel waits for is neither: it is
// the corner loads, up to 24 a tree and window, served by L1.
//
// Design: the TPU kernel evaluates a whole (band, nx) band per tree with
// roll shifts, because its vector unit takes no dynamic slice start, pads
// bands to 8 rows and slabs to 128 lanes, packs the tables into scalar
// memory, and cannot stop early. None of that carries over. Here one thread
// owns one window: it reads its corners at ii[y + dy][x + dx] straight
// through L1 (neighbouring threads read neighbouring addresses, and the
// rects of one tree overlap from thread to thread, so most loads hit), walks
// the trees in one rolled loop, and leaves at the first stage it fails: a
// dead window stays dead, so the mask is the one the no-exit form gives. The
// per-tree tables are read with read-only global loads at an address that is
// the same for every thread of a warp (one broadcast transaction, L1
// resident): all 1047 trees of a full cascade do not fit the 64 KB of
// constant memory in float64, and the table size is a run-time argument.
// Node 1 is evaluated only by the threads whose node 0 sends them there. The
// tree count, the window, the stride and all shapes are run-time arguments;
// the canvas needs no alignment padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <typename T>
__device__ __forceinline__ T rect_sum(const T* __restrict__ p, int cw,
                                      int packed) {
  const int x0 = packed & 31;
  const int y0 = (packed >> 5) & 31;
  const int rw = (packed >> 10) & 31;
  const int rh = (packed >> 15) & 31;
  const T* a = p + y0 * cw + x0;
  const T* b = a + rh * cw;
  return ((__ldg(a) + __ldg(b + rw)) - __ldg(a + rw)) - __ldg(b);
}

template <typename T>
__device__ __forceinline__ T feature(const T* __restrict__ p, int cw,
                                     const int* __restrict__ geo,
                                     const T* __restrict__ wts, T inv_area) {
  T acc = rect_sum(p, cw, __ldg(geo)) * __ldg(wts);
  acc = acc + rect_sum(p, cw, __ldg(geo + 1)) * __ldg(wts + 1);
  const T w2 = __ldg(wts + 2);
  if (w2 != T(0)) acc = acc + rect_sum(p, cw, __ldg(geo + 2)) * w2;
  return acc * inv_area;
}

template <typename T>
__global__ void __launch_bounds__(kBlockX* kBlockY)
haar_stages_kernel(const T* __restrict__ ii, const T* __restrict__ ii2,
                   const int8_t* __restrict__ valid,
                   const int* __restrict__ geo, const T* __restrict__ wts,
                   const T* __restrict__ thr, const T* __restrict__ leaf,
                   const T* __restrict__ flg, const T* __restrict__ is_last,
                   const T* __restrict__ sthr, int8_t* __restrict__ alive,
                   int canvas_h, int canvas_w, int ny, int nx, int stride,
                   int n_trees, int ww, int wh, T inv_area) {
  const int gx = blockIdx.x * kBlockX + threadIdx.x;
  const int gy = blockIdx.y * kBlockY + threadIdx.y;
  const int fr = blockIdx.z;
  if (gx >= nx || gy >= ny) return;
  int8_t* out = alive + (static_cast<int64_t>(fr) * ny + gy) * nx + gx;
  if (valid[static_cast<int64_t>(gy) * nx + gx] == 0) {
    *out = 0;
    return;
  }
  const int64_t at = (static_cast<int64_t>(fr) * canvas_h + gy * stride) *
                         canvas_w + gx * stride;
  const T* p = ii + at;
  const T* p2 = ii2 + at;
  const int br = wh * canvas_w;
  const T s1 = ((__ldg(p) + __ldg(p + br + ww)) - __ldg(p + ww)) -
               __ldg(p + br);
  const T s2 = ((__ldg(p2) + __ldg(p2 + br + ww)) - __ldg(p2 + ww)) -
               __ldg(p2 + br);
  const T mean_c = s1 * inv_area - T(128);
  const T var = s2 * inv_area - mean_c * mean_c;
  const T nf = var > T(0) ? sqrt(var > T(0) ? var : T(0)) : T(1);

  T total = T(0);
  for (int tr = 0; tr < n_trees; ++tr) {
    const T f0 = feature(p, canvas_w, geo + tr * 6, wts + tr * 6, inv_area);
    const bool go0 = f0 < __ldg(thr + tr * 2) * nf;
    const int side = go0 ? 0 : 1;
    T value;
    if (__ldg(flg + tr * 2 + side) != T(0)) {
      value = __ldg(leaf + tr * 4 + side);
    } else {
      const T f1 = feature(p, canvas_w, geo + tr * 6 + 3, wts + tr * 6 + 3,
                           inv_area);
      value = f1 < __ldg(thr + tr * 2 + 1) * nf ? __ldg(leaf + tr * 4 + 2)
                                                : __ldg(leaf + tr * 4 + 3);
    }
    total = total + value;
    if (__ldg(is_last + tr) != T(0)) {
      if (!(total >= __ldg(sthr + tr))) {
        *out = 0;
        return;
      }
      total = T(0);
    }
  }
  *out = 1;
}

template <typename T>
int launch(const void* ii, const void* ii2, const void* valid,
           const void* geo, const void* wts, const void* thr,
           const void* leaf, const void* flg, const void* is_last,
           const void* sthr, void* alive, int n_frames, int canvas_h,
           int canvas_w, int ny, int nx, int stride, int n_trees, int ww,
           int wh, cudaStream_t stream) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid((nx + kBlockX - 1) / kBlockX, (ny + kBlockY - 1) / kBlockY,
            n_frames);
  const T inv_area = static_cast<T>(1.0 / (static_cast<double>(ww) * wh));
  haar_stages_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(ii), static_cast<const T*>(ii2),
      static_cast<const int8_t*>(valid), static_cast<const int*>(geo),
      static_cast<const T*>(wts), static_cast<const T*>(thr),
      static_cast<const T*>(leaf), static_cast<const T*>(flg),
      static_cast<const T*>(is_last), static_cast<const T*>(sthr),
      static_cast<int8_t*>(alive), canvas_h, canvas_w, ny, nx, stride,
      n_trees, ww, wh, inv_area);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take. `ext_y` and
// `ext_x` are the furthest corner offsets any table entry reaches; the grid
// must keep them inside the canvas.
extern "C" int haar_stages_launch(
    const void* ii, const void* ii2, const void* valid, const void* geo,
    const void* wts, const void* thr, const void* leaf, const void* flg,
    const void* is_last, const void* sthr, void* alive, int n_frames,
    int canvas_h, int canvas_w, int ny, int nx, int stride, int n_trees,
    int ww, int wh, int ext_y, int ext_x, int is_double, void* stream) {
  if (n_frames <= 0 || ny <= 0 || nx <= 0) return static_cast<int>(cudaSuccess);
  if (n_frames > 65535 || (ny + kBlockY - 1) / kBlockY > 65535 ||
      stride < 1 || n_trees < 0 || ww < 1 || wh < 1 || ww > 31 || wh > 31 ||
      ext_y < wh || ext_x < ww || (ny - 1) * stride + ext_y > canvas_h - 1 ||
      (nx - 1) * stride + ext_x > canvas_w - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? launch<double>(ii, ii2, valid, geo, wts, thr, leaf, flg,
                              is_last, sthr, alive, n_frames, canvas_h,
                              canvas_w, ny, nx, stride, n_trees, ww, wh, s)
             : launch<float>(ii, ii2, valid, geo, wts, thr, leaf, flg,
                             is_last, sthr, alive, n_frames, canvas_h,
                             canvas_w, ny, nx, stride, n_trees, ww, wh, s);
}
