// K2: fused bilinear resize + widen + [-1, 1] scale, for Hopper (sm_90a).
//
// Replaces the Pallas kernel gifgan_tpu/kernels/resize.py resize_normalize
// (body _resize_kernel :64, pallas_call at :94):
//
//     out[n, i, j, c] = sum_h sum_w A[i, h] * float(src[n, h, w, c]) * B[j, w]
//     out = out * (1 / 127.5) - 1                    (when normalize)
//
// src (N, H, W, C) uint8 or float32, out (N, oh, ow, C) float32, both NHWC and
// contiguous. A (oh, H) and B (ow, W) are interp_matrix's cv2 INTER_LINEAR
// half-pixel, edge-clamped weights: at most two non-zeros per row.
//
// Bound: bytes, counting what the function needs: the source values under a
// non-zero tap, each read once, and every output float written once. At
// (1024, 256, 256, 3) uint8 -> 64x64 the taps fall on rows and columns 4i+1
// and 4i+2 only, a quarter of the input: 50.3 MB + 50.3 MB, 30.0 us at
// 3.35 TB/s. A kernel fetches 32-byte sectors, so it cannot skip within a
// row: whole needed rows are 100.7 MB + 50.3 MB, 45.1 us. (All 201.3 MB of
// input would be 75.1 us; no kernel needs them.) The arithmetic, six
// multiply-adds per output value, is far below the card's rate.
//
// Design: the TPU kernel wrote the resize as two dense matmuls per channel
// plane to reach its matrix unit, and transposed NHWC to planes and back
// for it. Here each output value is a 4-tap gather. The two non-zero
// weights of every row of A and of B arrive as small tables (two source
// indices and two float32 weights per output row or column, built on the
// host in float64 and stored as float32 exactly as interp_matrix stores
// them, so no coordinate is recomputed in float32 here). One thread
// computes one output value; threads run along the contiguous (j, c) axis
// of an output row, so a warp's store covers 128 contiguous bytes and its
// loads walk the two source rows in order. The row taps are applied first
// and the column taps second, as A.X then .B^T; the scale is a separately
// rounded multiply and subtract, as the plain version's. Offsets are
// 64-bit: N*H*W*C passes 2^31 above ~10.9k frames of 256x256x3.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
resize_normalize_nhwc(const T* __restrict__ src, float* __restrict__ out,
                      const int* __restrict__ yidx,
                      const float* __restrict__ ywt,
                      const int* __restrict__ xidx,
                      const float* __restrict__ xwt, int64_t total, int h,
                      int w, int c, int oh, int ow, int normalize) {
  const int64_t row_len = static_cast<int64_t>(ow) * c;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += stride) {
    const int64_t row = e / row_len;             // n * oh + i
    const int jc = static_cast<int>(e - row * row_len);
    const int j = jc / c;
    const int ch = jc - j * c;
    const int i = static_cast<int>(row % oh);
    const int64_t n = row / oh;

    const int y0 = __ldg(yidx + 2 * i), y1 = __ldg(yidx + 2 * i + 1);
    const float wy0 = __ldg(ywt + 2 * i), wy1 = __ldg(ywt + 2 * i + 1);
    const int x0 = __ldg(xidx + 2 * j), x1 = __ldg(xidx + 2 * j + 1);
    const float wx0 = __ldg(xwt + 2 * j), wx1 = __ldg(xwt + 2 * j + 1);

    const T* img = src + n * h * static_cast<int64_t>(w) * c + ch;
    const T* r0 = img + static_cast<int64_t>(y0) * w * c;
    const T* r1 = img + static_cast<int64_t>(y1) * w * c;
    const int64_t o0 = static_cast<int64_t>(x0) * c;
    const int64_t o1 = static_cast<int64_t>(x1) * c;
    // rows = A . X at the two source columns, then y = rows . B^T
    const float left = fmaf(wy1, static_cast<float>(__ldg(r1 + o0)),
                            wy0 * static_cast<float>(__ldg(r0 + o0)));
    const float right = fmaf(wy1, static_cast<float>(__ldg(r1 + o1)),
                             wy0 * static_cast<float>(__ldg(r0 + o1)));
    float y = fmaf(wx1, right, wx0 * left);
    if (normalize) y = __fsub_rn(__fmul_rn(y, 1.0f / 127.5f), 1.0f);
    out[e] = y;
  }
}

}  // namespace

// src_is_u8: 1 = uint8 source, 0 = float32. yidx/xidx: (oh, 2)/(ow, 2) int32
// source rows/columns; ywt/xwt: their float32 weights. Launches on `stream`;
// returns cudaGetLastError() (0 = launched).
extern "C" int resize_normalize_launch(const void* src, int src_is_u8,
                                       void* out, const void* yidx,
                                       const void* ywt, const void* xidx,
                                       const void* xwt, long long n, int h,
                                       int w, int c, int oh, int ow,
                                       int normalize, void* stream) {
  const long long total = n * oh * static_cast<long long>(ow) * c;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const long long want = (total + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < (1LL << 30) ? want : (1LL << 30));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_is_u8) {
    resize_normalize_nhwc<uint8_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(src), static_cast<float*>(out),
        static_cast<const int*>(yidx), static_cast<const float*>(ywt),
        static_cast<const int*>(xidx), static_cast<const float*>(xwt), total,
        h, w, c, oh, ow, normalize);
  } else {
    resize_normalize_nhwc<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(src), static_cast<float*>(out),
        static_cast<const int*>(yidx), static_cast<const float*>(ywt),
        static_cast<const int*>(xidx), static_cast<const float*>(xwt), total,
        h, w, c, oh, ow, normalize);
  }
  return static_cast<int>(cudaGetLastError());
}
