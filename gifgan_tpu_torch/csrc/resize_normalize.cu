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
// row: whole needed rows are 100.7 MB + 50.3 MB, 45.1 us. The arithmetic,
// six multiply-adds per output value, is far below the card's rate.
//
// Design. The TPU kernel wrote the resize as two dense matmuls per channel
// plane to reach its matrix unit; here each output value is a 4-tap gather.
// A first design ran one thread per output value and recomputed, for every
// value, its frame, row and column with 64-bit divisions and loaded its taps
// from tables: issue-bound on index arithmetic, not on memory. Now all of
// that is done once per block or once per thread:
//
// - One block computes a tile of `rows_per_tile` output rows of one frame
//   (grid x: tiles, grid y: frames, looping where N passes gridDim.y's
//   65,535). A row's two source rows and weights are uniform loads.
// - Each thread owns a fixed unit of an output row: `vec` = 4 consecutive
//   floats (one float4 store) where ow*C is a multiple of 4, else 1. It
//   turns that unit's column taps into element offsets in a source row once
//   and keeps them in registers for all the rows it computes. `groups`
//   rows of a tile run side by side when a row has fewer units than the
//   block has threads (kernels/resize.py launch_plan).
// - The taps are read from global memory through L1, at any alignment and
//   any row width. (Staging the source rows in shared memory with bulk
//   copies was no faster at the feed shape on an H100 SXM at 700 W;
//   PERF.md.)
// - uint8 widens exactly as 2^23 + v read as a float, minus 2^23: two
//   full-rate operations in place of a quarter-rate conversion.
//
// What is left is device memory: at the feed shape K2 takes about 0.056 ms
// on an H100 SXM at 700 W, moving the whole needed rows and the output at
// about 2.7 TB/s, close to a device copy of the same bytes (PERF.md).
//
// Arithmetic order, as the plain version is held to: the row taps first,
// left = fmaf(wy1, r1, wy0 * r0), then the columns, fmaf(wx1, right,
// wx0 * left), then the scale as a separately rounded multiply and subtract.
// Offsets into the source and the output are 64-bit: N*H*W*C passes 2^31
// above ~10.9k frames of 256x256x3.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFramesY = 65535;

__device__ __forceinline__ float widen(uint8_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}
__device__ __forceinline__ float widen(float v) { return v; }

template <typename T, int kVec>
__global__ void resize_rows(const T* __restrict__ src, float* __restrict__ out,
                            const int2* __restrict__ yidx,
                            const float2* __restrict__ ywt,
                            const int2* __restrict__ xidx,
                            const float2* __restrict__ xwt, long long n_frames,
                            int h, int w, int c, int oh, int ow,
                            int rows_per_tile, int groups, int normalize) {
  const int row_len = w * c;                   // source elements a row
  const int out_len = ow * c;                  // output floats a row
  const int units = out_len / kVec;
  const int u0 = threadIdx.x % units;
  const int g = threadIdx.x / units;           // row group; idle if >= groups
  if (g >= groups) return;
  const int i0 = blockIdx.x * rows_per_tile;
  const int rows = min(rows_per_tile, oh - i0);
  for (int u = u0; u < units; u += blockDim.x) {
    int o0[kVec], o1[kVec];
    float wx0[kVec], wx1[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int e = u * kVec + k;
      const int j = e / c;
      const int ch = e - j * c;
      const int2 x = __ldg(xidx + j);
      const float2 wt = __ldg(xwt + j);
      o0[k] = x.x * c + ch;
      o1[k] = x.y * c + ch;
      wx0[k] = wt.x;
      wx1[k] = wt.y;
    }
    for (long long n = blockIdx.y; n < n_frames; n += gridDim.y) {
      const T* const frame = src + n * h * static_cast<long long>(row_len);
      float* const tile_out = out + (n * oh + i0) * out_len;
      for (int r = g; r < rows; r += groups) {
        const int2 a = __ldg(yidx + i0 + r);
        const float2 wy = __ldg(ywt + i0 + r);
        const T* const r0 = frame + static_cast<long long>(a.x) * row_len;
        const T* const r1 = frame + static_cast<long long>(a.y) * row_len;
        float v[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          // rows = A . X at the two source columns, then y = rows . B^T
          const float left = fmaf(wy.y, widen(r1[o0[k]]),
                                  wy.x * widen(r0[o0[k]]));
          const float right = fmaf(wy.y, widen(r1[o1[k]]),
                                   wy.x * widen(r0[o1[k]]));
          float y = fmaf(wx1[k], right, wx0[k] * left);
          if (normalize) y = __fsub_rn(__fmul_rn(y, 1.0f / 127.5f), 1.0f);
          v[k] = y;
        }
        float* const dst = tile_out + static_cast<long long>(r) * out_len;
        if constexpr (kVec == 4) {
          reinterpret_cast<float4*>(dst)[u] = make_float4(v[0], v[1], v[2],
                                                          v[3]);
        } else {
          dst[u] = v[0];
        }
      }
    }
  }
}

template <typename T, int kVec>
void launch(dim3 grid, int threads, cudaStream_t s, const void* src, void* out,
            const void* yidx, const void* ywt, const void* xidx,
            const void* xwt, long long n, int h, int w, int c, int oh, int ow,
            int rows_per_tile, int groups, int normalize) {
  resize_rows<T, kVec><<<grid, threads, 0, s>>>(
      static_cast<const T*>(src), static_cast<float*>(out),
      static_cast<const int2*>(yidx), static_cast<const float2*>(ywt),
      static_cast<const int2*>(xidx), static_cast<const float2*>(xwt), n, h, w,
      c, oh, ow, rows_per_tile, groups, normalize);
}

}  // namespace

// src_is_u8: 1 = uint8 source, 0 = float32. yidx/ywt: (oh, 2) int32 source
// rows and float32 weights of each output row; xidx/xwt: the same for each
// output column (kernels/resize.py interp_taps). vec, threads, groups and
// rows_per_tile come from kernels/resize.py launch_plan. Launches on
// `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a plan that would leave output values unwritten.
extern "C" int resize_normalize_launch(
    const void* src, int src_is_u8, void* out, const void* yidx,
    const void* ywt, const void* xidx, const void* xwt, long long n, int h,
    int w, int c, int oh, int ow, int vec, int threads, int groups,
    int rows_per_tile, int normalize, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if ((vec != 1 && vec != 4) || (ow * c) % vec || threads < 1 ||
      groups < 1 || (groups > 1 && groups * (ow * c / vec) > threads) ||
      rows_per_tile < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((oh + rows_per_tile - 1) / rows_per_tile,
                  static_cast<unsigned>(n < kMaxFramesY ? n : kMaxFramesY));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fn = src_is_u8 ? (vec == 4 ? launch<uint8_t, 4> : launch<uint8_t, 1>)
                      : (vec == 4 ? launch<float, 4> : launch<float, 1>);
  fn(grid, threads, s, src, out, yidx, ywt, xidx, xwt, n, h, w, c, oh, ow,
     rows_per_tile, groups, normalize);
  return static_cast<int>(cudaGetLastError());
}
