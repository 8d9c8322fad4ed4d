// K4: Lucas-Kanade refinement of per-corner flow at one pyramid level, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel gifgan_tpu/kernels/flow_pallas.py lk_refine
// (body _lk_refine_kernel :29, pallas_call at :116), batched over image
// pairs. For every pair b and corner k, `iters` dependent steps:
//
//     m = win + 1, r = win / 2
//     x = px + fx - r                      y = py + fy - r
//     bx = clip(floor(x), 0, W - m)        by = clip(floor(y), 0, H - m)
//     ax = clip(x - bx, 0, 1)              ay = clip(y - by, 0, 1)
//     t1[i, j] = (1-ax)(1-ay) I[by+i, bx+j]   + ax(1-ay) I[by+i, bx+j+1]
//              + (1-ax) ay    I[by+i+1, bx+j] + ax ay    I[by+i+1, bx+j+1]
//     dt = t1 - t0     b1 = -sum(dt * gx)     b2 = -sum(dt * gy)
//     du = (a22 b1 - a12 b2) / max(det, 1e-6)
//     dv = (a11 b2 - a12 b1) / max(det, 1e-6)     (both 0 where det <= 1e-6)
//     fx += du, fy += dv
//
// img1 (B, H, W) float32 with element strides (sb, sh, sw); t0, gx, gy
// (B, K, win, win); amat (B, K, 4) = [a11, a12, a22, det]; pts, flow_in,
// flow_out (B, K, 2) = [x, y]; all float32, all but img1 contiguous.
//
// Bound: bytes, nominally. Each launch reads the three window arrays and
// img1 once: at B = 8, K = 200, win = 15 on 224x224 images that is
// 4.3 MB + 1.6 MB, under 2 us at 3.35 TB/s, and its ~14 flops per window
// element and step are under 1 us of float32 rate. Neither is what the
// kernel waits for: each corner is a chain of `iters` steps, every one a
// window gather, a block-wide reduction and a 2x2 solve that the next step's
// addresses depend on, so the real floor is iters x (one L2/L1 gather + one
// reduction) plus the launch.
//
// Design: the TPU kernel walked the corners one after another on one core
// and fetched each window as an 8-row-aligned slab plus two one-hot matmuls,
// because its vector unit cannot index unaligned; its 24-row minimum image
// height came from that. None of it carries over. Corners are independent,
// so the grid is (K, B): one block per corner per pair, all resident at
// once. A block has 256 threads, one per window element (225 live at
// win = 15; up to kMaxPerThread elements per thread serve win <= 32). Each
// thread keeps its t0, gx, gy elements in registers for all steps, reads its
// four img1 neighbours through the read-only path, and the block reduces the
// two sums with warp shuffles and 16 floats of shared memory (double-buffered
// by step parity, so one barrier per step). Every thread then applies the
// same solve to the same sums, so the flow lives in registers and is
// bit-identical across the block with no broadcast; thread 0 writes it after
// the last step. win, iters, H, W and the strides are run-time arguments: one
// build serves every level and crop bucket.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 4;          // win * win <= 1024, win <= 32

__global__ void __launch_bounds__(kThreads)
lk_refine_kernel(const float* __restrict__ img1, const float* __restrict__ t0,
                 const float* __restrict__ gx, const float* __restrict__ gy,
                 const float* __restrict__ amat,
                 const float* __restrict__ pts,
                 const float* __restrict__ flow_in,
                 float* __restrict__ flow_out, int n_corners, int h, int w,
                 int64_t sb, int64_t sh, int64_t sw, int win, int iters) {
  __shared__ float partial[2][kWarps][2];
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t corner = static_cast<int64_t>(b) * n_corners + k;
  const int area = win * win;
  const int m = win + 1;
  const float r = static_cast<float>(win / 2);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float t0_e[kMaxPerThread], gx_e[kMaxPerThread], gy_e[kMaxPerThread];
  int64_t off_e[kMaxPerThread];           // (i, j) offset inside the window
#pragma unroll
  for (int q = 0; q < kMaxPerThread; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const bool live = e < area;
    const int64_t at = corner * area + e;
    t0_e[q] = live ? __ldg(t0 + at) : 0.0f;
    gx_e[q] = live ? __ldg(gx + at) : 0.0f;
    gy_e[q] = live ? __ldg(gy + at) : 0.0f;
    const int i = live ? e / win : 0;
    const int j = live ? e - i * win : 0;
    off_e[q] = i * sh + j * sw;
  }

  const float a11 = __ldg(amat + corner * 4 + 0);
  const float a12 = __ldg(amat + corner * 4 + 1);
  const float a22 = __ldg(amat + corner * 4 + 2);
  const float det = __ldg(amat + corner * 4 + 3);
  const bool ok = det > 1e-6f;
  const float safe_det = fmaxf(det, 1e-6f);
  const float px = __ldg(pts + corner * 2 + 0);
  const float py = __ldg(pts + corner * 2 + 1);
  float fx = __ldg(flow_in + corner * 2 + 0);
  float fy = __ldg(flow_in + corner * 2 + 1);
  const float* img = img1 + b * sb;
  const float max_bx = static_cast<float>(w - m);
  const float max_by = static_cast<float>(h - m);

  for (int it = 0; it < iters; ++it) {
    const float x = px + fx - r;
    const float y = py + fy - r;
    const float bxf = fminf(fmaxf(floorf(x), 0.0f), max_bx);
    const float byf = fminf(fmaxf(floorf(y), 0.0f), max_by);
    const float ax = fminf(fmaxf(x - bxf, 0.0f), 1.0f);
    const float ay = fminf(fmaxf(y - byf, 0.0f), 1.0f);
    const float w00 = (1.0f - ax) * (1.0f - ay);
    const float w01 = ax * (1.0f - ay);
    const float w10 = (1.0f - ax) * ay;
    const float w11 = ax * ay;
    const float* base = img + static_cast<int64_t>(byf) * sh +
                        static_cast<int64_t>(bxf) * sw;
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxPerThread; ++q) {
      if (threadIdx.x + q * kThreads < area) {
        const float* p = base + off_e[q];
        const float t1 = w00 * __ldg(p) + w01 * __ldg(p + sw) +
                         w10 * __ldg(p + sh) + w11 * __ldg(p + sh + sw);
        const float dt = t1 - t0_e[q];
        s1 += dt * gx_e[q];
        s2 += dt * gy_e[q];
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, d);
      s2 += __shfl_xor_sync(0xffffffffu, s2, d);
    }
    float (*buf)[2] = partial[it & 1];
    if (lane == 0) {
      buf[warp][0] = s1;
      buf[warp][1] = s2;
    }
    __syncthreads();
    float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      b1 += buf[v][0];
      b2 += buf[v][1];
    }
    b1 = -b1;
    b2 = -b2;
    const float du = ok ? (a22 * b1 - a12 * b2) / safe_det : 0.0f;
    const float dv = ok ? (a11 * b2 - a12 * b1) / safe_det : 0.0f;
    fx += du;
    fy += dv;
  }
  if (threadIdx.x == 0) {
    flow_out[corner * 2 + 0] = fx;
    flow_out[corner * 2 + 1] = fy;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int lk_refine_launch(const void* img1, const void* t0,
                                const void* gx, const void* gy,
                                const void* amat, const void* pts,
                                const void* flow_in, void* flow_out,
                                int n_pairs, int n_corners, int h, int w,
                                long long sb, long long sh, long long sw,
                                int win, int iters, void* stream) {
  if (n_pairs <= 0 || n_corners <= 0) return static_cast<int>(cudaSuccess);
  if (win < 1 || win * win > kThreads * kMaxPerThread || h < win + 1 ||
      w < win + 1 || n_pairs > 65535 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(n_corners),
            static_cast<unsigned>(n_pairs));
  lk_refine_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img1), static_cast<const float*>(t0),
      static_cast<const float*>(gx), static_cast<const float*>(gy),
      static_cast<const float*>(amat), static_cast<const float*>(pts),
      static_cast<const float*>(flow_in), static_cast<float*>(flow_out),
      n_corners, h, w, sb, sh, sw, win, iters);
  return static_cast<int>(cudaGetLastError());
}
