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
//     (here: times the reciprocal of max(det, 1e-6), within 1.5 ulp of the
//     quotient)
//     fx += du, fy += dv
//
// img1 (B, H, W) float32 with element strides (sb, sh, sw); t0, gx, gy
// (B, K, win, win); amat (B, K, 4) = [a11, a12, a22, det]; pts, flow_in,
// flow_out (B, K, 2) = [x, y]; all float32, all but img1 contiguous.
//
// Bound: bytes, nominally. Each launch reads the three window arrays and
// img1 once: at B = 8, K = 200, win = 15 on 224x224 images that is
// 4.3 MB + 1.6 MB, under 2 us at 3.35 TB/s (one pair: 0.2 us), and its ~14
// flops per window element and step are under 1 us of float32 rate. Neither
// is what the kernel waits for: each corner is a chain of `iters` steps,
// every one a window gather, a reduction and a 2x2 solve that the next
// step's addresses depend on, so the floor is the launch plus iters x (one
// L1 gather + one reduction).
//
// What held the first design back (one 256-thread block per corner per
// pair, one window element a thread): every step ended in a __syncthreads
// and a shared-memory pass over 8 warp partials; 8 blocks fit on an SM, so
// 8 pairs x 200 corners ran in two waves; one pair's 200 blocks left most
// SMs with one block.
//
// This design: one warp per corner, kCornersPerBlock corners a block. The
// window's elements are spread over the 32 lanes, kPer a lane (a template
// parameter: 8 for win <= 16, 32 for win <= 32), element e = lane + 32 q,
// each lane keeping its t0, gx, gy and in-window offsets in registers for
// all steps. A step's two sums are reduced by an xor butterfly of
// __shfl_xor_sync: at every level both partners add the same two values, so
// every lane ends with bit-identical sums and applies the same solve; the
// flow stays in registers on every lane with no barrier and no shared
// memory, and lane 0 writes it after the last step. The grid is (corners /
// kCornersPerBlock, pairs): 8 pairs x 200 corners are 800 blocks of 2 warps,
// one wave; one pair's 100 blocks sit on 100 SMs (4 corners a block measured
// a little slower at both shapes, 1 and 2 alike). Every load is
// unconditional (see below), so a step's loads are issued together: a
// first cut with each element's loads inside its own branch was slower
// than the first design at one pair, its gathers issued one after another.
// The determinant's reciprocal is taken once per corner, not divided by
// twice a step. win, iters, H, W and the strides are run-time arguments: one build
// serves every level and crop bucket.
//
// ptxas (sm_90a, -O3; CUDA 12.8): kPer = 8 80 registers, kPer = 32 255,
// no spills, no shared memory. chip_smoke.py's build phase prints it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCornersPerBlock = 2;
constexpr int kThreads = 32 * kCornersPerBlock;

template <int kPer>
__global__ void __launch_bounds__(kThreads)
lk_refine_kernel(const float* __restrict__ img1, const float* __restrict__ t0,
                 const float* __restrict__ gx, const float* __restrict__ gy,
                 const float* __restrict__ amat,
                 const float* __restrict__ pts,
                 const float* __restrict__ flow_in,
                 float* __restrict__ flow_out, int n_corners, int h, int w,
                 int64_t sb, int64_t sh, int64_t sw, int win, int iters) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kCornersPerBlock + (threadIdx.x >> 5);
  if (k >= n_corners) return;                       // the whole warp leaves
  const int b = blockIdx.y;
  const int64_t corner = static_cast<int64_t>(b) * n_corners + k;
  const int area = win * win;
  const int m = win + 1;
  const float r = static_cast<float>(win / 2);

  // Elements past the window read its last element and get zero template
  // and gradients, so they add exact zeros to the sums: every load below is
  // unconditional, and a step's kPer x 4 image loads are issued together.
  float t0_e[kPer], gx_e[kPer], gy_e[kPer];
  int off_e[kPer];                      // (i, j) offset inside the window
  const int step_i = 32 / win, step_j = 32 % win;   // e += 32
  int i = lane / win, j = lane % win;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const bool live = lane + 32 * q < area;
    const int el = live ? lane + 32 * q : area - 1;
    const int64_t at = corner * area + el;
    const float t0v = __ldg(t0 + at);
    const float gxv = __ldg(gx + at);
    const float gyv = __ldg(gy + at);
    t0_e[q] = live ? t0v : 0.0f;
    gx_e[q] = live ? gxv : 0.0f;
    gy_e[q] = live ? gyv : 0.0f;
    off_e[q] = live ? static_cast<int>(i * sh + j * sw)
                    : static_cast<int>((win - 1) * (sh + sw));
    i += step_i;
    j += step_j;
    if (j >= win) {
      j -= win;
      ++i;
    }
  }

  const float a11 = __ldg(amat + corner * 4 + 0);
  const float a12 = __ldg(amat + corner * 4 + 1);
  const float a22 = __ldg(amat + corner * 4 + 2);
  const float det = __ldg(amat + corner * 4 + 3);
  const bool ok = det > 1e-6f;
  const float inv_det = 1.0f / fmaxf(det, 1e-6f);
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
    for (int q = 0; q < kPer; ++q) {
      const float* p = base + off_e[q];
      const float t1 = w00 * __ldg(p) + w01 * __ldg(p + sw) +
                       w10 * __ldg(p + sh) + w11 * __ldg(p + sh + sw);
      const float dt = t1 - t0_e[q];
      s1 += dt * gx_e[q];
      s2 += dt * gy_e[q];
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, d);
      s2 += __shfl_xor_sync(0xffffffffu, s2, d);
    }
    const float b1 = -s1;
    const float b2 = -s2;
    const float du = ok ? (a22 * b1 - a12 * b2) * inv_det : 0.0f;
    const float dv = ok ? (a11 * b2 - a12 * b1) * inv_det : 0.0f;
    fx += du;
    fy += dv;
  }
  if (lane == 0) {
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
  const int blocks = (n_corners + kCornersPerBlock - 1) / kCornersPerBlock;
  // in-window offsets are kept as 32-bit ints
  const long long reach = static_cast<long long>(win) *
                          ((sh < 0 ? -sh : sh) + (sw < 0 ? -sw : sw));
  if (win < 1 || win > 32 || h < win + 1 || w < win + 1 ||
      n_pairs > 65535 || iters < 0 || reach > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = win * win <= 8 * 32 ? lk_refine_kernel<8>
                                    : lk_refine_kernel<32>;
  kernel<<<dim3(blocks, n_pairs), kThreads, 0, s>>>(
      static_cast<const float*>(img1), static_cast<const float*>(t0),
      static_cast<const float*>(gx), static_cast<const float*>(gy),
      static_cast<const float*>(amat), static_cast<const float*>(pts),
      static_cast<const float*>(flow_in), static_cast<float*>(flow_out),
      n_corners, h, w, sb, sh, sw, win, iters);
  return static_cast<int>(cudaGetLastError());
}
