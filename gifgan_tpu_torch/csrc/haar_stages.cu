// K3: the first stages of a Haar cascade for every valid window of a packed
// pyramid canvas, for Hopper (sm_90a).
//
// Replaces the Pallas kernel gifgan_tpu/track/haar_device.py
// DeviceHaarDetector._build_stage_kernel (:426, pallas_call at :573). For
// every frame t and valid window origin (gy, gx) of the stride-`stride` grid
// over the canvas, with y = gy * stride, x = gx * stride and
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
//     alive[t][gy][gx] = 1 if every stage passed; other entries are left as
//     they are (the caller zero-fills the mask)
//
// ii, ii2 (T, canvas_h, canvas_w); cells (n_cells, 2) int32, the valid
// (gy, gx) in tile order (kernels/haar_stages.py window_grid; a cell
// outside the (ny, nx) grid is skipped, so no list can make the kernel read
// or write out of bounds); records
// (N,) TreeRecord<T> below, packed by kernels/haar_stages.py pack_records
// from the same values as the plain version's tables; ends (n_stages,)
// int32, the tree count of the first s + 1 stages; alive (T, ny, nx) int8.
// The type is float32 or float64 (a template parameter): above 2^24 / 255
// pixels a float32 integral image no longer holds its sums exactly, and the
// caller builds float64 canvases.
//
// Every operation is rounded on its own, in the order above: the file is
// built with -fmad=false (kernels/_build.py), because the plain PyTorch
// version runs one rounded operation per elementwise kernel and a
// comparison with a threshold flips on one ulp. sqrt is IEEE (no fast
// math).
//
// Bound: bytes. Reading the 88 MB of canvases of a 16x256x256 clip once
// takes 0.029 ms at 3.35 TB/s. With the exit a window sees 15.35 of the 253
// trees of 10 stages, and the kernel evaluates node 0's weighted rects (5
// operations each + 2) for each and node 1's only where node 0 sends the
// window there (49 % of them): 320 operations a window, 0.022 ms of float32
// rate over its 4.59 M valid windows. At the track path's float64 shape (34
// frames of 4088 x 481, 30.6 M valid windows, 14.27 trees each) 0.339 ms
// for the 1.07 GB of canvases, against 0.268 ms of operations at the 34
// TFLOP/s float64 rate. chip_smoke.py k3_cost counts both from the data.
//
// What held the first design (one thread per grid window, 32 x 8 blocks
// over the whole grid) back, at 1.6 % of its bound:
//   - half the grid is not valid (narrower levels leave their canvas rows
//     empty), and its threads were launched only to leave;
//   - a warp lived as long as its longest window: stages 1-4 reject 99 % of
//     the windows, but 10 % enter stage 5, so nearly every warp of 32
//     neighbours ran 60 trees or more with a few live lanes;
//   - a tree cost 22 dependent scalar loads of table words besides its
//     corner loads.
// What this design does about each:
//   - The plan lists the valid cells once, on the card, ordered by 32 x 32
//     tiles of the grid (kernels/haar_stages.py window_grid). A block takes
//     one run of kRun = 32 x 32 consecutive entries of one frame, so no
//     thread is spent on an invalid window, and the corners a block reads
//     stay inside (32 + 20)^2 canvas values that L1 holds. (Runs of whole
//     grid rows, 1024 windows over 2-4 rows and 20 more below, did not fit
//     L1 beside the other blocks' at float64 and measured slower there.)
//   - Survivors are compacted between stages. Pass 0 evaluates the
//     normalizer and stage 1 with one thread per window of the run; every
//     later stage walks the list of windows alive after the previous one,
//     32 to a warp, and appends its survivors (a __ballot_sync, one shared
//     atomicAdd per warp and a __popc rank) to the other of two lists in
//     shared memory. Where to cut: after every stage. Of the 4,587,072
//     valid windows of the 16x256x256 clip 3,242,266 enter stage 2,
//     1,264,342 stage 3, 441,552 stage 4 and 46,873 stage 5: each of the
//     first four stages removes 29-89 % of what enters it, and past stage
//     4 a run keeps a few windows, whose compaction costs one barrier.
//     Evaluating stages 1-2 (or 1-3) in pass 0 before the first compaction,
//     which keeps a warp's lanes on neighbouring windows longer, measured
//     slower at every shape. Two windows a thread (both windows' loads in
//     flight, the rects decoded once) measured slower at float32 and a few
//     percent faster at float64, the instance the track path launches. It
//     is not kept: it needs a second stage loop beside this one for a gain
//     of a few percent of a kernel that is about 1 % of a track run's wall
//     time (ROADMAP.md queue 2 holds it as the next float64 step).
//     A dead window stays dead, so the mask is the one the no-exit form
//     gives.
//     One launch per call; the block-local lists need no second launch or
//     global queue. The normalizer is computed once per window and carried
//     in the list beside the window's index.
//   - Each tree's geometry, weights, thresholds, leaves, flags and stage
//     threshold are one 16-byte-aligned record (96 bytes in float32, 144 in
//     float64), read with loads whose address is the same for the whole
//     warp: one L1 wavefront each, and the records of the early stages stay
//     in L1 for every block of the SM. Staging them in shared memory (with a
//     persistent grid to pay the fill once per block) measured slower at
//     every shape: the shared memory it took per block came out of the L1
//     that serves the corner loads. Decoding a rect's five-bit fields and
//     building its four 64-bit addresses takes about 30 integer
//     instructions, four times its loads; records that held each rect as
//     its corners' offsets in the plan's canvas (one int4 load, no decode)
//     measured slower all the same (float64 spilled, and the records grew
//     by 80 bytes), so the kernel waits on its loads, not on issue.
// Node 1 is evaluated only by the threads whose node 0 sends them there;
// the third rect only where its weight is not 0 (evaluating it always, to
// keep the loads unconditional, measured slower). The tree count, the
// window, the stride and all shapes are run-time arguments; the canvas
// needs no alignment padding.
//
// ptxas (sm_90a, -O3, -fmad=false; CUDA 12.8): 40 registers, no spills,
// 16,392 bytes of shared memory (float32) and 24,584 (float64): the two
// lists of kRun entries. chip_smoke.py's build phase prints it.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// list entries a block takes: one TILE x TILE tile of kernels/haar_stages.py,
// which passes TILE * TILE as `run`; the launch refuses any other value
constexpr int kRun = 32 * 32;
constexpr int kPerThread = kRun / kThreads;
constexpr int kLeftLeaf = 1, kRightLeaf = 2;   // flags; 4 = ends a stage

// One tree. geo[3 n + r] is node n's rect r packed as x0 | y0 << 5 |
// rw << 10 | rh << 15; absent rects and nodes have zero weights.
template <typename T>
struct alignas(16) TreeRecord {
  int geo[6];
  int flags;
  int pad;
  T wts[6];
  T thr[2];
  T leaf[4];
  T sthr;
};
// the layout kernels/haar_stages.py record_dtype describes
static_assert(sizeof(TreeRecord<float>) == 96, "float32 record size");
static_assert(sizeof(TreeRecord<double>) == 144, "float64 record size");
static_assert(offsetof(TreeRecord<float>, wts) == 32 &&
                  offsetof(TreeRecord<float>, thr) == 56 &&
                  offsetof(TreeRecord<float>, leaf) == 64 &&
                  offsetof(TreeRecord<float>, sthr) == 80,
              "float32 record layout");
static_assert(offsetof(TreeRecord<double>, wts) == 32 &&
                  offsetof(TreeRecord<double>, thr) == 80 &&
                  offsetof(TreeRecord<double>, leaf) == 96 &&
                  offsetof(TreeRecord<double>, sthr) == 128,
              "float64 record layout");

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
                                     const int* geo, const T* wts,
                                     T inv_area) {
  T acc = rect_sum(p, cw, geo[0]) * wts[0];
  acc = acc + rect_sum(p, cw, geo[1]) * wts[1];
  const T w2 = wts[2];
  if (w2 != T(0)) acc = acc + rect_sum(p, cw, geo[2]) * w2;
  return acc * inv_area;
}

// Trees [begin, end) of one stage for the window at p; true if it passes.
// The record loads are uniform across the warp (one L1 wavefront each).
template <typename T>
__device__ __forceinline__ bool stage_passes(
    const T* __restrict__ p, int cw, const TreeRecord<T>* __restrict__ recs,
    int begin, int end, T inv_area, T nf) {
  T total = T(0);
  for (int tr = begin; tr < end; ++tr) {
    const TreeRecord<T>* r = recs + tr;
    const T f0 = feature(p, cw, r->geo, r->wts, inv_area);
    const int side = f0 < r->thr[0] * nf ? 0 : 1;
    T value;
    if (r->flags & (side ? kRightLeaf : kLeftLeaf)) {
      value = r->leaf[side];
    } else {
      const T f1 = feature(p, cw, r->geo + 3, r->wts + 3, inv_area);
      value = f1 < r->thr[1] * nf ? r->leaf[2] : r->leaf[3];
    }
    total = total + value;
  }
  return total >= recs[end - 1].sthr;
}

// Appends (j, nf) to a shared list for every lane where `live`; all 32
// lanes of the warp must call it together.
template <typename T>
__device__ __forceinline__ void append(bool live, int j, T nf, int* count,
                                       int* list_j, T* list_nf, int lane) {
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (ballot == 0u) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (live) {
    const int at = base + __popc(ballot & ((1u << lane) - 1u));
    list_j[at] = j;
    list_nf[at] = nf;
  }
}

// One block per run: kRun consecutive entries of the list (one TILE x TILE
// tile of the grid where the tile is whole) of one frame.
template <typename T>
__global__ void __launch_bounds__(kThreads)
haar_stages_kernel(const T* __restrict__ ii, const T* __restrict__ ii2,
                   const int2* __restrict__ cells, int n_cells,
                   const TreeRecord<T>* __restrict__ records,
                   const int* __restrict__ ends, int8_t* __restrict__ alive,
                   int canvas_h, int canvas_w, int ny, int nx, int stride,
                   int n_stages, int ww, int wh, T inv_area,
                   int runs_per_frame) {
  __shared__ T lists_nf[2][kRun];
  __shared__ int lists_j[2][kRun];
  __shared__ int count[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int fr = blockIdx.x / runs_per_frame;
  const int first = (blockIdx.x - fr * runs_per_frame) * kRun;
  const int in_run = min(kRun, n_cells - first);
  const int2* run_cells = cells + first;
  const int64_t frame_at = static_cast<int64_t>(fr) * canvas_h * canvas_w;
  const T* fii = ii + frame_at;
  const T* fii2 = ii2 + frame_at;
  const int br = wh * canvas_w;
  if (tid < 2) count[tid] = 0;
  __syncthreads();

  // pass 0: the normalizer and stage 1 of every window of the run
  const int end0 = n_stages > 0 ? __ldg(ends) : 0;
#pragma unroll 1
  for (int k = 0; k < kPerThread; ++k) {
    const int j = k * kThreads + tid;
    bool live = j < in_run;
    T nf = T(1);
    int2 c = make_int2(0, 0);
    if (live) {
      c = __ldg(run_cells + j);                          // (gy, gx)
      live = static_cast<unsigned>(c.x) < static_cast<unsigned>(ny) &&
             static_cast<unsigned>(c.y) < static_cast<unsigned>(nx);
    }
    if (live) {
      const int at = c.x * stride * canvas_w + c.y * stride;
      const T* p = fii + at;
      const T* p2 = fii2 + at;
      const T s1 = ((__ldg(p) + __ldg(p + br + ww)) - __ldg(p + ww)) -
                   __ldg(p + br);
      const T s2 = ((__ldg(p2) + __ldg(p2 + br + ww)) - __ldg(p2 + ww)) -
                   __ldg(p2 + br);
      const T mean_c = s1 * inv_area - T(128);
      const T var = s2 * inv_area - mean_c * mean_c;
      nf = var > T(0) ? sqrt(var > T(0) ? var : T(0)) : T(1);
      if (n_stages > 0)
        live = stage_passes(p, canvas_w, records, 0, end0, inv_area, nf);
    }
    append(live, j, nf, &count[0], lists_j[0], lists_nf[0], lane);
  }

  // stages 2.. over the compacted list, then the survivors' mask bytes
  int a = 0;
  for (int s = 1;; ++s) {
    __syncthreads();
    const int n = count[a];
    __syncthreads();
    if (tid == 0) count[a] = 0;
    if (s >= n_stages || n == 0) {
      for (int i = tid; i < n; i += kThreads) {
        const int2 c = __ldg(run_cells + lists_j[a][i]);
        alive[(static_cast<int64_t>(fr) * ny + c.x) * nx + c.y] = 1;
      }
      return;
    }
    const int begin = __ldg(ends + s - 1);
    const int end = __ldg(ends + s);
    for (int i0 = warp * 32; i0 < n; i0 += kThreads) {
      const int i = i0 + lane;
      bool live = i < n;
      int j = 0;
      T nf = T(0);
      if (live) {
        j = lists_j[a][i];
        nf = lists_nf[a][i];
        const int2 c = __ldg(run_cells + j);
        live = stage_passes(fii + (c.x * stride * canvas_w + c.y * stride),
                            canvas_w, records, begin, end, inv_area, nf);
      }
      append(live, j, nf, &count[a ^ 1], lists_j[a ^ 1], lists_nf[a ^ 1],
             lane);
    }
    a ^= 1;
  }
}

template <typename T>
int launch(const void* ii, const void* ii2, const void* cells, int n_cells,
           const void* records, const void* ends, void* alive, int n_frames,
           int canvas_h, int canvas_w, int ny, int nx, int stride,
           int n_stages, int ww, int wh, cudaStream_t stream) {
  const int runs_per_frame = (n_cells + kRun - 1) / kRun;
  const T inv_area = static_cast<T>(1.0 / (static_cast<double>(ww) * wh));
  haar_stages_kernel<T><<<runs_per_frame * n_frames, kThreads, 0, stream>>>(
      static_cast<const T*>(ii), static_cast<const T*>(ii2),
      static_cast<const int2*>(cells), n_cells,
      static_cast<const TreeRecord<T>*>(records),
      static_cast<const int*>(ends), static_cast<int8_t*>(alive), canvas_h,
      canvas_w, ny, nx, stride, n_stages, ww, wh, inv_area, runs_per_frame);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take or a `run`
// other than the compiled kRun. One kernel launch per call. `alive` must be zero-filled. `ext_y` and `ext_x` are the
// furthest corner offsets any record reaches; the grid must keep them
// inside the canvas.
extern "C" int haar_stages_launch(
    const void* ii, const void* ii2, const void* cells, int n_cells, int run,
    const void* records, const void* ends, void* alive, int n_frames,
    int canvas_h, int canvas_w, int ny, int nx, int stride, int n_stages,
    int ww, int wh, int ext_y, int ext_x, int is_double, void* stream) {
  if (n_frames <= 0 || ny <= 0 || nx <= 0 || n_cells <= 0)
    return static_cast<int>(cudaSuccess);
  if (run != kRun || n_frames > 65535 ||
      n_cells > static_cast<int64_t>(ny) * nx ||
      stride < 1 || n_stages < 0 || ww < 1 || wh < 1 || ww > 31 ||
      wh > 31 || ext_y < wh || ext_x < ww ||
      (ny - 1) * stride + ext_y > canvas_h - 1 ||
      (nx - 1) * stride + ext_x > canvas_w - 1 ||
      static_cast<int64_t>(canvas_h) * canvas_w > INT32_MAX ||
      static_cast<int64_t>((n_cells + kRun - 1) / kRun) * n_frames >
          INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? launch<double>(ii, ii2, cells, n_cells, records, ends, alive,
                              n_frames, canvas_h, canvas_w, ny, nx, stride,
                              n_stages, ww, wh, s)
             : launch<float>(ii, ii2, cells, n_cells, records, ends, alive,
                             n_frames, canvas_h, canvas_w, ny, nx, stride,
                             n_stages, ww, wh, s);
}
