#!/usr/bin/env python3
"""Drive the PyTorch port (gifgan_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, one report line each, any failed check raising:

1. card     the card's name and power limit (nvidia-smi) and torch's versions;
2. build    every CUDA kernel of gifgan_tpu_torch/csrc, one nvcc each, at once;
3. corpus   4096 synthetic 16x64x64x3 clips, resident as uint8 on the card;
4. K1       the corpus gather kernel at the training shape (64 ids with
            duplicates and out-of-range values) against its plain PyTorch
            version, and timed beside it and beside torch.index_select;
5. K2       the resize + normalize kernel at the feed's shape ((1024, 256,
            256, 3) uint8 -> 64x64, scaled) and on a float32 non-square
            case, against its plain version; timed beside it and beside
            F.interpolate;
6. K3       the cascade stage kernel with a seeded cascade of alt2's shape
            (253 trees in its first 10 stages) on the packed pyramid
            canvases of a 16x256x256 clip with planted glyphs (float32) and
            of 360x480 frames (float64), against its plain version, every
            byte of the mask; timed beside it, with all 20 stages too, and
            the mean number of trees a window sees;
7. K4       the LK refinement kernel on 8 pairs of 224x224 images with known
            shifts, 200 corners, at each of the three pyramid levels,
            against its plain version, all pairs in one launch and one pair
            alone (the stabilizer's shape, also on a 192-px crop); the
            median flow must recover the shifts; timed beside the plain
            version;
8. check    the port's model on the card against the same model on the CPU,
            float32 (TF32 off), at a small config: a sample and a train step;
9. serve    sample-wall requests of 64 videos at the flagship width
            (bench.py's _flagship config, random weights from --seed);
10. train   train_chunk_ids, K = 4 steps of B = 64 clips at the flagship
            width, frames gathered by K1 from the resident corpus;
11. prep    2 synthetic 48-frame 360x480 source GIFs with a drifting,
            growing glyph -> read_gif -> process_video with the
            TrackConfig defaults (flow_backend "auto", the device flow
            with K4 in the stabilizer) and a detector that reports the
            known box on every fifth frame -> 256x256 crop GIFs;
12. detect  DeviceHaarDetector.detect_clips (K3) on 8 clips of mixed sizes
            around 128 px and around 256 px against NativeHaarDetector on
            the same frames: primary boxes agree, planted glyphs are found,
            noise frames give nothing; ms per clip for both;
13. track   the track entry point: run_directory over 4 such source GIFs
            with the cascade file and no injected detector (backend "auto":
            the device detector, batched, workers=2 so the composed
            dispatcher runs) -> crop GIFs; no file may fail, every file
            gives a crop that follows the glyph, K3 and K4 both launch;
14. feed    clip_batches_from_files over the track phase's crop GIFs (64
            paths, 16 frames, K2 to 64x64 on the card), then one
            train_chunk of K = 2 steps at the flagship width on the batches.

The launch counts are zeroed just before each of serve, train, prep, track
and feed and read just after. Then a `kernels` JSON line, the nvidia-smi
line, and as the last line {"ok": true, "device": {...}}. Without CUDA it
exits 2 and prints no result. --profile adds a torch.profiler table of one
training step and cProfile's table of the track phase's dispatcher thread.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import math
import os
import pstats
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from gifgan_tpu_torch.core.config import (DCGANConfig, TrackConfig,
                                          TrainConfig, VidGANConfig)
from gifgan_tpu_torch.data.device import DeviceCorpus
from gifgan_tpu_torch.data.loader import clip_batches_from_files
from gifgan_tpu_torch.data.synthetic import synthetic_clips
from gifgan_tpu_torch.data.video import read_gif, write_gif
from gifgan_tpu_torch.kernels import _build
from gifgan_tpu_torch.kernels import flow as kflow
from gifgan_tpu_torch.kernels.flow_refine import (bilinear_windows, lk_refine,
                                                  lk_refine_plain)
from gifgan_tpu_torch.kernels.gather import (gather_rows_scaled,
                                             gather_rows_scaled_plain)
from gifgan_tpu_torch.kernels.haar_stages import (haar_stages,
                                                  haar_stages_plain)
from gifgan_tpu_torch.kernels.resize import (interp_taps, resize_normalize,
                                             resize_normalize_plain)
from gifgan_tpu_torch.serve.sampler import gif_wall, vid_sample_fn
from gifgan_tpu_torch.track import pipeline as tpipe
from gifgan_tpu_torch.track import synthetic_cascade
from gifgan_tpu_torch.track.boxes import Detection
from gifgan_tpu_torch.track.haar import NativeHaarDetector
from gifgan_tpu_torch.track.haar_device import (DeviceHaarDetector,
                                                letterbox_stack)
from gifgan_tpu_torch.track.pipeline import process_video
from gifgan_tpu_torch.track.stats import TrackStats
from gifgan_tpu_torch.train import vid

# H100 SXM data-sheet peaks (NVIDIA), for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# an aside for K3, not a bound of the contract: a warp's load of 32
# neighbouring words is one 128-byte L1 transaction, one a clock and SM
# (132 SMs at the 1.98 GHz boost clock)
L1_WARP_LOADS_PER_S = 132 * 1.98e9

N_CLIPS, K_STEPS, BATCH, REQUESTS, WARM_CHUNKS = 4096, 4, 64, 3, 3
# prep and track: source clips. 48 frames, not fewer: a detection on every
# fifth frame must reach TrackConfig's default min_total_detections of 10.
# The face box is the cascade's glyph with its black margin (its bright face
# is the inner 16/20), so a crop shows the whole face and its centre can be
# read off the crop.
SRC_FILES, SRC_FRAMES, SRC_H, SRC_W, BOX = 2, 48, 360, 480, 200
TRACK_FILES, CENTRE_TOL_PX = 4, 4.0
# K3: the clip, the stages on the card, and the cost model of its bound
K3_FRAMES, K3_SIZE, EARLY_STAGES = 16, 256, 10
OPS_PER_WINDOW, OPS_PER_TREE = 20, 35
# feed: the crop GIFs repeated to one flagship batch per epoch
FEED_PATHS, FEED_EPOCHS, FEED_STEPS, CLIP_LEN, CLIP_SIZE = 64, 3, 2, 16, 64
DEVICE = "cuda"
KERNELS = [{
    "name": "gather_rows_scaled",
    "route": "cuda",
    "source": "gifgan_tpu_torch/csrc/gather_rows_scaled.cu",
    "replaces": "gifgan_tpu/kernels/gather.py:84",
    "counter": gather_rows_scaled,
    "path": "train",
}, {
    "name": "resize_normalize",
    "route": "cuda",
    "source": "gifgan_tpu_torch/csrc/resize_normalize.cu",
    "replaces": "gifgan_tpu/kernels/resize.py:94",
    "counter": resize_normalize,
    "path": "feed",
}, {
    "name": "lk_refine",
    "route": "cuda",
    "source": "gifgan_tpu_torch/csrc/lk_refine.cu",
    "replaces": "gifgan_tpu/kernels/flow_pallas.py:116",
    "counter": lk_refine,
    "path": "prep",
}, {
    "name": "haar_stages",
    "route": "cuda",
    "source": "gifgan_tpu_torch/csrc/haar_stages.cu",
    "replaces": "gifgan_tpu/track/haar_device.py:573",
    "counter": haar_stages,
    "path": "track",
}]


def flagship():
    """bench.py:52-65 _flagship, bf16 with packed_c3."""
    img = DCGANConfig(output_size=64, c_dim=3, z_dim=100, gf_dim=64,
                      df_dim=64, compute_dtype="bfloat16", packed_c3=True)
    cfg = VidGANConfig(z_input_size=120, z_output_size=100, vid_length=16,
                       hidden_dim=512, d_filters=256, image_gan=img,
                       first_frame_loss_scalar=1.0, compute_dtype="bfloat16")
    return cfg, TrainConfig(batch_size=BATCH, disc_updates=1, gen_updates=2)


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def reset_counts():
    for k in KERNELS:
        k["counter"].launches = 0


def read_counts():
    return {k["name"]: k["counter"].launches for k in KERNELS}


def event_ms(fn, args_list, warmup=10, reps=200):
    """Mean ms per call by CUDA events over `reps` eager calls, cycling
    through `args_list` (distinct inputs, so the rows come from HBM, not
    L2). Short calls measure the host's launch path, not the device."""
    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, args_list, reps=5):
    """Device ms per call: one CUDA graph of len(args_list) calls (one per
    input set), replayed `reps` times between CUDA events, so the host's
    launch path is out of the measurement."""
    fn(*args_list[0])                            # build / warm outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in args_list:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(args_list))


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say("card", nvidia_smi=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda, device=repr(torch.cuda.get_device_name(0)))
    return smi


def phase_build():
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    t = time.perf_counter()
    logs = _build.build(names)
    secs = time.perf_counter() - t
    for n, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        say("build", kernel=n, ptxas=repr(" | ".join(regs)))
    say("build", kernels=len(names), built_now=len(logs),
        seconds=f"{secs:.2f}")


def phase_corpus(seed):
    t = time.perf_counter()
    clips = synthetic_clips(N_CLIPS, length=16, size=64, channels=3,
                            seed=seed)
    corpus = DeviceCorpus(clips, method="kernel", device="cuda")
    torch.cuda.synchronize()
    say("corpus", clips=N_CLIPS, bytes=corpus.data.numel(),
        seconds=f"{time.perf_counter() - t:.2f}")
    return corpus


def phase_k1(corpus, seed):
    data = corpus.data
    n, d = data.shape
    rng = np.random.default_rng(seed + 1)
    ids = rng.integers(0, n, BATCH)
    ids[1] = ids[2] = ids[0]                     # duplicates
    ids[3], ids[4] = n + 904, -7                 # out of range
    idx = torch.as_tensor(ids, device="cuda")
    got = gather_rows_scaled(data, idx)
    want = gather_rows_scaled_plain(data, idx)
    torch.cuda.synchronize()
    check(got.shape == (BATCH, d) and got.dtype == torch.float32, "K1 shape")
    # The kernel divides (IEEE); PyTorch's plain version multiplies by the
    # reciprocal. Both round x/127.5 in [0, 2] before subtracting 1, so they
    # may differ by 1 ulp of that quotient: 2^-23 for a quotient in [1, 2).
    err = float((got - want).abs().max())
    check(err <= 2.0 ** -23, f"K1 within 1 ulp of the plain version: {err}")

    # timing: distinct id sets, as each training step draws new clips
    sets = [(data, torch.as_tensor(rng.integers(0, n, BATCH),
                                   device="cuda")) for _ in range(64)]
    library = lambda a, i: torch.index_select(a, 0, i)
    # kernel, plain, library, kernel; then the eager (host-launched) times
    ms = graph_ms(gather_rows_scaled, sets)
    plain_ms = graph_ms(gather_rows_scaled_plain, sets)
    lib_ms = graph_ms(library, sets)
    ms2 = graph_ms(gather_rows_scaled, sets)
    eager = [event_ms(f, sets) for f in (gather_rows_scaled,
                                         gather_rows_scaled_plain, library)]
    unique = int(torch.unique(idx.clamp(0, n - 1)).numel())
    nbytes = unique * d + BATCH * d * 4 + BATCH * 8
    bound_ms = max(nbytes / HBM_BYTES_PER_S,
                   2 * BATCH * d / F32_FLOPS) * 1e3
    kernel_ms = min(ms, ms2)
    say("K1", max_abs_err=err, tolerance=2.0 ** -23, unique_rows=unique,
        kernel_ms=f"{ms:.5f},{ms2:.5f}", plain_ms=f"{plain_ms:.5f}",
        library_ms_index_select_u8_copy_only=f"{lib_ms:.5f}",
        bound_ms=f"{bound_ms:.5f}", bound_share=f"{bound_ms / kernel_ms:.3f}",
        eager_ms_kernel_plain_library=",".join(f"{t:.5f}" for t in eager))
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
            "library_call": "torch.index_select(data, 0, idx) of the uint8 "
                            "rows: the copy only, no widen or scale"}


def phase_k2(seed):
    """K2 at the feed's shape and on a float32 non-square case."""
    g = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    n, h, w, c, oh, ow = BATCH * CLIP_LEN, 256, 256, 3, CLIP_SIZE, CLIP_SIZE
    sets = [(torch.randint(0, 256, (n, h, w, c), device=DEVICE,
                           dtype=torch.uint8, generator=g), oh, ow)
            for _ in range(3)]           # 201 MB each: past the 50 MB L2
    x = sets[0][0]
    got = resize_normalize(x, oh, ow)
    want = resize_normalize_plain(x, oh, ow)
    torch.cuda.synchronize()
    check(got.shape == (n, oh, ow, c) and got.dtype == torch.float32,
          "K2 shape")
    # Per output value: two 2-tap row sums and one 2-tap column sum of
    # float32 products, then the scale; the kernel fuses each sum into one
    # fma and the plain version's matmuls round each product. 4 ulp of the
    # largest magnitude before the final subtraction: 2^-20 for y / 127.5 in
    # [0, 2], 2^-13 for y in [0, 255].
    tol = 2.0 ** -20
    err = float((got - want).abs().max())
    check(err <= tol, f"K2 within 4 ulp of the plain version: {err}")
    check(float(got.min()) >= -1.0 and float(got.max()) <= 1.0,
          "K2 output in [-1, 1]")

    xf = torch.rand((5, 90, 120, 3), device=DEVICE, generator=g) * 255
    got_f = resize_normalize(xf, 48, 100, normalize=False)
    want_f = resize_normalize_plain(xf, 48, 100, normalize=False)
    tol_f = 2.0 ** -13
    err_f = float((got_f - want_f).abs().max())
    check(got_f.shape == (5, 48, 100, 3) and err_f <= tol_f,
          f"K2 float32 non-square case within 4 ulp of 255: {err_f}")

    def library(frames_nchw):
        return F.interpolate(frames_nchw, size=(oh, ow), mode="bilinear",
                             align_corners=False, antialias=False)

    # the library's input: the same frames as a float32 NCHW view (its
    # memory stays channels-last); the widen is not timed
    x_nchw = x.permute(0, 3, 1, 2).to(torch.float32)
    lib = library(x_nchw).permute(0, 2, 3, 1) * (1.0 / 127.5) - 1.0
    lib_diff = float((lib - got).abs().max())
    check(lib_diff <= 1e-5, f"F.interpolate computes the same resize: "
                            f"{lib_diff}")
    del lib, want, want_f
    ms = graph_ms(resize_normalize, sets)
    plain_ms = graph_ms(resize_normalize_plain, sets, reps=2)
    lib_ms = graph_ms(library, [(x_nchw,)])
    ms2 = graph_ms(resize_normalize, sets)
    # The bound counts the bytes the function needs: the source values that
    # a tap with a non-zero weight reads (at 256 -> 64 rows and columns 4i+1
    # and 4i+2 only, a quarter of the input), each once, and every output
    # float once. Two asides, not the bound: whole source rows that hold a
    # needed value (what 32-byte sectors make a kernel fetch), and every
    # input byte.
    out_bytes = n * oh * ow * c * 4
    rows, cols = (int(np.unique(idx[wt != 0]).size) for idx, wt in
                  (interp_taps(h, oh), interp_taps(w, ow)))
    nbytes = n * rows * cols * c * x.element_size() + out_bytes
    row_bytes = n * rows * w * c * x.element_size() + out_bytes
    all_bytes = x.numel() * x.element_size() + out_bytes
    bound_ms = max(nbytes / HBM_BYTES_PER_S,
                   6 * n * oh * ow * c / F32_FLOPS) * 1e3
    kernel_ms = min(ms, ms2)
    say("K2", shape=f"({n},{h},{w},{c})u8->({oh},{ow})", max_abs_err=err,
        tolerance=tol, f32_case_err=err_f, f32_case_tolerance=tol_f,
        kernel_ms=f"{ms:.5f},{ms2:.5f}", plain_ms=f"{plain_ms:.5f}",
        library_ms_interpolate_f32_nchw=f"{lib_ms:.5f}",
        library_max_abs_diff=lib_diff, bound_ms=f"{bound_ms:.5f}",
        bound_bytes=nbytes, bound_share=f"{bound_ms / kernel_ms:.3f}",
        aside_whole_rows_bytes=row_bytes,
        aside_whole_rows_ms=f"{row_bytes / HBM_BYTES_PER_S * 1e3:.5f}",
        aside_all_input_bytes=all_bytes,
        aside_all_input_ms=f"{all_bytes / HBM_BYTES_PER_S * 1e3:.5f}")
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
            "library_call": "F.interpolate(bilinear, align_corners=False, "
                            "antialias=False) on the float32 NCHW view: the "
                            "resize only, no widen or scale"}


def smooth_images(n, size, seed):
    """n (size, size) float32 images in [0, 255] with texture at LK's scale:
    uniform noise under a 5x5 box blur."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.rand((n, 1, size, size), device=DEVICE, generator=g) * 255
    return F.avg_pool2d(x, 5, stride=1, padding=2)[:, 0].contiguous()


def k4_levels(img0, img1, k, win, iters, levels, tol, timed):
    """Walk the LK pyramid of the (B, H, W) pairs from the coarsest level
    down, at each level holding lk_refine against lk_refine_plain on all B
    pairs in one launch and on the first pair alone (the stabilizer's
    shape: one pair per call). Returns the corners, their validity and one
    record per level, with times where `timed`.

    Gate, in pixels of the level: the block's shuffle reduction and the
    plain version's sum add the 225 window products in another order (and
    the kernel's bilinear blend is fused), and each of the 10 steps feeds
    that difference back through the 2x2 solve. Corners whose system is
    well conditioned (det > 1, all but flat windows) must agree to `tol`;
    nearly singular ones amplify rounding without bound and are only
    required to be finite."""
    b, size = img0.shape[:2]
    pts, valid = kflow.shi_tomasi_corners_batch(img0, max_corners=k)
    check(int(valid.sum(1).min()) >= k // 2, f"K4 corners found at {size}")
    pyr0, pyr1 = [img0], [img1]
    for _ in range(kflow.pyramid_levels(size, size, win, levels) - 1):
        pyr0.append(kflow._pyr_down_b(pyr0[-1]))
        pyr1.append(kflow._pyr_down_b(pyr1[-1]))
    check(len(pyr0) == levels, f"K4 {levels} pyramid levels at {size}")
    flow = torch.zeros_like(pts)
    per_level = []
    for lvl in range(levels - 1, -1, -1):
        scale = 2.0 ** lvl
        p_lvl = (pts / scale).contiguous()
        t0 = bilinear_windows(pyr0[lvl], p_lvl, win)
        gx, gy, a11, a12, a22, det = kflow._lk_system(pyr0[lvl], p_lvl, win)
        amat = torch.stack([a11, a12, a22, det], dim=-1)
        args = (pyr1[lvl], t0, gx, gy, amat, p_lvl,
                (flow / scale).contiguous(), win, iters)
        solo = tuple(a[:1].contiguous() for a in args[:7]) + args[7:]
        good = (det > 1.0) & valid
        errs, outs = [], []
        for what, a, ok in (("all pairs", args, good),
                            ("one pair", solo, good[:1])):
            got = lk_refine(*a)
            want = lk_refine_plain(*a)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"K4 {size} px level {lvl} {what} finite")
            errs.append(float((got - want).abs().max(-1).values[ok].max()))
            outs.append(got)
            check(errs[-1] <= tol, f"K4 {size} px level {lvl} {what} within "
                                   f"{tol} px of the plain version: {errs}")
        h, w = pyr1[lvl].shape[1:]
        rec = {"level": lvl, "hw": h, "err": errs[0], "err_one_pair": errs[1]}
        if timed:
            # needed bytes: the three window stacks, the corners' tables and
            # flows, and of img1 no more than the (win + 1)^2 window a step
            # reads, nor more than the image
            img_vals = min(b * h * w, b * k * iters * (win + 1) ** 2)
            nbytes = 4 * (3 * b * k * win * win + img_vals + b * k * (4 + 6))
            flops = b * k * iters * (win * win * 14 + 30)
            one = args[:-1] + (1,)
            rec.update({
                "ms": graph_ms(lk_refine, [args] * 16),
                "plain_ms": graph_ms(lk_refine_plain, [args] * 2, reps=2),
                "ms_one_step": graph_ms(lk_refine, [one] * 16),
                "ms_one_pair": graph_ms(lk_refine, [solo] * 16),
                "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                flops / F32_FLOPS) * 1e3,
                "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                             >= flops / F32_FLOPS else "operations")})
        per_level.append(rec)
        flow = outs[0] * scale
    return pts, valid, per_level


def phase_k4(seed):
    """K4 on 8 pairs with known shifts, at the three pyramid levels, and on
    one pair of the stabilizer's 192-px crop bucket."""
    b, size, k, win, iters, levels, tol = 8, 224, 200, 15, 10, 3, 1e-2
    shifts = [(3, -2), (-1, 4), (2, 2), (-3, -1), (0, 5), (4, 0), (-2, 3),
              (1, -4)]
    img0 = smooth_images(b, size, seed + 6)
    img1 = torch.stack([torch.roll(i, (dy, dx), (0, 1))
                        for i, (dx, dy) in zip(img0, shifts)])
    pts, valid, per_level = k4_levels(img0, img1, k, win, iters, levels, tol,
                                      timed=True)
    # the stabilizer pads its crops to multiples of 32: the 192-px bucket
    _, _, bucket = k4_levels(img0[:1, :192, :192].contiguous(),
                             img1[:1, :192, :192].contiguous(), k, win, iters,
                             levels, tol, timed=False)

    # the port's own entry point, through the kernel, recovers the shifts
    reset_counts()
    new_pts, status = kflow.lk_flow_batch(img0, img1, pts, valid, win=win,
                                          levels=levels, iters=iters)
    check(lk_refine.launches == levels, "one K4 launch per level")
    moved = (new_pts - pts).cpu().numpy()
    status = status.cpu().numpy()
    worst = 0.0
    for i, shift in enumerate(shifts):
        check(status[i].sum() >= k // 4, f"K4 pair {i} tracked")
        med = np.median(moved[i][status[i]], axis=0)
        worst = max(worst, float(np.abs(med - shift).max()))
    check(worst <= 0.5, f"K4 median flow within 0.5 px of the shifts: "
                        f"{worst}")
    for r in per_level:
        say("K4", level=r["level"], image=f"{b}x{r['hw']}x{r['hw']}",
            corners=k, win=win, iters=iters, max_abs_err_px=r["err"],
            one_pair_max_abs_err_px=r["err_one_pair"], tolerance_px=tol,
            kernel_ms=f"{r['ms']:.5f}",
            kernel_ms_one_step=f"{r['ms_one_step']:.5f}",
            kernel_ms_one_pair=f"{r['ms_one_pair']:.5f}",
            plain_ms=f"{r['plain_ms']:.5f}", bound_ms=f"{r['bound_ms']:.5f}",
            bound_by=r["bound_by"])
    for r in bucket:
        say("K4", level=r["level"], image=f"1x{r['hw']}x{r['hw']}",
            one_pair_max_abs_err_px=r["err_one_pair"], tolerance_px=tol)
    say("K4", median_flow_err_px=f"{worst:.4f}")
    top = per_level[-1]                  # level 0: the full-size images
    errs = [r[key] for r in per_level + bucket
            for key in ("err", "err_one_pair")]
    return {"max_abs_err": max(errs), "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            "library_call": "none: no single PyTorch call computes the "
                            "iterated LK solve",
            "ms_by_level": {str(r["level"]): r["ms"] for r in per_level},
            "ms_one_pair": top["ms_one_pair"]}


def phase_k3(xml, seed):
    """K3 against its plain version at the stage program's real shapes."""
    rng = np.random.default_rng(seed + 20)
    det = DeviceHaarDetector(xml, min_neighbors=3, device=DEVICE)
    check(det.early_stages == EARLY_STAGES, "10 early stages")
    n_all = len(det.cas.stage_thr)

    def canvases(frames):
        plan = det._plan(*frames.shape[1:])
        ii, ii2 = det._canvases(plan, torch.from_numpy(frames).to(DEVICE))
        return plan, ii, ii2

    def compare(what, frames, dtype):
        plan, ii, ii2 = canvases(frames)
        check(ii.dtype == dtype, f"K3 {what} canvases are {dtype}")
        before = haar_stages.launches
        got = haar_stages(ii, ii2, plan.valid, plan.tables, EARLY_STAGES)
        torch.cuda.synchronize()
        check(haar_stages.launches == before + 1, "one K3 launch per call")
        want = haar_stages_plain(ii, ii2, plan.valid, plan.tables,
                                 EARLY_STAGES)
        differ = int((got != want).sum())
        check(got.dtype == torch.int8 and got.shape == (
            len(frames), plan.ny, plan.nx), f"K3 {what} mask shape")
        say("K3", case=what, canvas=f"{len(frames)}x{plan.canvas_h}x"
            f"{plan.canvas_w}", grid=f"{plan.ny}x{plan.nx}",
            trees=plan.tables.stage_end[EARLY_STAGES - 1],
            survivors=int(got.sum()), differing_windows=differ)
        check(differ == 0, f"K3 {what} mask equals the plain mask: {differ} "
                           f"windows differ")
        check(0 < int(got.sum()) < got.numel() // 20,
              f"K3 {what}: some windows survive, few")
        return plan, ii, ii2, differ

    sides = rng.integers(30, 140, K3_FRAMES)
    clip = np.stack([synthetic_cascade.planted_frame(
        rng, K3_SIZE, K3_SIZE, int(s), "noise")[0] for s in sides])
    plan, ii, ii2, differ = compare("f32 16x256x256", clip, torch.float32)
    check((len(plan.levels), plan.canvas_h, plan.canvas_w, plan.ny, plan.nx,
           plan.tables.stage_end[EARLY_STAGES - 1])
          == (27, 2662, 257, 2642, 237, 253), "K3 shapes at 16x256x256")
    # the float64 instance at the shape the track path launches it: 360x480
    # frames letterboxed as detect_clips does, one dispatch's worth of them
    wide = np.stack([synthetic_cascade.planted_frame(
        rng, SRC_H, SRC_W, int(s), "noise")[0] for s in (90, 150, 210, 280)])
    box = letterbox_stack([wide]).shape[1:]
    n_wide = det.frames_per_dispatch(det._plan(*box))
    wide = np.rint(letterbox_stack(
        [wide[np.arange(n_wide) % len(wide)]])).astype(np.uint8)
    check(wide.shape[1:] == (384, 480) and n_wide > 4,
          f"K3 track-path shape: {wide.shape}")
    differ += compare(f"f64 {n_wide}x360x480 letterboxed to 384x480", wide,
                      torch.float64)[3]

    # how far a window gets: alive counts after 0..10 stages
    n_valid = int(plan.valid.sum()) * K3_FRAMES
    entering = [n_valid] + [int(haar_stages(
        ii, ii2, plan.valid, plan.tables, n).sum())
        for n in range(1, EARLY_STAGES)]
    counts = np.diff((0,) + plan.tables.stage_end[:EARLY_STAGES])
    trees_seen = float(np.dot(entering, counts)) / n_valid
    n_trees = int(counts.sum())

    args = (ii, ii2, plan.valid, plan.tables, EARLY_STAGES)
    ms = graph_ms(haar_stages, [args] * 4)
    plain_ms = event_ms(haar_stages_plain, [args], warmup=1, reps=2)
    ms_all = graph_ms(haar_stages, [args[:4] + (n_all,)] * 4)
    ms2 = graph_ms(haar_stages, [args] * 4)
    kernel_ms = min(ms, ms2)
    # bytes: both canvases, the grid's validity and the tables read once,
    # the mask written once. Operations: the normalizer of every valid
    # window and 35 a tree, for the trees this clip's windows see (the exit
    # is part of the function's work on this data) and, as an aside, for all
    # 253 with no exit. Aside: the corner loads as L1 transactions, one per
    # warp and load, node 1 counted for every tree.
    nbytes = (ii.numel() + ii2.numel()) * ii.element_size() + (
        K3_FRAMES + 1) * plan.ny * plan.nx + sum(
        a.nbytes for a in plan.tables.host)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_valid * (OPS_PER_WINDOW + trees_seen * OPS_PER_TREE
                        ) / F32_FLOPS * 1e3
    no_exit_ms = n_valid * (OPS_PER_WINDOW + n_trees * OPS_PER_TREE
                            ) / F32_FLOPS * 1e3
    rects = float((plan.tables.host[1][:n_trees] != 0).sum()) / n_trees
    l1_ms = n_valid * (8 + trees_seen * rects * 4) / 32 / (
        L1_WARP_LOADS_PER_S) * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    say("K3", windows=n_valid, entering_stage=",".join(map(str, entering)),
        mean_trees_per_window=f"{trees_seen:.3f}", of=n_trees,
        kernel_ms=f"{ms:.5f},{ms2:.5f}", plain_ms=f"{plain_ms:.3f}",
        kernel_ms_all_20_stages=f"{ms_all:.5f}", library_ms="none",
        bound_ms=f"{bound_ms:.5f}", bound_bytes_ms=f"{bytes_ms:.5f}",
        bound_ops_ms_measured_trees=f"{ops_ms:.5f}",
        aside_ops_ms_no_exit=f"{no_exit_ms:.5f}",
        aside_l1_corner_loads_ms=f"{l1_ms:.5f}",
        bound_share=f"{bound_ms / kernel_ms:.3f}")
    return {"max_abs_err": float(differ), "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "library_call": "none: no single PyTorch call evaluates a "
                            "cascade over a window grid",
            "ms_all_20_stages": ms_all, "mean_trees_per_window": trees_seen}


def iou(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2 = min(a[0] + a[2], b[0] + b[2])
    y2 = min(a[1] + a[3], b[1] + b[3])
    inter = max(0, x2 - x1) * max(0, y2 - y1)
    return inter / (a[2] * a[3] + b[2] * b[3] - inter)


def phase_detect(xml, seed):
    """detect_clips on 8 clips of mixed sizes against the host detector."""
    rng = np.random.default_rng(seed + 30)
    dev = DeviceHaarDetector(xml, min_neighbors=3, device=DEVICE)
    host = NativeHaarDetector(xml, min_neighbors=3)
    primary = lambda r: r[np.argmax(r[:, 2] * r[:, 3])]
    for px in (128, 256):
        clips, truth = [], []
        for c in range(8):
            h, w = px - 8 * (c % 3), px - 12 * (c % 4)
            background = "noise" if c % 2 else "black"
            frames, boxes = [], []
            for _ in range(5):
                f, box = synthetic_cascade.planted_frame(
                    rng, h, w, int(rng.integers(px // 4, px // 2)),
                    background)
                frames.append(f)
                boxes.append(box)
            frames.append(rng.integers(0, 255, (h, w)).astype(np.uint8))
            boxes.append(None)               # a noise frame: no glyph
            clips.append(np.stack(frames).astype(np.float64))
            truth.append(boxes)
        dev.detect_clips(clips)                              # warm
        torch.cuda.synchronize()
        reset = haar_stages.launches
        t = time.perf_counter()
        got = dev.detect_clips(clips)
        dev_ms = (time.perf_counter() - t) * 1e3 / len(clips)
        launches = haar_stages.launches - reset
        t = time.perf_counter()
        want = [[host.detect_rects(f) for f in c] for c in clips]
        host_ms = (time.perf_counter() - t) * 1e3 / len(clips)
        glyphs = agree = found = quiet = noise = 0
        for g_clip, w_clip, boxes in zip(got, want, truth):
            for g, w, box in zip(g_clip, w_clip, boxes):
                if box is None:
                    noise += 1
                    quiet += len(g) == 0
                    continue
                glyphs += 1
                x, y, side = box
                found += len(g) > 0 and iou(primary(g), (x, y, side,
                                                         side)) > 0.6
                agree += (len(g) > 0 and len(w) > 0
                          and iou(primary(g), primary(w)) > 0.6)
        say("detect", px=px, clips=len(clips), frames_per_clip=6,
            glyph_frames=glyphs, agree_with_host=agree, planted_found=found,
            noise_frames=noise, noise_frames_quiet=quiet,
            k3_launches=launches, device_ms_per_clip=f"{dev_ms:.2f}",
            host_ms_per_clip=f"{host_ms:.2f}")
        check(agree * 6 >= glyphs * 5, f"detect {px}: primary boxes agree "
              f"with the host detector (IoU > 0.6) on {agree}/{glyphs}")
        check(found * 6 >= glyphs * 5, f"detect {px}: planted glyphs found "
              f"on {found}/{glyphs}")
        check(quiet == noise, f"detect {px}: nothing on noise frames")
        check(launches >= 1, "detect went through K3")


class Stopwatch:
    """Seconds spent inside chosen functions, summed over threads."""

    def __init__(self):
        self.seconds = {}
        self._lock = threading.Lock()
        self._undo = []

    def wrap(self, owner, name, key):
        real = getattr(owner, name)

        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                with self._lock:
                    self.seconds[key] = (self.seconds.get(key, 0.0)
                                         + time.perf_counter() - t)

        setattr(owner, name, timed)
        self._undo.append((owner, name, real))

    def restore(self):
        for owner, name, real in self._undo:
            setattr(owner, name, real)


def phase_track(xml, seed, workdir, profile=False):
    """The track entry point: source GIFs -> run_directory with the cascade
    file and no injected detector -> crop GIFs. `profile` adds cProfile's
    view of this thread, the dispatcher that owns the detector (the workers'
    threads are not in it)."""
    in_dir = os.path.join(workdir, "track_in")
    out_dir = os.path.join(workdir, "track_out")
    os.makedirs(in_dir)
    boxes = []
    for i in range(TRACK_FILES):
        frames, b = source_clip(seed + 40 + i)
        write_gif(os.path.join(in_dir, f"src{i}.gif"), frames)
        boxes.append(b)
    cfg = TrackConfig()      # detector "auto": the device detector, K3
    watch = Stopwatch()
    watch.wrap(tpipe, "_decode", "decode")
    watch.wrap(DeviceHaarDetector, "detect_clips", "detect")
    watch.wrap(DeviceHaarDetector, "_plan", "plan")   # inside detect, once
    watch.wrap(tpipe, "process_video", "track")
    watch.wrap(tpipe, "_write_crop", "write")
    profiler = cProfile.Profile() if profile else None
    reset_counts()
    t = time.perf_counter()
    try:
        run = lambda: tpipe.run_directory(in_dir, out_dir, cfg,
                                          cascade_path=xml, detector=None,
                                          workers=2)
        stats = profiler.runcall(run) if profile else run()
    finally:
        watch.restore()
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t) * 1e3
    launches = read_counts()
    if profile:
        rows = sorted(pstats.Stats(profiler).stats.items(),
                      key=lambda kv: -kv[1][2])[:12]
        for (path, line, name), (_, calls, own, _, _) in rows:
            say("track-profile", function=f"{os.path.basename(path)}:{line}:"
                f"{name}", calls=calls, own_ms=f"{own * 1e3:.1f}")
    with open(os.path.join(out_dir, "params.json")) as f:
        params = json.load(f)
    check(params["detector_backend_selected"] == "device"
          and params["detect_batch_clips_selected"] == 8,
          f"auto took the device detector, batched: {params}")
    check(stats.cnt_files_errored == 0
          and stats.cnt_files_processed == TRACK_FILES,
          f"no file failed: {stats.counters}")
    crop_paths, offsets = [], []
    for i in range(TRACK_FILES):
        path = os.path.join(out_dir, f"src{i}_crop_0.gif")
        check(os.path.exists(path), f"source {i} gave a crop: "
                                    f"{sorted(os.listdir(out_dir))}")
        clip = read_gif(path)
        check(clip.shape[0] >= cfg.min_frame_count
              and clip.shape[1:] == (cfg.target_size, cfg.target_size, 3),
              f"source {i} crop {clip.shape}")
        crop_paths.append(path)
        # the glyph is in every frame, so the track starts at frame 0 and
        # crop n shows frame n
        offsets.append(max(patch_offset_px(clip[n], boxes[i][n][2])
                           for n in range(clip.shape[0])))
    check(launches["haar_stages"] > 0 and launches["lk_refine"] > 0,
          f"track went through K3 and K4: {launches}")
    check(max(offsets) <= CENTRE_TOL_PX,
          f"crops follow the glyph within {CENTRE_TOL_PX} px: {offsets}")
    split = {k: v * 1e3 / TRACK_FILES for k, v in watch.seconds.items()}
    say("track", files=TRACK_FILES, frames=SRC_FRAMES,
        source=f"{SRC_H}x{SRC_W}", workers=2,
        detections=stats.cnt_total_detections, tracks=stats.cnt_final_tracks,
        wall_ms_per_file=f"{total_ms / TRACK_FILES:.1f}",
        ms_per_file_decode_detect_track_write=",".join(
            f"{split.get(k, 0.0):.1f}" for k in ("decode", "detect", "track",
                                                 "write")),
        detect_plan_ms_once=f"{watch.seconds.get('plan', 0.0) * 1e3:.1f}",
        centre_err_px=",".join(f"{o:.2f}" for o in offsets),
        centre_tolerance_px=CENTRE_TOL_PX, launches=launches)
    return crop_paths, launches


def phase_check(seed):
    """The port on the card against the port on the CPU, float32."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img = DCGANConfig(output_size=32, c_dim=3, z_dim=16, gf_dim=8, df_dim=8,
                      packed_c3=True)
    cfg = VidGANConfig(z_input_size=20, z_output_size=16, vid_length=4,
                       hidden_dim=32, d_filters=16, image_gan=img,
                       first_frame_loss_scalar=1.0)
    tcfg = TrainConfig(batch_size=4)
    rng = np.random.default_rng(seed + 2)
    frames = rng.uniform(-1, 1, (16, 32, 32, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, (4, 20)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        ts = vid.init_train_state(torch.Generator().manual_seed(seed), cfg,
                                  tcfg, device=dev)
        # std-0.2 weights: random init gives ~1e-5 samples
        g = torch.Generator().manual_seed(seed + 3)
        for net in ts.params.values():
            for layer in net.values():
                if "w" in layer:
                    layer["w"].copy_(0.2 * torch.randn(
                        layer["w"].shape, generator=g))
        sample = vid.sample_videos(ts, torch.from_numpy(z).to(dev), cfg)
        _, m = vid.train_step(ts, torch.from_numpy(frames).to(dev),
                              torch.from_numpy(z).to(dev), None, cfg, tcfg)
        out[dev] = (sample.cpu().numpy(),
                    {k: float(v) for k, v in m.items()})
    (s_cpu, m_cpu), (s_gpu, m_gpu) = out["cpu"], out["cuda"]
    s_err = float(np.abs(s_gpu - s_cpu).max() / np.abs(s_cpu).max())
    check(s_err < 1e-4, f"sample card vs CPU rel err {s_err}")
    m_err = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-6)
                for k in m_cpu)
    check(m_err < 1e-3, f"train-step metrics card vs CPU rel err {m_err}")
    torch.backends.cudnn.allow_tf32 = tf32[0]
    torch.backends.cuda.matmul.allow_tf32 = tf32[1]
    say("check", sample_rel_err=f"{s_err:.3g}",
        train_metrics_rel_err=f"{m_err:.3g}", d_loss=m_gpu["d_loss"])


def phase_serve(ts, cfg):
    stats = []
    base = vid_sample_fn(ts, cfg)

    def sample_fn(z):
        v = base(z)
        stats.append((bool(torch.isfinite(v).all()), float(v.abs().max()),
                      tuple(v.shape)))
        return v

    with tempfile.TemporaryDirectory() as out:
        gif_wall(sample_fn, cfg.z_input_size, out, batch_size=BATCH,
                 num_batches=1, seed=100)            # warm-up request
        reset_counts()
        times = []
        for r in range(REQUESTS):
            t = time.perf_counter()
            gif_wall(sample_fn, cfg.z_input_size, out, batch_size=BATCH,
                     num_batches=1, seed=r, start_index=BATCH * (r + 1))
            times.append((time.perf_counter() - t) * 1e3)
        launches = read_counts()
        n_gifs = len([f for f in os.listdir(out) if f.endswith(".gif")])
    s = cfg.image_gan.output_size
    check(n_gifs == BATCH * (REQUESTS + 1), f"{n_gifs} GIFs written")
    check(all(f and mx <= 1.0 and shape == (BATCH, cfg.vid_length, s, s, 3)
              for f, mx, shape in stats), f"samples finite in [-1, 1]: {stats}")
    z = torch.rand(BATCH, cfg.z_input_size, device="cuda") * 2 - 1
    sample_ms = event_ms(lambda zz: vid.sample_videos(ts, zz, cfg), [(z,)],
                         warmup=2, reps=10)
    say("serve", requests=REQUESTS, videos_per_request=BATCH,
        ms_per_request=",".join(f"{t:.1f}" for t in times),
        sample_ms_device=f"{sample_ms:.3f}", launches=launches)


def phase_train(ts, cfg, tcfg, corpus, seed, profile):
    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    ids = torch.randint(0, N_CLIPS, (K_STEPS, BATCH), device="cuda",
                        generator=g)
    z = torch.rand(K_STEPS, BATCH, cfg.z_input_size, device="cuda",
                   generator=g) * 2 - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    ts, m = vid.train_chunk_ids(ts, ids, z, g, corpus.data, cfg, tcfg,
                                corpus.fold_sample_fn)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3 / K_STEPS
    launches = read_counts()
    check(launches["gather_rows_scaled"] == K_STEPS,
          f"K1 launched once a step: {launches}")
    for k, v in m.items():
        check(v.shape == (K_STEPS,) and bool(torch.isfinite(v).all()),
              f"metric {k} finite over the chunk")
    check(int(ts.step) == K_STEPS, "step count")

    warm = []                # host clock: spread between chunks is wide
    for _ in range(WARM_CHUNKS):
        t = time.perf_counter()
        ts, _ = vid.train_chunk_ids(ts, ids, z, g, corpus.data, cfg, tcfg,
                                    corpus.fold_sample_fn)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t) * 1e3 / K_STEPS)
    peak = torch.cuda.max_memory_allocated()
    say("train", steps=K_STEPS, batch=BATCH, ms_per_step_first=f"{first_ms:.2f}",
        ms_per_step_warm_median=f"{float(np.median(warm)):.2f}",
        ms_per_step_warm_chunks=",".join(f"{w:.2f}" for w in warm),
        peak_bytes=peak,
        d_loss=",".join(f"{x:.5f}" for x in m["d_loss"].tolist()),
        g_loss=",".join(f"{x:.5f}" for x in m["g_loss"].tolist()),
        launches=launches)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            t = time.perf_counter()
            vid.train_chunk_ids(ts, ids[:1], z[:1], g, corpus.data, cfg,
                                tcfg, corpus.fold_sample_fn)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        def self_dev(e):          # named self_cuda_time_total before 2.4
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))

        # device-side rows only: an aten op's row repeats its kernels' time
        rows = [e for e in p.key_averages() if self_dev(e) > 0
                and e.device_type == torch.autograd.DeviceType.CUDA]
        dev_total = sum(self_dev(e) for e in rows) / 1e3
        say("profile", step_wall_ms=f"{wall:.2f}",
            device_busy_ms=f"{dev_total:.2f}",
            idle_share=f"{max(0.0, 1 - dev_total / wall):.3f}")
        groups = {"conv_gemm": ("xmma", "gemm", "conv", "cudnn", "wgrad",
                                "dgrad", "fprop"),
                  "gather_k1": ("gather_rows_scaled",)}
        split = {g: 0.0 for g in (*groups, "other")}
        for e in rows:
            g = next((g for g, keys in groups.items()
                      if any(k in e.key for k in keys)), "other")
            split[g] += self_dev(e) / 1e3
        say("profile", **{f"{g}_ms": f"{v:.3f}" for g, v in split.items()})
        rows.sort(key=lambda e: -self_dev(e))
        for e in rows[:15]:
            say("profile", kernel=repr(e.key[:90]), calls=e.count,
                device_ms=f"{self_dev(e) / 1e3:.3f}")
    return launches


def source_clip(seed):
    """One synthetic source clip, (SRC_FRAMES, SRC_H, SRC_W, 3) uint8: the
    cascade's glyph (a freckled face inside a black margin, about BOX px) on
    black, drifting right and down and growing 1 px every third frame.
    Returns the frames and each frame's face box (x, y, side): the glyph
    with its margin."""
    rng = np.random.default_rng(seed)
    frames = np.zeros((SRC_FRAMES, SRC_H, SRC_W, 3), np.uint8)
    x0, y0 = (int(v) for v in rng.integers(20, 60, 2))
    boxes = []
    for t in range(SRC_FRAMES):
        side = BOX + t // 3
        x, y = x0 + 2 * t, y0 + t
        glyph = np.rint(synthetic_cascade.glyph_image(side)).astype(np.uint8)
        frames[t, y:y + side, x:x + side] = glyph[:, :, None]
        boxes.append((x, y, side))
    return frames, boxes


def patch_offset_px(crop, side):
    """How far the face's centre lies from the crop's centre, in source
    pixels: the crop shows a stabilized box of about `side` source px, the
    glyph's face bright inside its black margin."""
    bright = crop.max(axis=-1) > 30
    ys, xs = np.nonzero(bright.any(axis=1))[0], np.nonzero(
        bright.any(axis=0))[0]
    size = crop.shape[0]
    cy, cx = (ys[0] + ys[-1]) / 2.0, (xs[0] + xs[-1]) / 2.0
    centre = (size - 1) / 2.0
    return max(abs(cy - centre), abs(cx - centre)) * side / size


def phase_prep(seed, workdir):
    """Source GIFs -> read_gif -> process_video -> crop GIFs."""
    cfg = TrackConfig()      # flow_backend "auto": the device flow, K4
    sources = []
    for i in range(SRC_FILES):
        frames, boxes = source_clip(seed + 10 + i)
        path = os.path.join(workdir, f"src{i}.gif")
        write_gif(path, frames)
        sources.append((path, boxes))
    torch.cuda.synchronize()

    reset_counts()
    crop_paths, times, offsets, flow_calls = [], [], [], 0
    stages = np.zeros(3)                 # ms in read_gif, track, write_gif
    for i, (path, boxes) in enumerate(sources):
        t = time.perf_counter()
        frames = read_gif(path)
        t_read = time.perf_counter()
        check(frames.shape == (SRC_FRAMES, SRC_H, SRC_W, 3),
              f"source {i} decoded: {frames.shape}")

        def detector(frame, n, boxes=boxes):
            if n % 5:
                return []
            x, y, side = boxes[n]
            return [Detection(x, y, x + side, y + side, n)]

        stats = TrackStats()
        clips = process_video(frames, detector, cfg, stats)
        t_track = time.perf_counter()
        check(len(clips) == 1, f"source {i}: one clip, got {len(clips)} "
                               f"({stats.counters})")
        clip = clips[0]
        check(clip.shape[0] >= cfg.min_frame_count
              and clip.shape[1:] == (cfg.target_size, cfg.target_size, 3)
              and clip.dtype == np.uint8, f"source {i} clip {clip.shape}")
        out = os.path.join(workdir, f"src{i}_crop_0.gif")
        write_gif(out, clip)
        t_write = time.perf_counter()
        times.append((t_write - t) * 1e3)
        stages += np.array([t_read - t, t_track - t_read,
                            t_write - t_track]) * 1e3 / SRC_FILES
        crop_paths.append(out)
        flow_calls += sum(stats.histograms["hst_num_feature_points"].values())
        # the track starts at frame 0, so crop n shows frame n
        offsets.append(max(patch_offset_px(clip[n], boxes[n][2])
                           for n in range(clip.shape[0])))
    launches = read_counts()
    # every crop is at least BOX px, padded to 224 or more: three levels
    levels = kflow.pyramid_levels(BOX, BOX, cfg.lk_window, cfg.lk_levels)
    check(flow_calls >= SRC_FILES * (cfg.min_frame_count - 1),
          f"{flow_calls} flow calls")
    check(launches["lk_refine"] == flow_calls * levels > 0,
          f"K4 launched once per flow call and level: {launches}, "
          f"{flow_calls} calls x {levels} levels")
    check(max(offsets) <= CENTRE_TOL_PX,
          f"stabilized boxes follow the patch within {CENTRE_TOL_PX} px: "
          f"{offsets}")
    say("prep", files=SRC_FILES, frames=SRC_FRAMES,
        source=f"{SRC_H}x{SRC_W}", flow_calls=flow_calls, levels=levels,
        ms_per_file=",".join(f"{t:.1f}" for t in times),
        mean_ms_read_track_write=",".join(f"{t:.1f}" for t in stages),
        centre_err_px=",".join(f"{o:.2f}" for o in offsets),
        centre_tolerance_px=CENTRE_TOL_PX, launches=launches)
    return crop_paths, launches


def phase_feed(ts, cfg, tcfg, crop_paths, seed):
    """Crop GIFs -> clip_batches_from_files (K2) -> train_chunk."""
    paths = (crop_paths * FEED_PATHS)[:FEED_PATHS]
    n = BATCH * CLIP_LEN
    reset_counts()
    batches, times = [], []
    t = time.perf_counter()
    for batch in clip_batches_from_files(paths, BATCH, CLIP_LEN, CLIP_SIZE,
                                         epochs=FEED_EPOCHS, seed=seed):
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        batches.append(batch)
        t = time.perf_counter()
    launches = read_counts()
    check(len(batches) == FEED_EPOCHS, f"{len(batches)} batches")
    for b in batches:
        check(b.shape == (n, CLIP_SIZE, CLIP_SIZE, 3) and b.is_cuda
              and b.dtype == torch.float32, f"batch {tuple(b.shape)}")
        check(float(b.min()) >= -1.0 and float(b.max()) <= 1.0
              and float(b.std()) > 0.05, "batch in [-1, 1], not blank")
    check(launches["resize_normalize"] == FEED_EPOCHS,
          f"K2 launched once per batch: {launches}")

    g = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    z = torch.rand(FEED_STEPS, BATCH, cfg.z_input_size, device=DEVICE,
                   generator=g) * 2 - 1
    t = time.perf_counter()
    ts, m = vid.train_chunk(ts, torch.stack(batches[:FEED_STEPS]), z, g, cfg,
                            tcfg)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / FEED_STEPS
    for k, v in m.items():
        check(v.shape == (FEED_STEPS,) and bool(torch.isfinite(v).all()),
              f"metric {k} finite over the fed chunk")
    say("feed", paths=len(paths), batch=BATCH, length=CLIP_LEN,
        resize="256->64", ms_per_batch=",".join(f"{t:.1f}" for t in times),
        train_ms_per_step=f"{step_ms:.2f}",
        d_loss=",".join(f"{x:.5f}" for x in m["d_loss"].tolist()),
        launches=launches)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it runs on the card",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = phase_card()
    phase_build()
    corpus = phase_corpus(args.seed)
    measured = {"gather_rows_scaled": phase_k1(corpus, args.seed),
                "resize_normalize": phase_k2(args.seed),
                "lk_refine": phase_k4(args.seed)}
    cascade_dir = tempfile.TemporaryDirectory()
    t = time.perf_counter()
    xml = synthetic_cascade.write_cascade(
        os.path.join(cascade_dir.name, "seed_cascade.xml"), seed=args.seed)
    say("cascade", stages=len(synthetic_cascade.ALT2_STAGES),
        trees=sum(synthetic_cascade.ALT2_STAGES),
        fit_seconds=f"{time.perf_counter() - t:.2f}")
    measured["haar_stages"] = phase_k3(xml, args.seed)
    phase_check(args.seed)

    cfg, tcfg = flagship()
    ts = vid.init_train_state(torch.Generator().manual_seed(args.seed), cfg,
                              tcfg, device="cuda")
    phase_serve(ts, cfg)
    launches = {"train": phase_train(ts, cfg, tcfg, corpus, args.seed,
                                     args.profile)}
    with tempfile.TemporaryDirectory() as workdir:
        _, launches["prep"] = phase_prep(args.seed, workdir)
        phase_detect(xml, args.seed)
        crop_paths, launches["track"] = phase_track(xml, args.seed, workdir,
                                                        args.profile)
        launches["feed"] = phase_feed(ts, cfg, tcfg, crop_paths, args.seed)
    cascade_dir.cleanup()

    line = []
    for k in KERNELS:
        row = {key: k[key] for key in ("name", "route", "source", "replaces",
                                       "path")}
        row["launches"] = launches[k["path"]][k["name"]]
        row.update(measured[k["name"]])
        check(row["launches"] > 0, f"{k['name']} launched on the "
                                   f"{k['path']} path")
        line.append(row)
    check(all(math.isfinite(r["ms"]) for r in line), "kernel times")
    say("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
