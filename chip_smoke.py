#!/usr/bin/env python3
"""Drive the PyTorch port (gifgan_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, one report line each, any failed check raising:

1. card     the card's name and power limit (nvidia-smi) and torch's versions;
2. build    every CUDA kernel of gifgan_tpu_torch/csrc, one nvcc each, at once;
3. corpus   4096 synthetic 16x64x64x3 clips, resident as uint8 on the card;
4. K1       the corpus gather kernel at the training shape (64 ids with
            duplicates and out-of-range values) against its plain PyTorch
            version, and timed beside it and, as an aside (a copy only, no
            widen or scale), beside torch.index_select; then the same at
            train-dcgan's shape (case=stills: 64 rows of 64x64x3, the
            corpus's frames as stills), with the launch floor (a
            one-element add_ in a graph of as many calls) as an aside and
            the floor of K1's own chain (K1 on one 16-byte row in a graph
            of as many calls) beside its bound;
5. K2       the resize + normalize kernel at the feed's shape ((1024, 256,
            256, 3) uint8 -> 64x64, scaled), on a float32 non-square case,
            on unaligned rows (W*C = 363, and the feed's shape one byte
            into its storage), on 70,000 tiny frames (past gridDim.y), on
            11,000 frames of 256x256x3 (past 2^31 bytes) and at
            data/video.py resize_u8's shape (48, 360, 480, 3) -> 256x256,
            against its plain version, each case with its launch plan;
            timed beside the plain version and F.interpolate, with the
            one-byte offset, resize_u8's shape and a device copy of the
            bytes K2 moves as asides;
6. K3       the cascade stage kernel with a seeded cascade of alt2's shape
            (253 trees in its first 10 stages) on the packed pyramid
            canvases of a 16x256x256 clip with planted glyphs (float32, 10
            and all 20 stages) and of one track dispatch of 360x480 frames
            letterboxed to 384x480 (float64), against its plain version,
            every byte of the mask; both instances timed beside their
            bounds (float64 operations at F64_FLOPS), with the windows
            entering each stage, the mean number of trees a window sees
            and the share of those trees whose node 0 sends it to node 1
            (the bounds count node 1 only there);
7. K4       the LK refinement kernel on 8 pairs of 224x224 images with known
            shifts, 200 corners, at each of the three pyramid levels,
            against its plain version, all pairs in one launch and one pair
            alone; then one pair alone at the track path's crop bucket
            (TRACK_BUCKET), the stabilizer's shape, all levels timed with
            one step and the one-pair bound; the median flow must recover
            the shifts;
7a. lrelu   the leaky ReLU's two passes through their wrapper
            (kernels/lrelu.py lrelu) and autograd, at the image D tap's
            three shapes at 4,096 frames and at the vid-D's permuted
            layout, bfloat16, against their plain versions, every bit (the
            sign of a zero too), one launch each way; at the tap's shapes
            each pass timed beside its bound (bytes at HBM_BYTES_PER_S), the
            expression it replaces, torch.maximum(x, 0.2 * x), and the
            library's F.leaky_relu: forward in CUDA graphs, the kernel's
            backward in a graph and all three backwards through autograd
            (CUDA events); where the library's backward differs in bits;
            then the image D's forward at batch 16 under no_grad, paced by
            the host, with the kernel and with the expression (host us a
            call); the flagship train phase counts 24 + 18 launches a step;
8. check    the port's model on the card against the same model on the CPU,
            float32 (TF32 off): the video GAN at a small config (a sample
            and a train step), and one image-DCGAN train step at the
            flagship width from one converted state (losses, weights);
9. serve    sample-wall requests of 64 videos at the flagship width
            (bench.py's _flagship config, random weights from --seed);
9a. profile one warm train_chunk_ids step (B = 64 clips at the flagship
            width, K1 gathering its frames from 512 random clips) through
            core/profile.py (trace, then summarize_trace), the first
            capture of a process of its own (profile_child):
            K1's rows in the summary as many as it launched, total_us
            within 1 % of the same capture's key_averages() device total
            and under the step's wall time; the device time by category
            and the idle share. Then bench: `python -m gifgan_tpu_torch
            bench` in a process of its own (bench.py: 3 timed train_chunk
            calls of 80 flagship steps on frames made on the card): its
            last line parses, with the JAX bench's metric and unit and a
            finite value above 0, printed beside the nvidia-smi line;
9b. workflow the reference's workflow through the port's CLI, in process
            (gifgan_tpu_torch.cli.main), at the flagship width: train-dcgan
            (--device-corpus, 12 steps in chunks of 4: K1 once a step) ->
            train-vid grafting that run's image GAN (--device-corpus, 8
            steps: K1 once a step) -> sample-wall (2 requests of 64 GIFs).
            It checks the K1 launches against the step counts, finite
            losses, each run's files, the grafted image nets in train-vid's
            checkpoint bit-equal to train-dcgan's final ones, and the image
            checkpoint restoring into a fresh TrainState;
9c. serve_int8 int8 serving (ops/quant.py) at the flagship width: the
            stack's BN moments from 40 train-mode passes, quantize_sampler
            (2 mse calibration batches, bias correction) and 20 finishing
            steps; int8_matmul's padded shapes card == CPU; every int32
            accumulator of one q tree card == CPU from the same int8 input
            (4 videos and one) and the stacks within the CPU tests'
            tolerance; int8 (static and dynamic scales) against the
            float32 sampler (PSNR, mae, corr); one request's device ms for
            int8 and float, each contraction's im2col bytes and ms and
            _int_mm ms beside its bound, the peak bytes at 64 and 256
            videos; then quantize-export of the workflow's train-vid run ->
            sample-wall --quantized (2 requests of 64 GIFs, the artifact's
            bytes against the float checkpoint's) and sample-wall --int8
            --int8-calib 2 through the CLI;
9d. invert  latent inversion (gifgan_tpu_torch/invert/) on the workflow's
            train-dcgan run at the flagship width: one image problem
            (8 targets the run's generator drew, float32, TF32 off) card
            vs CPU over 20 Adam steps across a rate decay: the loss at
            each point of the CPU's run, dL/dz at its start, the card's
            Adam fed the CPU's gradients, the free runs' losses; then through the CLI
            make-paths, z-extract (8 16-frame GIF clips the generator
            drew, one batch, 50 + 16 x 10 steps, comparison GIFs),
            derive-paths, invert (64 generator PNGs,
            batch 64, 200 steps, progress sections 0,1 50,10, a make-paths,
            a derived and an extracted path: the last loss under 0.9 x the
            first) and visualize --option 4; 10 steps of the nested
            variant on the flagship VidGAN (8 videos x 16 frames); ms per
            inversion step over a 50-step chunk by CUDA events, seconds
            per z-extract clip;
9e. recurrent the other model families: the recurrent_image GAN's G, D,
            rollout and one train step for each variant (shared D convs,
            3 LSTM layers with dropout masks passed in, residual
            prediction with the pixel term and warm-up), one conditional
            DCGAN step and PredNet's loss and gradient, card vs CPU at a
            small config (float32, TF32 off); train-recurrent through the
            CLI at the JAX command's defaults (gf 64, 40 clips of 17
            64x64x3 frames, LSTM 100, float32) on 80 synthetic clips, the
            host path and --device-corpus (4 steps each, a prediction GIF
            grid, checkpoints) and a resume of the latter (2 steps), its
            checkpoint restored into a fresh RecurrentTrainState, ms/step
            by CUDA events and a 16-frame rollout; the conditional DCGAN at
            MNIST width (batch 64, 30 steps on synthetic digits), PredNet at
            its study's width (64x64x3, channels (32, 64), batch 16, T 16,
            30 Adam steps: the loss falls) and the prototypes' fit at
            tests/test_prototypes.py's sizes and thresholds;
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
            gives a crop that follows the glyph, K3 and K4 both launch, and
            K4's largest image is the TRACK_BUCKET crop;
14. feed    clip_batches_from_files over the track phase's crop GIFs (64
            paths, 16 frames, K2 to 64x64 on the card), then one
            train_chunk of K = 2 steps at the flagship width on the batches;
15. dataprep the data-collection tools: scrape --dry-run on keywords.txt and
            the Scraper over an in-process fake search API (no network);
            sample-frames over the track phase's 256x256 crop GIFs (5
            stills a clip at 64 px, K2); video_to_frames on a glyph video
            (an MJPG avi, OpenCV's own codec) with the device detector (K3);
            the mp4 probe (mp4_write, mp4_read), bulk-resize and
            video-to-gif on mp4s where cv2 has the codec, video-to-gif on
            the avi always; combine-stats over the track and prep stats;
            process_video on the prep sources with flow_backend "jax" (the
            gather flow, no K4) against "auto" (K4): boxes within
            CENTRE_TOL_PX, ms per file for both; the batched gather
            detector on the detect phase's clips against the host detector
            by the detect phase's criteria;
16. eval    the evaluation tools on the workflow's runs: eval-fad at the
            flagship width (512 synthetic stills against 512 PNGs of the
            train-dcgan run's generator, batch 256; the FAD of a set
            against itself under 1e-6; the h2 features card vs CPU, float32
            with TF32 off, within FEATURE_TOL); eval-track-rate with the
            seeded cascade over 64 of the sample-wall run's GIFs and 16
            glyph GIFs (64x64, upscaled 2x): no clip errored, the glyph
            set's rate at least 0.75, K3 and K4 launched; face-detect
            --best --biggest --query on a 360x480 glyph frame (K3, the best
            box is the glyph); survey-pairs on an export_survey_samples
            directory of the flagship sampler's videos and a stride
            control; QualityEarlyStop fed the phase's rates and FAD, its
            log replayed into an equal state;
17. serve_web the serving and checkpoint tools on the workflow's
            train-dcgan run (bf16, packed_c3): the explorer's sampler card
            vs CPU (float32, TF32 off); the explorer over HTTP with a
            bearer token (init_face, random_faces of 36, init_directions,
            add_image, get_similar, load_video_description, save; 3
            passes, the median ms of each action), the saved mp4 read
            back; the int8 explorer (--int8 --int8-calib 2) random_faces
            with PSNR and corr against the float faces (corr above 0.99);
            capture_face on a 360x480 glyph frame with the device
            detector on the seeded cascade (K3); two /animate requests
            of that face (1200 steps, batch 16, 2 make-paths paths): ms a
            request and a step, the loss falling under 0.9 x its first,
            every artifact read back; an unauthorized request (401) and an
            oversized declared body (413); export-web through the CLI
            (generator_forward_reference within 1 u8 of golden.json and of
            the card's float32 generator); survey-serve on the eval
            phase's export (8 ratings, /results); ckpt-inspect of the run
            and of the committed TF bundle, ckpt-downgrade of that bundle
            read back bit-equal to its expected.npz.
18. mesh    the data axis of the mesh (core/mesh.py, parallel/): (a) one
            NCCL rank drives train_vid_dcgan(mesh=) at the flagship widths
            in float32 with TF32 off, DP and FSDP (MESH_STEPS steps in
            chunks of 2), against the no-mesh run of the same seed: the
            losses and parameters at the step-2 checkpoint within
            MESH_PARITY_TOL, the step-4 ones printed, K1 once a step; then
            train_chunk_ids in bf16 on each path, ms/step and peak bytes,
            and the bytes a flagship step moves over the data axis
            (mesh_bytes); (b) two ranks on the one card over gloo (NCCL
            refuses two ranks on one GPU), started by torch.distributed.run
            (mesh_rank), run the CLI: train-vid --data-parallel 2
            --device-corpus --chunk 1 --steps-limit MESH_CLI_STEPS in
            float32 (and --fsdp where gloo takes its collectives; the line
            says which ran), then sample-wall --data-parallel 2, float and
            --int8, on its checkpoint; each against the same command on one
            rank in this process: the first step's losses within
            MESH_CLI_TOL (the later steps printed), one metrics record a
            step (rank 0 alone writes), the walls' frames equal, K1 once a
            step on each rank; each rank's seconds, peak bytes and
            collective bytes by axis. Both float32 parts run with TF32 off
            and the deterministic kernels (exact_f32).
19. mesh_tp_sp the seq and model axes (parallel/tp.py, sp.py): four gloo
            ranks share the card, started by torch.distributed.run
            (mesh_rank), and run train-vid --device-corpus --chunk 1
            (TP_SP_BATCH clips, TP_SP_STEPS steps, flagship widths,
            float32, exact_f32) through the CLI on each mesh of
            TP_SP_MESHES, each against the same command on one rank in
            this process: the first step's D losses within MESH_CLI_TOL
            (the G losses, after an Adam update from fresh slots, and the
            later steps printed), one metrics record a step, K1 once a
            step on each rank, no weight-shaped all-gather over `model` but
            the final checkpoint's, that checkpoint restored in this
            process and trained a step; then one D and one G pass's
            gradients of the seeded state on each mesh (tp_sp_grads)
            against one rank's, within TP_SP_GRAD_TOL of each net's
            largest gradient or TP_SP_FLOOR_X times one rank's own gap
            with the clips reversed; each rank's bytes a step by axis
            beside the count from the shapes (tp_sp_bytes), seconds and
            peak bytes, and each mesh's ms/step.

The launch counts are zeroed just before each of serve, the three
workflow commands, serve_int8, invert and recurrent (no kernel of the four
is on their paths, and they report their counts), train, profile, prep,
track and feed and read just after (bench runs in its own process and
launches none of the four), and so around each step of dataprep, eval and
serve_web that touches the card and each run of mesh and mesh_tp_sp
(the kernels line gives them per step). Then a
`kernels` JSON line, the nvidia-smi line, and as the last line {"ok":
true, "device": {...}}. Without CUDA it
exits 2 and prints no result. --profile adds a core/profile.py table of
one image-DCGAN step (workflow), one request's int8 and bf16 float sample
(serve_int8), one inversion step (invert), one full-width recurrent step
(recurrent), one detect_clips dispatch of a track source file (track: K3's
trace rows as many as its launches), one feed batch (feed: K2's, the
same), 16 frames through the gather flow (dataprep) and the track rate of
2 glyph clips (eval), and cProfile's table of the track phase's dispatcher
thread.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import cProfile
import dataclasses
import io
import itertools
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
import torch.distributed as dist
import torch.nn.functional as F

from gifgan_tpu_torch import cli
from gifgan_tpu_torch.core import checkpoint as ckpt
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core import profile as tprofile
from gifgan_tpu_torch.core.config import (DCGANConfig, InvertConfig,
                                          RecurrentImageConfig, TrackConfig,
                                          TrainConfig, VidGANConfig,
                                          load_config)
from gifgan_tpu_torch.data.device import DeviceCorpus
from gifgan_tpu_torch.data.loader import clip_batches_from_files
from gifgan_tpu_torch.data import scrape as tscrape
from gifgan_tpu_torch.data import video as tvideo
from gifgan_tpu_torch.data.synthetic import synthetic_clips, synthetic_stills
from gifgan_tpu_torch.data.video import read_gif, write_gif
from gifgan_tpu_torch.eval import fad as tfad
from gifgan_tpu_torch.eval import survey as tsurvey
from gifgan_tpu_torch.eval.track_rate import face_track_rate
from gifgan_tpu_torch.kernels import _build
from gifgan_tpu_torch.kernels import flow as kflow
from gifgan_tpu_torch.kernels import lrelu as klrelu
from gifgan_tpu_torch.kernels.flow_refine import (bilinear_windows, lk_refine,
                                                  lk_refine_plain)
from gifgan_tpu_torch.kernels.gather import (gather_rows_scaled,
                                             gather_rows_scaled_plain)
from gifgan_tpu_torch.kernels.haar_stages import (haar_stages,
                                                  haar_stages_plain)
from gifgan_tpu_torch.kernels.resize import (interp_taps, launch_plan,
                                             resize_normalize,
                                             resize_normalize_plain)
from gifgan_tpu_torch import invert as inv_api
from gifgan_tpu_torch.invert import optimize as inv_opt
from gifgan_tpu_torch.data.mnist import synthetic_digits
from gifgan_tpu_torch.models import dcgan, prednet, vid_dcgan
from gifgan_tpu_torch.models import recurrent_image as rimage
from gifgan_tpu_torch.models import rnn_prototypes as protos
from gifgan_tpu_torch.models.dcgan import to_device
from gifgan_tpu_torch.ops import nn as tnn
from gifgan_tpu_torch.ops import quant
from gifgan_tpu_torch.ops.image import denorm_u8, write_png
from gifgan_tpu_torch.serve import sampler
from gifgan_tpu_torch.serve.sampler import gif_wall, vid_sample_fn
from gifgan_tpu_torch.track import pipeline as tpipe
from gifgan_tpu_torch.track import synthetic_cascade
from gifgan_tpu_torch.track.boxes import Detection
from gifgan_tpu_torch.track.haar import (BatchedGatherHaarDetector,
                                         NativeHaarDetector)
from gifgan_tpu_torch.track.haar_device import (DeviceHaarDetector,
                                                letterbox_stack)
from gifgan_tpu_torch.track.pipeline import process_video
from gifgan_tpu_torch.track.stats import TrackStats
from gifgan_tpu_torch.train import early_stop, gan, loops, vid
from gifgan_tpu_torch.core.mesh import MODEL_AXIS, make_mesh
from gifgan_tpu_torch.core.tree import flatten
from gifgan_tpu_torch.parallel import fsdp as tfsdp
from gifgan_tpu_torch.parallel import collectives
from gifgan_tpu_torch.parallel import sp as tsp
from gifgan_tpu_torch.parallel import tp as ttp
from gifgan_tpu_torch.parallel.distributed import initialize
from gifgan_tpu_torch.parallel.dp import make_sharded_step, shard_train_state
from gifgan_tpu_torch.train import recurrent as rtrain
from gifgan_tpu_torch.train.gan import _differentiable, _grads

# H100 SXM data-sheet peaks (NVIDIA), for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12          # outside the tensor cores
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
# the crop bucket (sides padded to multiples of 32) of the track phase's
# flow calls: K4's level-0 image there, timed as "one pair"
TRACK_BUCKET = 224
# K3: the clip, the stages on the card, and the cost model of its bound
K3_FRAMES, K3_SIZE, EARLY_STAGES = 16, 256, 10
# the normalizer's operations; a node's are NODE_OPS a rect with a weight
# (3 corner sums, the weight product, the add to the feature, which the
# first rect does not need) + 3 (the area product, thr * nf, the compare)
OPS_PER_WINDOW, NODE_OPS = 20, 5
# feed: the crop GIFs repeated to one flagship batch per epoch
FEED_PATHS, FEED_EPOCHS, FEED_STEPS, CLIP_LEN, CLIP_SIZE = 64, 3, 2, 16, 64
# workflow: steps of train-dcgan (8 batches an epoch of the default 512
# stills, so it crosses an epoch) and of train-vid, and sample-wall requests
DCGAN_STEPS, VID_STEPS, WALL_REQUESTS, WF_CHUNK = 12, 8, 2, 4
# the flagship image widths (the vid widths are train-vid's defaults: z 120
# -> 100, T 16, hidden 512, d_filters 256)
WF_MODEL_FLAGS = ["--output-size", "64", "--z-dim", "100", "--gf-dim", "64",
                  "--df-dim", "64", "--compute-dtype", "bfloat16",
                  "--packed-c3"]
# serve_int8: calibration batches, finishing steps, the card-vs-CPU batch
INT8_CALIB, INT8_FINISH_STEPS, INT8_CHECK_VIDEOS, INT8_BIG_BATCH = 2, 20, 4, 256
# invert: the card-vs-CPU problem's batch and Adam steps; the invert
# command's steps; z-extract's clips (one batch); the nested variant's
# steps; the timed chunk
INV_CHECK_BATCH, INV_CHECK_STEPS, INV_STEPS = 8, 20, 200
# the check's rate: Adam's sign-like steps on the components with
# near-zero gradients part two free runs' z by up to ~2 lr an update at any
# rate (_invert_check says how the check holds the card all the same)
INV_CHECK_LR = 0.01
INV_CLIPS, INV_NESTED_STEPS, INV_TIMED_STEPS = 8, 10, 50
# recurrent: train-recurrent's runs (the JAX command's defaults: gf 64,
# batch 40, 16 + 1 frames of 64x64x3, LSTM 100, float32) on a synthetic
# corpus of two batches; the conditional DCGAN (MNIST width), PredNet (the
# study's width) and their step counts; warm and timed steps
REC_CLIPS, REC_STEPS, REC_RESUME_STEPS, REC_ROLLOUT = 80, 4, 2, 16
REC_WIDTH = dict(image_size=64, c_dim=3, seq_length=16, base_filters=64,
                 lstm_units=100, batch_size=40)
COND_BATCH, COND_STEPS = 64, 30
PREDNET_BATCH, PREDNET_LEN, PREDNET_CLIPS, PREDNET_STEPS = 16, 16, 64, 30
WARM_STEPS, TIMED_STEPS = 2, 5
# dataprep: the scrape's keywords and fake result page, stills per clip
SCRAPE_KEYWORDS, SCRAPE_PER_PAGE, SAMPLE_FRAMES = 2, 6, 5
# eval: FAD images a set (the reference's sets hold thousands) and the
# command's batch; the wall GIFs and glyph GIFs whose track rate is read
# (the reference evaluates 250 a variant); exported survey samples a
# variant; the h2 features' card-vs-CPU tolerance (tests/test_torch_eval.py)
FAD_IMAGES, FAD_BATCH, FEATURE_TOL = 512, 256, 1e-5
TRACK_RATE_CLIPS, GLYPH_CLIPS, SURVEY_SAMPLES = 64, 16, 8
# serve_web: repeats of each explorer action (the median is printed), the
# explorer sampler's card-vs-CPU tolerance (float32, TF32 off), the z rows
# of its loaded description, the webcam's /animate requests (the
# reference's defaults: 1200 steps, batch 16) and make-paths paths, the
# survey ratings posted
EXPLORER_REPEATS, EXPLORER_TOL, EXPLORER_LOAD = 3, 1e-4, 8
WEBCAM_REQUESTS, WEBCAM_PATHS, SURVEY_RATINGS = 2, ("smile", "frown"), 8
# K1's chain floor: one row of this many bytes (one 16-byte vector)
ROW_FLOOR_BYTES = 16
# lrelu: the image D tap's lrelu inputs at 4,096 frames (NHWC), and the
# vid-D's first conv3d output as conv3d hands it on, (B, C, T, H, W)
# permuted to channels last; launches in one flagship train step (24
# forward, 18 backward); the host-paced caller's batch and calls
LRELU_SHAPES = {"h0": (4096, 32, 32, 64), "h1": (4096, 16, 16, 128),
                "h2": (4096, 8, 8, 256), "vid_d_h1": (256, 256, 8, 4, 4)}
LRELU_PERMUTED = ("vid_d_h1",)
LRELU_PER_STEP = 24 + 18
LRELU_HOST_BATCH, LRELU_HOST_CALLS = 16, 200
LRELU_GRAPH_CALLS = 10
# profile: summarize_trace's device total against key_averages(); the time
# limits of bench (its flagship run takes about half a minute) and of a
# profile_child
PROFILE_AGREE, BENCH_TIMEOUT_S, CHILD_TIMEOUT_S = 0.01, 600, 300
# the train capture's process: its corpus of random clips, and the prefix
# of the line that hands its launch counts back
PROFILE_CLIPS, PROFILE_LAUNCHES = 512, "[profile] launches_json="
# mesh: steps of the one-rank runs (the parameters gated at the step-2
# checkpoint, the step-4 ones printed), chunks timed in bf16 (K steps
# each), the two-rank CLI run's steps (a chunk a step: a flagship step
# after one Adam update moves its losses by up to ~3e-3 for a 1e-7
# relative change of the gradients, so only the first step is gated), the
# synthetic clips of both, and the gates: (a) against the no-mesh run, (b)
# the first step's losses against one rank's
MESH_STEPS, MESH_TIMED_CHUNKS, MESH_CLI_STEPS, MESH_CLIPS = 4, 3, 8, 128
MESH_PARITY_TOL, MESH_CLI_TOL, MESH_TIMEOUT_S = 1e-5, 1e-4, 600
# mesh_tp_sp: four gloo ranks sharing the card run train-vid through the
# CLI on each of three meshes of the seq and model axes, at the flagship
# widths in float32, cut in depth only: a batch of 8 clips (128 frames)
# and 4 steps, since gloo stages every activation collective through the
# host (at the flagship's 64 clips the D tap's h0 alone is 268 MB)
TP_SP_RANKS, TP_SP_BATCH, TP_SP_STEPS = 4, 8, 4
# the gradient check: one D and one G pass's gradients on each mesh against
# one rank's, each net's largest gap within this share of its largest
# gradient, or within TP_SP_FLOOR_X times one rank's own gap when the
# clips are reversed, where that is larger (at the init the fake
# activations sit below the vid-D BN's eps, and the G gradient that comes
# back through it is mostly float32 cancellation)
TP_SP_GRAD_TOL, TP_SP_FLOOR_X = 1e-4, 10
TP_SP_MESHES = {
    "dp2_tp2": ["--data-parallel", "2", "--tensor-parallel", "2"],
    "dp2_sp2": ["--data-parallel", "2", "--seq-parallel", "2"],
    "sp2_tp2": ["--seq-parallel", "2", "--tensor-parallel", "2"]}
REPO = os.path.dirname(os.path.abspath(__file__))
# the H100 SXM data sheet's dense int8 tensor-core rate
INT8_OPS = 1979e12
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
}, {
    "name": "lrelu",
    "route": "cuda",
    "source": "gifgan_tpu_torch/csrc/lrelu.cu",
    "replaces": "none",
    "counter": klrelu.lrelu,
    "path": "train",
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
        library_ms="none", aside_index_select_u8_copy_ms=f"{lib_ms:.5f}",
        bound_ms=f"{bound_ms:.5f}", bound_share=f"{bound_ms / kernel_ms:.3f}",
        eager_ms_kernel_plain_library=",".join(f"{t:.5f}" for t in eager))
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "library_call": "none: no single PyTorch call computes the "
                            "function",
            "aside_index_select_u8_copy_ms": lib_ms}


def phase_k1_stills(corpus, seed):
    """K1 at train-dcgan's shape: (B, 64*64*3) rows of a stills corpus, here
    the resident clips' frames viewed as (N*T, 12288)."""
    d = CLIP_SIZE * CLIP_SIZE * 3
    data = corpus.data.view(-1, d)
    n = data.shape[0]
    rng = np.random.default_rng(seed + 11)
    ids = rng.integers(0, n, BATCH)
    ids[1] = ids[2] = ids[0]                     # duplicates
    ids[3], ids[4] = n + 17, -3                  # out of range
    idx = torch.as_tensor(ids, device="cuda")
    got = gather_rows_scaled(data, idx)
    want = gather_rows_scaled_plain(data, idx)
    torch.cuda.synchronize()
    check(got.shape == (BATCH, d), "K1 stills shape")
    err = float((got - want).abs().max())
    check(err <= 2.0 ** -23, f"K1 stills within 1 ulp: {err}")
    sets = [(data, torch.as_tensor(rng.integers(0, n, BATCH), device="cuda"))
            for _ in range(64)]
    ms = graph_ms(gather_rows_scaled, sets)
    plain_ms = graph_ms(gather_rows_scaled_plain, sets)
    ms2 = graph_ms(gather_rows_scaled, sets)
    # an aside: the launch floor, a one-element in-place add_ in a graph of
    # as many calls
    one = torch.zeros(1, device="cuda")
    floor_ms = graph_ms(lambda t: t.add_(1.0), [(one,)] * len(sets))
    # the floor of K1's own chain (launch -> id load -> row load -> store):
    # K1 on one 16-byte row (n = m = 1, d = 16), in a graph of as many calls
    row = torch.arange(ROW_FLOOR_BYTES, dtype=torch.uint8,
                       device="cuda").view(1, -1)
    row_idx = torch.zeros(1, dtype=torch.int64, device="cuda")
    check(torch.equal(gather_rows_scaled(row, row_idx),
                      gather_rows_scaled_plain(row, row_idx)),
          "K1 on one 16-byte row equals its plain version")
    row_floor_ms = graph_ms(gather_rows_scaled,
                            [(row, row_idx)] * len(sets))
    unique = int(torch.unique(idx.clamp(0, n - 1)).numel())
    nbytes = unique * d + BATCH * d * 4 + BATCH * 8
    bound_ms = max(nbytes / HBM_BYTES_PER_S,
                   2 * BATCH * d / F32_FLOPS) * 1e3
    kernel_ms = min(ms, ms2)
    floor_share = max(bound_ms, row_floor_ms) / kernel_ms
    say("K1", case="stills", rows=BATCH, row_bytes=d, max_abs_err=err,
        tolerance=2.0 ** -23, unique_rows=unique,
        kernel_ms=f"{ms:.5f},{ms2:.5f}", plain_ms=f"{plain_ms:.5f}",
        bound_ms=f"{bound_ms:.5f}", bound_bytes=nbytes,
        bound_share=f"{bound_ms / kernel_ms:.3f}",
        aside_launch_floor_ms=f"{floor_ms:.5f}",
        one_row_floor_ms=f"{row_floor_ms:.5f}",
        share_of_max_bound_floor=f"{floor_share:.3f}")
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "launch_floor_ms": floor_ms, "one_row_floor_ms": row_floor_ms,
            "share_of_max_bound_floor": floor_share}


def k2_needed_bytes(n, h, w, c, oh, ow, element_size):
    """What K2's bound counts: the source values under a tap with a
    non-zero weight, each once, and every output float once. Also the whole
    source rows that hold such a value (what 32-byte sectors make a kernel
    fetch), both in bytes."""
    rows, cols = (int(np.unique(idx[wt != 0]).size) for idx, wt in
                  (interp_taps(h, oh), interp_taps(w, ow)))
    out_bytes = n * oh * ow * c * 4
    return (n * rows * cols * c * element_size + out_bytes,
            n * rows * w * c * element_size + out_bytes)


def phase_k2(seed):
    """K2 at the feed's shape, on a float32 non-square case, on unaligned
    rows, past gridDim.y's frames and 2^31 input bytes, and at resize_u8's
    shape for a scraped GIF."""
    g = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    n, h, w, c, oh, ow = BATCH * CLIP_LEN, 256, 256, 3, CLIP_SIZE, CLIP_SIZE

    def frames(shape, offset=0):
        """uint8 frames starting `offset` bytes into their storage."""
        flat = torch.randint(0, 256, (math.prod(shape) + offset,),
                             device=DEVICE, dtype=torch.uint8, generator=g)
        return flat[offset:].view(shape)

    def compare(case, x, oh, ow, tol, normalize=True, last=None):
        """The kernel against the plain version (on the last `last` frames
        only, where given), within `tol`."""
        got = resize_normalize(x, oh, ow, normalize=normalize)
        part = slice(-last, None) if last else slice(None)
        want = resize_normalize_plain(x[part], oh, ow, normalize)
        torch.cuda.synchronize()
        check(got.shape == (x.shape[0], oh, ow, x.shape[3])
              and got.dtype == torch.float32, f"K2 {case} shape")
        err = float((got[part] - want).abs().max())
        say("K2", case=case, shape=f"{tuple(x.shape)}{str(x.dtype)[6:]}->"
            f"({oh},{ow})", offset=x.storage_offset(),
            plan=",".join(f"{k}={v}" for k, v in
                          launch_plan(x.shape[3], oh, ow)._asdict().items()),
            max_abs_err=err, tolerance=tol,
            compared_frames=want.shape[0])
        check(err <= tol, f"K2 {case} within {tol} of the plain version: "
                          f"{err}")
        return got, err

    # Per output value: two 2-tap row sums and one 2-tap column sum of
    # float32 products, then the scale; the kernel fuses each sum into one
    # fma and the plain version's matmuls round each product. 4 ulp of the
    # largest magnitude before the final subtraction: 2^-20 for y / 127.5 in
    # [0, 2], 2^-13 for y in [0, 255].
    tol, tol_f = 2.0 ** -20, 2.0 ** -13
    sets = [(frames((n, h, w, c)), oh, ow)
            for _ in range(3)]           # 201 MB each: past the 50 MB L2
    x = sets[0][0]
    got, err = compare("feed", x, oh, ow, tol)
    check(float(got.min()) >= -1.0 and float(got.max()) <= 1.0,
          "K2 output in [-1, 1]")
    xf = torch.rand((5, 90, 120, 3), device=DEVICE, generator=g) * 255
    _, err_f = compare("f32", xf, 48, 100, tol_f, normalize=False)
    compare("wc-363", frames((64, 93, 121, 3)), 64, 64, tol)
    offset_sets = [(frames((n, h, w, c), offset=1), oh, ow)
                   for _ in range(3)]
    compare("feed-offset-1", offset_sets[0][0], oh, ow, tol)
    compare("frames-70000", frames((70_000, 4, 4, 3)), 2, 2, tol)
    big = frames((11_000, h, w, c))                # 2.16 GB: past 2^31
    check(big.numel() > 2 ** 31, "K2 input past 2^31 bytes")
    compare("bytes-over-2^31", big, oh, ow, tol, last=8)
    del big
    gif_sets = [(frames((48, 360, 480, 3)), 256, 256, False)
                for _ in range(3)]             # data/video.py resize_u8
    compare("resize_u8-360x480", gif_sets[0][0], 256, 256, tol_f,
            normalize=False)

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
    del lib, got
    ms = graph_ms(resize_normalize, sets)
    plain_ms = graph_ms(resize_normalize_plain, sets, reps=2)
    lib_ms = graph_ms(library, [(x_nchw,)])
    offset_ms = graph_ms(resize_normalize, offset_sets)
    gif_ms = graph_ms(resize_normalize, gif_sets)
    ms2 = graph_ms(resize_normalize, sets)
    # an aside: a device copy moving as many bytes as K2 moves at the feed
    # shape (whole needed rows in, every float out), the rate a plain stream
    # reaches on this card; as many sets and reps as K2's time, twice
    nbytes, row_bytes = k2_needed_bytes(n, h, w, c, oh, ow, 1)
    del sets, offset_sets
    copy_sets = [tuple(torch.empty(row_bytes // 2, dtype=torch.uint8,
                                   device=DEVICE) for _ in range(2))
                 for _ in range(3)]
    copy_ms = [graph_ms(lambda a, b: b.copy_(a), copy_sets)
               for _ in range(2)]
    del copy_sets
    # The bound counts the bytes the function needs (at 256 -> 64 rows and
    # columns 4i+1 and 4i+2 only, a quarter of the input). Two asides, not
    # the bound: whole source rows that hold a needed value, and every
    # input byte.
    all_bytes = x.numel() + n * oh * ow * c * 4
    bound_ms = max(nbytes / HBM_BYTES_PER_S,
                   6 * n * oh * ow * c / F32_FLOPS) * 1e3
    kernel_ms = min(ms, ms2)
    gif_bytes, _ = k2_needed_bytes(48, 360, 480, 3, 256, 256, 1)
    gif_bound_ms = gif_bytes / HBM_BYTES_PER_S * 1e3
    say("K2", shape=f"({n},{h},{w},{c})u8->({oh},{ow})", max_abs_err=err,
        tolerance=tol, f32_case_err=err_f, f32_case_tolerance=tol_f,
        kernel_ms=f"{ms:.5f},{ms2:.5f}", plain_ms=f"{plain_ms:.5f}",
        library_ms_interpolate_f32_nchw=f"{lib_ms:.5f}",
        library_max_abs_diff=lib_diff, bound_ms=f"{bound_ms:.5f}",
        bound_bytes=nbytes, bound_share=f"{bound_ms / kernel_ms:.3f}",
        aside_whole_rows_bytes=row_bytes,
        aside_whole_rows_ms=f"{row_bytes / HBM_BYTES_PER_S * 1e3:.5f}",
        aside_all_input_bytes=all_bytes,
        aside_all_input_ms=f"{all_bytes / HBM_BYTES_PER_S * 1e3:.5f}",
        aside_offset_1_ms=f"{offset_ms:.5f}",
        aside_whole_rows_tb_per_s=f"{row_bytes / kernel_ms / 1e9:.3f}",
        aside_copy_of_whole_rows_bytes_ms=",".join(
            f"{t:.5f}" for t in copy_ms),
        aside_copy_tb_per_s=",".join(
            f"{row_bytes / t / 1e9:.3f}" for t in copy_ms))
    say("K2", aside="resize_u8", shape="(48,360,480,3)u8->(256,256) raw",
        kernel_ms=f"{gif_ms:.5f}", bound_bytes=gif_bytes,
        bound_ms=f"{gif_bound_ms:.5f}",
        bound_share=f"{gif_bound_ms / gif_ms:.3f}")
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
    one pair of the track path's crop bucket (TRACK_BUCKET)."""
    b, size, k, win, iters, levels, tol = 8, 224, 200, 15, 10, 3, 1e-2
    shifts = [(3, -2), (-1, 4), (2, 2), (-3, -1), (0, 5), (4, 0), (-2, 3),
              (1, -4)]
    img0 = smooth_images(b, size, seed + 6)
    img1 = torch.stack([torch.roll(i, (dy, dx), (0, 1))
                        for i, (dx, dy) in zip(img0, shifts)])
    pts, valid, per_level = k4_levels(img0, img1, k, win, iters, levels, tol,
                                      timed=True)
    # one pair alone at the crop bucket the track path launches, all three
    # levels, timed
    i0 = smooth_images(1, TRACK_BUCKET, seed + 7)
    bucket = k4_levels(i0, torch.roll(i0, (2, -3), (1, 2)), k, win, iters,
                       levels, tol, timed=True)[2]

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
            track_bucket=TRACK_BUCKET, corners=k, max_abs_err_px=r["err"],
            tolerance_px=tol, kernel_ms_one_pair=f"{r['ms']:.5f}",
            kernel_ms_one_pair_one_step=f"{r['ms_one_step']:.5f}",
            plain_ms=f"{r['plain_ms']:.5f}", bound_ms=f"{r['bound_ms']:.5f}",
            bound_by=r["bound_by"])
    say("K4", median_flow_err_px=f"{worst:.4f}")
    top = per_level[-1]                  # level 0: the full-size images
    track = bucket[-1]                 # level 0 of the track bucket
    errs = [r[key] for r in per_level + bucket
            for key in ("err", "err_one_pair")]
    return {"max_abs_err": max(errs), "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            "library_call": "none: no single PyTorch call computes the "
                            "iterated LK solve",
            "ms_by_level": {str(r["level"]): r["ms"] for r in per_level},
            "ms_one_pair": top["ms_one_pair"],
            "track_bucket_one_pair": {
                "hw": track["hw"], "ms": track["ms"],
                "ms_one_step": track["ms_one_step"],
                "plain_ms": track["plain_ms"], "bound_ms": track["bound_ms"],
                "bound_by": track["bound_by"]}}


def k3_node0(ii, ii2, tables, frames_yx, trees):
    """For the windows at `frames_yx` ((k, 3) frame, gy, gx at stride 1) and
    each tree of `trees`: whether node 0 sends the window left, computed
    as the kernel computes it (same operations in the same order, in the
    canvases' type)."""
    _, ch, cw = ii.shape
    flat = (frames_yx[:, 0] * ch + frames_yx[:, 1]) * cw + frames_yx[:, 2]
    ww, wh = tables.window_w, tables.window_h
    inv_area = float({torch.float32: np.float32, torch.float64: np.float64}[
        ii.dtype](1.0 / (ww * wh)))
    img, img2 = ii.reshape(-1), ii2.reshape(-1)

    def rect(im, x0, y0, rw, rh):
        at = flat + (y0 * cw + x0)
        return ((im[at] + im[at + (rh * cw + rw)]) - im[at + rw]
                ) - im[at + rh * cw]

    mean_c = rect(img, 0, 0, ww, wh) * inv_area - 128.0
    var = rect(img2, 0, 0, ww, wh) * inv_area - mean_c * mean_c
    nf = torch.where(var > 0, torch.sqrt(torch.clamp(var, min=0.0)),
                     torch.ones_like(var))
    geo, wts, thr = tables.host[:3]
    for tr in trees:
        acc = None
        for r in range(3):
            wt = float(wts[tr, 0, r])
            if wt == 0.0:
                continue
            g = int(geo[tr, 0, r])
            v = rect(img, g & 31, (g >> 5) & 31, (g >> 10) & 31,
                     (g >> 15) & 31) * wt
            acc = v if acc is None else acc + v
        yield tr, acc * inv_area < float(thr[tr, 0]) * nf


def k3_cost(plan, ii, ii2, n_frames, flops):
    """What one K3 call over these canvases must do, counted from this
    run's data. The windows entering each early stage are the kernel's own
    alive masks after 0..9 stages. Operations: OPS_PER_WINDOW for the
    normalizer of every valid window; for every tree a window sees, node
    0's rects with a weight (5 a rect + 2, NODE_OPS) and the leaf add; node
    1's, only where node 0 sends the window to it, which `k3_node0` counts
    (the stage sums' compare is left out). The bound is the larger of bytes
    (both canvases, the validity grid and the tables read once, the mask
    written once, at HBM_BYTES_PER_S) and these operations at `flops`, the
    rate of the canvases' type. Asides: the operations with no exit (both
    nodes of every tree for every valid window), and the corner loads the
    counted rects make as L1 transactions, one per warp and load."""
    grid, tables = plan.grid, plan.tables
    n_valid = int(grid.valid.sum()) * n_frames
    ends = (0,) + tables.stage_end[:EARLY_STAGES]
    rects = (tables.host[1][:ends[-1]] != 0).sum(axis=2)       # (N, 2)
    leaf = tables.host[4][:ends[-1]] != 0                      # (N, 2)
    node = NODE_OPS * rects + 2
    entering, ops, loads, taken = [], n_valid * OPS_PER_WINDOW, 8 * n_valid, 0
    for s in range(EARLY_STAGES):
        at = torch.nonzero(haar_stages(ii, ii2, grid, tables, s))
        entering.append(len(at))
        trees = range(ends[s], ends[s + 1])
        ops += len(at) * int((node[trees, 0] + 1).sum())
        loads += len(at) * 4 * int(rects[trees, 0].sum())
        for tr, left in k3_node0(ii, ii2, tables, at, trees):
            n1 = (0 if leaf[tr, 0] else int(left.sum())) + (
                0 if leaf[tr, 1] else len(at) - int(left.sum()))
            taken += n1
            ops += n1 * int(node[tr, 1])
            loads += n1 * 4 * int(rects[tr, 1])
    check(entering[0] == n_valid, "K3 cost: every valid window enters")
    counts = np.diff(ends)
    seen = float(np.dot(entering, counts))
    nbytes = (ii.numel() + ii2.numel()) * ii.element_size() + (
        n_frames + 1) * plan.ny * plan.nx + sum(
        a.nbytes for a in tables.host)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / flops * 1e3
    both = node[:, 0] + 1 + np.where(leaf.all(axis=1), 0, node[:, 1])
    no_exit_ms = n_valid * (OPS_PER_WINDOW + int(both.sum())) / flops * 1e3
    l1_ms = loads / 32 / L1_WARP_LOADS_PER_S * 1e3
    return {"windows": n_valid, "entering": entering, "trees": int(ends[-1]),
            "trees_seen": seen / n_valid, "node1_share": taken / seen,
            "ops_per_window": ops / n_valid, "bytes": nbytes,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "no_exit_ms": no_exit_ms,
            "l1_ms": l1_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _lrelu_bits(got, want):
    """Equal bit for bit, NaN where NaN: the values, and the sign of each
    zero."""
    nan = torch.isnan(got)
    if not torch.equal(nan, torch.isnan(want)):
        return False
    got, want = got[~nan], want[~nan]
    return torch.equal(got, want) and torch.equal(torch.signbit(got),
                                                  torch.signbit(want))


def phase_lrelu(seed):
    """The leaky ReLU through its wrapper (kernels/lrelu.py lrelu, what
    ops/nn.py lrelu calls on the card) at the tap's shapes and at the
    vid-D's permuted layout: both passes through autograd against their
    plain versions, bit for bit, one launch each way, the output in x's
    strides. At the tap's shapes each pass is timed beside its bound, the
    expression it replaces and the library's one call, F.leaky_relu;
    then a host-paced caller that runs forward only, the image D at a
    small batch, with the kernel and with the expression. Returns the
    kernels line's row."""
    bwd = klrelu._kernels()[1]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draw = lambda shape: torch.randn(shape, generator=gen, device="cuda",
                                     dtype=torch.bfloat16)
    expression = lambda x: torch.maximum(x, 0.2 * x)
    library = lambda x: F.leaky_relu(x, 0.2)
    grad_ms = lambda y, x, g: event_ms(
        lambda: torch.autograd.grad(y, x, g, retain_graph=True), [()],
        warmup=3, reps=20)
    rows = {}
    for case, shape in LRELU_SHAPES.items():
        x, g = draw(shape), draw(shape)
        if case in LRELU_PERMUTED:
            x, g = (t.permute(0, 2, 3, 4, 1) for t in (x, g))
        xr = x.detach().requires_grad_()
        before = klrelu.lrelu.launches
        y = klrelu.lrelu(xr, 0.2)
        y.backward(g)
        check(klrelu.lrelu.launches == before + 2,
              f"lrelu at {case}: one launch each way")
        check(y.stride() == x.stride(), f"lrelu at {case} keeps x's strides")
        for got, want, what in (
                (y.detach(), klrelu.lrelu_plain(x), "forward"),
                (xr.grad, klrelu.lrelu_backward_plain(x, g), "backward")):
            check(_lrelu_bits(got, want),
                  f"lrelu {what} at {case} equals its plain version")
        if case in LRELU_PERMUTED:
            say("lrelu", case=case, shape="x".join(map(str, x.shape)),
                strides=",".join(map(str, x.stride())), bits="equal")
            del x, g, xr, y
            continue
        nbytes = x.numel() * x.element_size()
        dx = torch.empty_like(x)
        yk, ye, yl = (f(xr) for f in (lambda t: klrelu.lrelu(t, 0.2),
                                      expression, library))
        # graphs of LRELU_GRAPH_CALLS calls; the kernel before and after
        # the others, its time the lesser (the first graph of a shape can
        # read slow)
        calls = [()] * LRELU_GRAPH_CALLS
        fwd_ms = lambda f: graph_ms(lambda: f(x), calls)
        kernel_bwd = lambda: graph_ms(
            lambda: klrelu._launch(bwd, 0.2, x, g, dx), calls)
        first = fwd_ms(lambda t: klrelu.lrelu(t, 0.2)), kernel_bwd()
        row = {
            "bound_fwd_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
            "plain_fwd_ms": fwd_ms(expression),
            "library_fwd_ms": fwd_ms(library),
            "bound_bwd_ms": 3 * nbytes / HBM_BYTES_PER_S * 1e3,
            "autograd_bwd_ms": grad_ms(yk, xr, g),
            "plain_bwd_ms": grad_ms(ye, xr, g),
            "library_bwd_ms": grad_ms(yl, xr, g)}
        row["kernel_fwd_ms"] = min(first[0], fwd_ms(
            lambda t: klrelu.lrelu(t, 0.2)))
        row["kernel_bwd_ms"] = min(first[1], kernel_bwd())
        row["fwd_share"] = row["bound_fwd_ms"] / row["kernel_fwd_ms"]
        row["bwd_share"] = row["bound_bwd_ms"] / row["kernel_bwd_ms"]
        say("lrelu", case=case, shape="x".join(map(str, shape)),
            **{k: f"{v:.5f}" for k, v in row.items()})
        rows[case] = row
        del x, g, xr, y, dx, yk, ye, yl
        torch.cuda.empty_cache()

    # the library's call on the values where a choice of rule shows
    x = torch.tensor([0.0, -0.0, 1e-40, -1e-40, 1.0, -1.0, float("nan")],
                     device="cuda").to(torch.bfloat16).requires_grad_()
    g = torch.full_like(x, 1.0)
    (dx_lib,) = torch.autograd.grad(library(x), x, g)
    dx_plain = klrelu.lrelu_backward_plain(x.detach(), g)
    library_fwd_same = _lrelu_bits(library(x.detach()),
                                   klrelu.lrelu_plain(x.detach()))
    differs = [f"{v}:{a}/{b}" for v, a, b in zip(
        x.detach().float().tolist(), dx_lib.float().tolist(),
        dx_plain.float().tolist()) if not _lrelu_bits(
            torch.tensor(a), torch.tensor(b))]

    # a host-paced forward-only caller: the image D at a small batch
    img = flagship()[0].image_gan
    params, state = (dcgan.to_device(t, "cuda") for t in
                     dcgan.init_discriminator(
                         torch.Generator().manual_seed(seed), img))
    imgs = torch.rand(LRELU_HOST_BATCH, img.output_size, img.output_size,
                      img.c_dim, device="cuda", generator=gen) * 2 - 1
    kernel_lrelu, host_us = tnn.lrelu, {"kernel": [], "expression": []}
    try:
        with torch.no_grad():
            for _ in range(3):
                for name, fn in (("kernel", kernel_lrelu),
                                 ("expression", lambda t, leak=0.2:
                                  torch.maximum(t, leak * t))):
                    tnn.lrelu = fn
                    run = lambda: dcgan.discriminator(params, state, imgs,
                                                      img, False)
                    for _ in range(10):
                        run()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    for _ in range(LRELU_HOST_CALLS):
                        run()
                    torch.cuda.synchronize()
                    host_us[name].append((time.perf_counter() - t) * 1e6
                                         / LRELU_HOST_CALLS)
    finally:
        tnn.lrelu = kernel_lrelu
    host = {k: float(np.median(v)) for k, v in host_us.items()}
    say("lrelu", case="library_and_host", library_fwd_same_bits=
        library_fwd_same, library_bwd_differs_at="|".join(differs) or "none",
        host_paced_d_forward_batch=LRELU_HOST_BATCH,
        host_us_per_call_kernel=",".join(f"{u:.1f}"
                                         for u in host_us["kernel"]),
        host_us_per_call_expression=",".join(
            f"{u:.1f}" for u in host_us["expression"]))
    h0 = rows["h0"]
    return {"max_abs_err": 0.0, "ms": h0["kernel_fwd_ms"],
            "plain_ms": h0["plain_fwd_ms"], "bound_ms": h0["bound_fwd_ms"],
            "bound_by": "bytes", "library_ms": h0["library_fwd_ms"],
            "library_call": "torch.nn.functional.leaky_relu(x, 0.2)",
            "library_fwd_same_bits": library_fwd_same,
            "library_bwd_differs_at": differs, "by_shape": rows,
            "host_paced_d_forward_us": host}


def phase_k3(xml, seed):
    """K3 against its plain version at the stage program's real shapes:
    float32 on a 16x256x256 clip (10 and all 20 stages) and float64 at the
    shape the track path launches; both instances timed with their
    bounds."""
    rng = np.random.default_rng(seed + 20)
    det = DeviceHaarDetector(xml, min_neighbors=3, device=DEVICE)
    check(det.early_stages == EARLY_STAGES, "10 early stages")
    n_all = len(det.cas.stage_thr)

    def canvases(frames, dtype, what):
        plan = det._plan(*frames.shape[1:])
        ii, ii2 = det._canvases(plan, torch.from_numpy(frames).to(DEVICE))
        check(ii.dtype == dtype, f"K3 {what} canvases are {dtype}")
        return plan, ii, ii2

    def compare(what, plan, ii, ii2, n_stages, few=True):
        """Kernel against plain, every byte; the plain call timed by CUDA
        events (thousands of large elementwise kernels: device-bound)."""
        before = haar_stages.launches
        got = haar_stages(ii, ii2, plan.grid, plan.tables, n_stages)
        torch.cuda.synchronize()
        check(haar_stages.launches == before + 1, "one K3 call counted")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = haar_stages_plain(ii, ii2, plan.grid.valid, plan.tables,
                                 n_stages)
        end.record()
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        check(got.dtype == torch.int8 and got.shape == (
            ii.shape[0], plan.ny, plan.nx), f"K3 {what} mask shape")
        say("K3", case=what, canvas=f"{ii.shape[0]}x{plan.canvas_h}x"
            f"{plan.canvas_w}", grid=f"{plan.ny}x{plan.nx}",
            trees=plan.tables.stage_end[n_stages - 1],
            survivors=int(got.sum()), differing_windows=differ,
            plain_ms_one_call=f"{start.elapsed_time(end):.3f}")
        check(differ == 0, f"K3 {what} mask equals the plain mask: {differ} "
                           f"windows differ")
        if few:
            check(0 < int(got.sum()) < got.numel() // 20,
                  f"K3 {what}: some windows survive, few")
        return differ, start.elapsed_time(end)

    sides = rng.integers(30, 140, K3_FRAMES)
    clip = np.stack([synthetic_cascade.planted_frame(
        rng, K3_SIZE, K3_SIZE, int(s), "noise")[0] for s in sides])
    plan, ii, ii2 = canvases(clip, torch.float32, "f32")
    check((len(plan.levels), plan.canvas_h, plan.canvas_w, plan.ny, plan.nx,
           plan.tables.stage_end[EARLY_STAGES - 1])
          == (27, 2662, 257, 2642, 237, 253), "K3 shapes at 16x256x256")
    differ = compare("f32 16x256x256", plan, ii, ii2, EARLY_STAGES)[0]
    differ += compare(f"f32 16x256x256 all {n_all} stages", plan, ii, ii2,
                      n_all, few=False)[0]
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
    plan64, ii64, ii2_64 = canvases(wide, torch.float64, "f64")
    d64, plain64_ms = compare(f"f64 {n_wide}x360x480 letterboxed to 384x480",
                              plan64, ii64, ii2_64, EARLY_STAGES)
    differ += d64

    cost = k3_cost(plan, ii, ii2, K3_FRAMES, F32_FLOPS)
    cost64 = k3_cost(plan64, ii64, ii2_64, n_wide, F64_FLOPS)
    args = (ii, ii2, plan.grid, plan.tables, EARLY_STAGES)
    args64 = (ii64, ii2_64, plan64.grid, plan64.tables, EARLY_STAGES)
    ms = graph_ms(haar_stages, [args] * 4)
    plain_ms = event_ms(lambda ii, ii2, grid, tables, n: haar_stages_plain(
        ii, ii2, grid.valid, tables, n), [args], warmup=1, reps=2)
    ms_all = graph_ms(haar_stages, [args[:4] + (n_all,)] * 4)
    ms64 = graph_ms(haar_stages, [args64] * 4)
    ms2 = graph_ms(haar_stages, [args] * 4)
    kernel_ms = min(ms, ms2)
    for name, c, t, p in (("f32 16x256x256", cost, f"{ms:.5f},{ms2:.5f}",
                           f"{plain_ms:.3f}"),
                          (f"f64 {n_wide}x384x480", cost64, f"{ms64:.5f}",
                           f"{plain64_ms:.3f}")):
        say("K3", case=name, windows=c["windows"],
            entering_stage=",".join(map(str, c["entering"])),
            mean_trees_per_window=f"{c['trees_seen']:.3f}", of=c["trees"],
            node1_share=f"{c['node1_share']:.4f}",
            ops_per_window=f"{c['ops_per_window']:.2f}", kernel_ms=t, plain_ms=p, library_ms="none",
            bound_ms=f"{c['bound_ms']:.5f}", bound_by=c["bound_by"],
            bound_bytes_ms=f"{c['bytes_ms']:.5f}",
            bound_ops_ms=f"{c['ops_ms']:.5f}",
            aside_ops_ms_no_exit=f"{c['no_exit_ms']:.5f}",
            aside_l1_corner_loads_ms=f"{c['l1_ms']:.5f}")
    say("K3", kernel_ms_all_20_stages=f"{ms_all:.5f}",
        bound_share=f"{cost['bound_ms'] / kernel_ms:.3f}",
        f64_bound_share=f"{cost64['bound_ms'] / ms64:.3f}")
    return {"max_abs_err": float(differ), "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": cost["bound_ms"],
            "bound_by": cost["bound_by"], "library_ms": None,
            "library_call": "none: no single PyTorch call evaluates a "
                            "cascade over a window grid",
            "ms_all_20_stages": ms_all,
            "mean_trees_per_window": cost["trees_seen"],
            "f64_track_shape": {
                "canvas": f"{n_wide}x{plan64.canvas_h}x{plan64.canvas_w}",
                "ms": ms64, "plain_ms": plain64_ms,
                "bound_ms": cost64["bound_ms"],
                "bound_by": cost64["bound_by"],
                "mean_trees_per_window": cost64["trees_seen"]}}


def iou(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2 = min(a[0] + a[2], b[0] + b[2])
    y2 = min(a[1] + a[3], b[1] + b[3])
    inter = max(0, x2 - x1) * max(0, y2 - y1)
    return inter / (a[2] * a[3] + b[2] * b[3] - inter)


def detect_agreement(got, want, truth):
    """The detect phase's criteria over per-clip, per-frame rect arrays
    (x, y, w, h): (glyph frames, frames whose primary box agrees with the
    host's (IoU > 0.6), planted glyphs found, noise frames, quiet noise
    frames)."""
    primary = lambda r: r[np.argmax(r[:, 2] * r[:, 3])]
    glyphs = agree = found = quiet = noise = 0
    for g_clip, w_clip, boxes in zip(got, want, truth):
        for g, w, box in zip(g_clip, w_clip, boxes):
            if box is None:
                noise += 1
                quiet += len(g) == 0
                continue
            glyphs += 1
            x, y, side = box
            found += len(g) > 0 and iou(primary(g), (x, y, side, side)) > 0.6
            agree += (len(g) > 0 and len(w) > 0
                      and iou(primary(g), primary(w)) > 0.6)
    return glyphs, agree, found, noise, quiet


def phase_detect(xml, seed):
    """detect_clips on 8 clips of mixed sizes against the host detector.
    Returns [(px, clips, truth, host boxes)] for dataprep's gather
    detector."""
    rng = np.random.default_rng(seed + 30)
    sets = []
    dev = DeviceHaarDetector(xml, min_neighbors=3, device=DEVICE)
    host = NativeHaarDetector(xml, min_neighbors=3)
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
        glyphs, agree, found, noise, quiet = detect_agreement(got, want,
                                                             truth)
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
        sets.append((px, clips, truth, want))
    return sets


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
    threads are not in it), and a core/profile.py table of one
    detect_clips dispatch (profile_child)."""
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
    shapes = []                        # K4's images, every level and call
    real_refine = kflow.lk_refine
    kflow.lk_refine = lambda img1, *a, **kw: (
        shapes.append(tuple(img1.shape)) or real_refine(img1, *a, **kw))
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
        kflow.lk_refine = real_refine
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
        centre_tolerance_px=CENTRE_TOL_PX, launches=launches,
        k4_images=dict(collections.Counter(
            "x".join(map(str, s)) for s in shapes)))
    check(max(shapes) == (1, TRACK_BUCKET, TRACK_BUCKET),
          f"K4's largest image in track is the {TRACK_BUCKET}-px bucket "
          f"phase K4 times: {max(shapes)}")
    if profile:
        profile_child("track", xml, os.path.join(in_dir, "src0.gif"))
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
    say("check", sample_rel_err=f"{s_err:.3g}",
        train_metrics_rel_err=f"{m_err:.3g}", d_loss=m_gpu["d_loss"])

    # one image-DCGAN step at the flagship width, float32, from one state
    # converted onto each device (interop, as a checkpoint carries it). The
    # Adam slots are warm (count 3): from fresh slots Adam's first update
    # moves a weight with a gradient at rounding level (~1e-8, Adam's eps)
    # by a different fraction of lr on each device, and the G loss of the
    # next update reads that as a spread of a few 1e-3
    icfg = DCGANConfig(output_size=64, c_dim=3, z_dim=100, gf_dim=64,
                       df_dim=64, packed_c3=True)
    itcfg = TrainConfig(batch_size=BATCH)
    flat = interop.to_jax_flat(gan.init_train_state(
        torch.Generator().manual_seed(seed + 5), icfg, itcfg, device="cpu"))
    _warm_adam(flat, rng)
    images = rng.uniform(-1, 1, (BATCH, 64, 64, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, (BATCH, 100)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        ts = gan.TrainState.from_tree(interop.from_jax_flat(flat, dev))
        t = time.perf_counter()
        ts, m = gan.train_step(ts, torch.from_numpy(images).to(dev),
                               torch.from_numpy(z).to(dev), None, icfg,
                               itcfg)
        out[dev] = (interop.to_jax_flat(ts),
                    {k: float(v) for k, v in m.items()},
                    (time.perf_counter() - t) * 1e3)
    (p_cpu, m_cpu, cpu_ms), (p_gpu, m_gpu, _) = out["cpu"], out["cuda"]
    m_err = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-6)
                for k in m_cpu)
    check(m_err < 1e-3, f"image-GAN step metrics card vs CPU rel err {m_err}")
    # Adam moves a weight by ~lr whatever its gradient's size, so a
    # gradient at rounding level may part the two by up to ~lr an update
    p_err = max(float(np.abs(p_gpu[k] - p_cpu[k]).max()) for k in p_cpu
                if k.startswith("params/")) / itcfg.learning_rate
    check(p_err <= 3.0, f"image-GAN weights card vs CPU: {p_err} x lr")
    s_err = max(float(np.abs(p_gpu[k] - p_cpu[k]).max()
                      / max(np.abs(p_cpu[k]).max(), 1e-6))
                for k in p_cpu if k.startswith("state/"))
    check(s_err < 1e-3, f"image-GAN BN state card vs CPU rel err {s_err}")
    torch.backends.cudnn.allow_tf32 = tf32[0]
    torch.backends.cuda.matmul.allow_tf32 = tf32[1]
    say("check", model=f"dcgan 64x64 gf=df=64 batch {BATCH} float32",
        train_metrics_rel_err=f"{m_err:.3g}",
        weights_max_abs_err_over_lr=f"{p_err:.3g}",
        bn_state_rel_err=f"{s_err:.3g}", d_loss=m_gpu["d_loss"],
        g_loss=m_gpu["g_loss"], cpu_step_ms=f"{cpu_ms:.0f}")


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


def _records(run_dir):
    with open(os.path.join(run_dir, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _drive(argv):
    """cli.main(argv) with the launch counts zeroed before and read after;
    (seconds, launches, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    check(cli.main(argv) == 0, f"{argv[0]} exits 0")
    torch.cuda.synchronize()
    return (time.perf_counter() - t, read_counts(),
            torch.cuda.max_memory_allocated())


def _drive_wall(argv):
    """_drive of a sample-wall command with its gif_wall call timed:
    (ms per request, seconds, launches, peak bytes)."""
    calls = []
    timed_wall = sampler.gif_wall

    def gif_wall_timed(*a, **kw):
        t = time.perf_counter()
        n = timed_wall(*a, **kw)
        calls.append((time.perf_counter() - t) * 1e3)
        return n

    sampler.gif_wall = gif_wall_timed
    try:
        secs, launches, peak = _drive(argv)
    finally:
        sampler.gif_wall = timed_wall
    return (calls[0] / int(argv[argv.index("--num-batches") + 1]), secs,
            launches, peak)


def _check_run(name, run_dir, steps, grids):
    """A training run's files, finite losses and step times (ms/step of
    each logged chunk from the metrics log's steps_per_sec)."""
    recs = _records(run_dir)
    check(recs and recs[-1]["step"] == steps, f"{name} ran {steps} steps")
    for r in recs:
        check(math.isfinite(r["d_loss"]) and math.isfinite(r["g_loss"]),
              f"{name} losses finite at step {r['step']}")
    for f in ["params.json", "train_metrics.jsonl"]:
        check(os.path.exists(os.path.join(run_dir, f)), f"{name} {f}")
    names = os.listdir(run_dir)
    for prefix, ext in grids:
        check(any(n.startswith(prefix) and n.endswith(ext) for n in names),
              f"{name} wrote a {prefix}*{ext} grid: {sorted(names)}")
    check(ckpt.latest_step(os.path.join(run_dir, "checkpoints")) == steps,
          f"{name} final checkpoint at step {steps}")
    return [1e3 / r["steps_per_sec"] for r in recs], recs[-1]


def phase_workflow(seed, workdir, profile=False):
    """train-dcgan -> train-vid with its image GAN grafted -> sample-wall,
    through the port's CLI at the flagship width."""
    img, vid_run, wall = (os.path.join(workdir, n)
                          for n in ("img", "vid", "wall"))
    flags = WF_MODEL_FLAGS + [
             "--batch-size", str(BATCH),
             "--sample-every", "8", "--checkpoint-every", "8",
             "--seed", str(seed), "--device-corpus", "--chunk",
             str(WF_CHUNK)]
    k1 = {}
    for name, argv, steps, grids in (
            ("train_dcgan", ["train-dcgan", "--run-dir", img, "--dataset",
                             "synthetic", "--steps-limit", str(DCGAN_STEPS)],
             DCGAN_STEPS, [("train_", ".png")]),
            ("train_vid", ["train-vid", "--run-dir", vid_run,
                           "--steps-limit", str(VID_STEPS),
                           "--first-frame-loss-scalar", "1.0",
                           "--image-gan-checkpoint",
                           os.path.join(img, "checkpoints")],
             VID_STEPS, [("sample_", ".gif"), ("cross_sample_", ".gif")])):
        secs, launches, peak = _drive(argv + flags)
        k1[name] = launches["gather_rows_scaled"]
        check(k1[name] == steps, f"{name}: K1 launched once a step: "
                                 f"{launches}")
        chunk_ms, last = _check_run(name, argv[2], steps, grids)
        say("workflow", run=name, steps=steps, chunk=WF_CHUNK,
            ms_per_step_first=f"{chunk_ms[0]:.2f}",
            ms_per_step_warm_median=f"{float(np.median(chunk_ms[1:])):.2f}",
            ms_per_step_chunks=",".join(f"{t:.2f}" for t in chunk_ms),
            seconds=f"{secs:.2f}", peak_bytes=peak,
            d_loss=f"{last['d_loss']:.5f}", g_loss=f"{last['g_loss']:.5f}",
            launches=launches)

    # the graft: train-vid's frozen image nets are train-dcgan's final ones
    want = ckpt.load_flat(os.path.join(img, "checkpoints"))
    got = ckpt.load_flat(os.path.join(vid_run, "checkpoints"))
    leaves = 0
    for k, v in want.items():
        if k.startswith(("params/", "state/")):
            top, net, rest = k.split("/", 2)
            g = got[f"{top}/img_{net}/{rest}"]
            check(g.dtype == v.dtype and np.array_equal(g, v),
                  f"grafted {k} bit-equal")
            leaves += 1
    # and the image checkpoint restores into a fresh state
    doc = load_config(os.path.join(img, "params.json"))
    fresh = gan.init_train_state(torch.Generator().manual_seed(seed + 9),
                                 doc["model"], doc["train"], device=DEVICE)
    restored = ckpt.restore(os.path.join(img, "checkpoints"), fresh)
    back = interop.to_jax_flat(restored)
    check(isinstance(restored, gan.TrainState) and sorted(back) == sorted(want)
          and all(np.array_equal(back[k], want[k]) for k in want),
          "train-dcgan checkpoint restores into a fresh TrainState")
    if profile:
        icfg, itcfg = doc["model"], doc["train"]
        side, c = icfg.output_size, icfg.c_dim
        g = torch.Generator(device=DEVICE).manual_seed(seed + 12)
        stills = torch.randint(0, 256, (8 * BATCH, side * side * c),
                               dtype=torch.uint8, device=DEVICE, generator=g)
        ids = torch.randint(0, 8 * BATCH, (1, BATCH), device=DEVICE,
                            generator=g)
        z = torch.rand(1, BATCH, icfg.z_dim, device=DEVICE, generator=g)
        step = lambda: gan.train_chunk_ids(
            restored, ids, z * 2 - 1, g, stills, icfg, itcfg,
            lambda d, i: gather_rows_scaled(d, i).reshape(-1, side, side, c))
        step()                                       # warm
        profile_step("train_dcgan", step)

    ms, secs, launches, peak = _drive_wall(
        ["sample-wall", "--checkpoint", os.path.join(vid_run, "checkpoints"),
         "--out-dir", wall, "--num-batches", str(WALL_REQUESTS),
         "--batch-size", str(BATCH), "--seed", str(seed)])
    gifs = [f for f in os.listdir(wall) if f.endswith(".gif")]
    check(len(gifs) == WALL_REQUESTS * BATCH, f"{len(gifs)} GIFs written")
    vcfg = load_config(os.path.join(vid_run, "params.json"))["model"]
    s = vcfg.image_gan.output_size
    frames = read_gif(os.path.join(wall, gifs[0]))
    check(frames.shape == (vcfg.vid_length, s, s, 3),
          f"a wall GIF is {frames.shape}")
    say("workflow", run="sample_wall", requests=WALL_REQUESTS,
        videos_per_request=BATCH, gifs=len(gifs),
        ms_per_request=f"{ms:.1f}",
        seconds_with_checkpoint_load=f"{secs:.2f}", peak_bytes=peak)
    say("workflow", graft="bit-equal", leaves=leaves,
        restore="train-dcgan checkpoint into a fresh TrainState")
    say("K1", case="stills", path="workflow",
        launches_train_dcgan=k1["train_dcgan"],
        launches_train_vid=k1["train_vid"])
    return k1


def _capture_acc(run):
    """run() with ops/quant.py's int8 contractions recorded: (its result,
    [(kind, int8 input, int8 weights, int32 accumulator)] in call order)."""
    rec = []
    lin, dec = quant._linear_acc, quant._deconv_acc

    def wrap(kind, fn):
        def f(xq, wq):
            acc = fn(xq, wq)
            rec.append((kind, xq, wq, acc))
            return acc
        return f

    quant._linear_acc = wrap("linear", lin)
    quant._deconv_acc = wrap("deconv", dec)
    try:
        out = run()
    finally:
        quant._linear_acc, quant._deconv_acc = lin, dec
    return out, rec


def _contraction_times(q, z, cfg):
    """Each int8 contraction of one request: its (m, k, n) after the
    sub-pixel im2col, im2col bytes and ms, _int_mm ms, the whole
    accumulator's ms, and the bound of the product: its int8 operations at
    INT8_OPS, counted from the real taps (m * wq.numel() multiply-adds: 25
    of the sub-pixel matrix's 36 taps a phase set are real), or its int8
    inputs and int32 output at HBM_BYTES_PER_S."""
    _, rec = _capture_acc(lambda: vid.sample_videos_q(q, z, cfg))
    rows = []
    for (grp, name), (kind, xq, wq, _) in zip(quant._VID_LAYER_ORDER, rec):
        if kind == "linear":
            a, b, col_ms = xq, wq, 0.0
            acc_fn = quant._linear_acc
        else:
            a = quant._deconv_cols(xq).reshape(-1, 9 * xq.shape[-1])
            b = quant._subpixel_weight(wq)
            col_ms = event_ms(quant._deconv_cols, [(xq,)], warmup=3, reps=20)
            acc_fn = quant._deconv_acc
        m, k, n = a.shape[0], a.shape[1], b.shape[1]
        mm_ms = event_ms(quant.int8_matmul, [(a, b)], warmup=3, reps=20)
        acc_ms = event_ms(acc_fn, [(xq, wq)], warmup=3, reps=20)
        bound_ms = max(2 * m * wq.numel() / INT8_OPS,
                       (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S) * 1e3
        rows.append(dict(layer=f"{grp}/{name}", m=m, k=k, n=n,
                         im2col_bytes=a.numel() if kind == "deconv" else 0,
                         im2col_ms=col_ms, int_mm_ms=mm_ms, acc_ms=acc_ms,
                         int_mm_bound_ms=bound_ms))
        del a, b
    return rows


def phase_serve_int8(ts, cfg, seed, workdir, vid_ckpt, profile=False):
    """int8 serving (ops/quant.py) at the flagship width: quantize,
    calibrate, correct and finish the flagship stack; hold every int8
    contraction on the card against the CPU; int8 against float; device
    times; then the deployment workflow through the CLI on the workflow
    phase's train-vid run."""
    reset_counts()
    # 1. BN running moments of the generators from train-mode passes
    #    (decay 0.9: 40 passes leave 1.5 % of the init moments)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 30)
    state = ts.state
    with torch.no_grad():
        for _ in range(40):
            z = torch.rand(BATCH, cfg.z_input_size, device=DEVICE,
                           generator=g) * 2 - 1
            _, _, gs, igs = vid_dcgan.generate_videos(
                ts.params, dict(state), z, cfg, train=True)
            state = dict(state, vid_generator=gs, img_generator=igs)
    ts = ts._replace(state=state)

    # 2. quantize_sampler (mse calibration, bias correction), finishing
    torch.cuda.synchronize()
    t = time.perf_counter()
    q, _ = vid.quantize_sampler(ts, cfg, calib_batches=INT8_CALIB,
                                calib_mode="mse", bias_correct=True)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t
    t = time.perf_counter()
    q = quant.finish_vid_stack(q, ts.params, ts.state, cfg,
                               steps=INT8_FINISH_STEPS, batch=BATCH)
    torch.cuda.synchronize()
    finish_s = time.perf_counter() - t
    layers = [q[g_][n] for g_, n in quant._VID_LAYER_ORDER]
    check(all(quant._is_q(l) and l["wq"].dtype == torch.int8 and "as" in l
              for l in layers), "every layer int8 with a static scale")

    # 3a. int8_matmul's padding on the card: the CPU test's shapes (rows of
    #     a one-video request and odd ones, the stack's k and n), exact
    g8 = torch.Generator().manual_seed(seed + 32)
    bad = []
    for m, k, n in itertools.product((1, 16, 17, 1024), (100, 121, 576),
                                     (3, 12, 100, 8192)):
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g8)
        b = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g8)
        try:             # report every refused shape, then fail
            got = quant.int8_matmul(a.to(DEVICE), b.to(DEVICE)).cpu()
            if not torch.equal(got, quant.int8_matmul(a, b)):
                bad.append(f"{m}x{k}x{n} differs")
        except RuntimeError as e:
            bad.append(f"{m}x{k}x{n} {str(e)[:160]}")
    check(not bad, f"int8_matmul card == CPU: {bad}")
    say("serve_int8", check="int8_matmul card == CPU", shapes=48)

    # 3. the card against the CPU on one q tree and z: each int32
    #    accumulator from the same int8 input, at 4 videos (m = 64 rows in
    #    the MLP) and at one (m = 16: int8_matmul pads the rows)
    q_cpu = to_device(q, "cpu")
    zz = np.random.default_rng(seed + 31).uniform(
        -1, 1, (INT8_CHECK_VIDEOS, cfg.z_input_size)).astype(np.float32)
    for b in (INT8_CHECK_VIDEOS, 1):
        z_cpu = torch.from_numpy(zz[:b])
        v_cpu, rec_cpu = _capture_acc(
            lambda: vid.sample_videos_q(q_cpu, z_cpu, cfg))
        v_gpu, rec_gpu = _capture_acc(
            lambda: vid.sample_videos_q(q, z_cpu.to(DEVICE), cfg))
        check(len(rec_cpu) == len(rec_gpu) == len(quant._VID_LAYER_ORDER),
              "9 int8 contractions a forward")
        in_diff = []
        for (grp, name), (kind, xq, wq, acc), (_, xq_g, _, _) in zip(
                quant._VID_LAYER_ORDER, rec_cpu, rec_gpu):
            fn = quant._linear_acc if kind == "linear" else quant._deconv_acc
            acc_g = fn(xq.to(DEVICE), wq.to(DEVICE))
            check(acc_g.dtype == torch.int32 and torch.equal(acc_g.cpu(), acc),
                  f"{grp}/{name}: int32 accumulator card == CPU "
                  f"({tuple(xq.shape)})")
            in_diff.append(int((xq_g.cpu() != xq).sum()))
        d = (v_gpu.cpu() - v_cpu).abs().double()
        check(float(d.mean()) <= 1e-5 and float((d > 1e-3).double().mean())
              <= 1e-3, f"int8 stack card vs CPU: mean {float(d.mean())}, "
                       f"{int((d > 1e-3).sum())} past 1e-3")
        say("serve_int8", check=f"card vs CPU, {b} videos",
            accumulators_equal=len(rec_cpu),
            int8_inputs_differing=",".join(map(str, in_diff)),
            stack_max_abs_err=f"{float(d.max()):.3g}",
            stack_mean_abs_err=f"{float(d.mean()):.3g}")

    # 4. int8 against float32 (TF32 off) on the card, one request's z
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                image_gan=dataclasses.replace(
                                    cfg.image_gan, compute_dtype="float32"))
    z = torch.rand(BATCH, cfg.z_input_size, device=DEVICE, generator=g) \
        * 2 - 1
    with quant._true_float32():
        ref = vid.sample_videos(ts, z, cfg32)
    q_dyn = quant.quantize_vid_stack(ts.params, ts.state)
    quality = {}
    for name, qq in (("static", q), ("dynamic", q_dyn)):
        out = vid.sample_videos_q(qq, z, cfg)
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"int8 {name} sample finite, {tuple(out.shape)}")
        a, b = denorm_u8(out), denorm_u8(ref)
        mse_u8 = float(np.mean((a.astype(np.float64) - b) ** 2))
        x, y = out.double().cpu().numpy(), ref.double().cpu().numpy()
        quality[name] = dict(
            psnr_db=10 * math.log10(255.0 ** 2 / max(mse_u8, 1e-12)),
            mae_u8=float(np.mean(np.abs(a.astype(np.float64) - b))),
            mae=float(np.mean(np.abs(x - y))),
            corr=float(np.corrcoef(x.ravel(), y.ravel())[0, 1]))
        say("serve_int8", quality=name, vs="float32 sampler (TF32 off)",
            **{k: f"{v:.4f}" for k, v in quality[name].items()})
    check(quality["static"]["corr"] > 0.99,
          f"int8 tracks float: {quality['static']}")

    # 5. device time of one request's sample: int8 (static, dynamic),
    #    float as served (bf16) and float32; each contraction; peak bytes
    def float32(zz_):
        with quant._true_float32():
            return vid.sample_videos(ts, zz_, cfg32)

    times = {
        "int8_static": lambda zz_: vid.sample_videos_q(q, zz_, cfg),
        "int8_dynamic": lambda zz_: vid.sample_videos_q(q_dyn, zz_, cfg),
        "float_bf16": lambda zz_: vid.sample_videos(ts, zz_, cfg),
        "float32_tf32_off": float32}
    sample_ms = {k: event_ms(f, [(z,)], warmup=2, reps=10)
                 for k, f in times.items()}
    sample_ms["int8_static_again"] = event_ms(times["int8_static"], [(z,)],
                                              warmup=2, reps=10)
    say("serve_int8", videos=BATCH,
        **{f"sample_ms_{k}": f"{v:.3f}" for k, v in sample_ms.items()})
    if profile:
        for k in ("int8_static", "float_bf16"):
            profile_step(f"sample_{k}", lambda: times[k](z))
    rows = _contraction_times(q, z, cfg)
    for r in rows:
        say("serve_int8", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                             for k, v in r.items()})
    peaks = {}
    for b in (BATCH, INT8_BIG_BATCH):
        zb = torch.rand(b, cfg.z_input_size, device=DEVICE,
                        generator=g) * 2 - 1
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        vid.sample_videos_q(q, zb, cfg)
        torch.cuda.synchronize()
        peaks[b] = torch.cuda.max_memory_allocated() - base
    say("serve_int8", sum_acc_ms=f"{sum(r['acc_ms'] for r in rows):.3f}",
        sum_im2col_ms=f"{sum(r['im2col_ms'] for r in rows):.3f}",
        sum_int_mm_ms=f"{sum(r['int_mm_ms'] for r in rows):.3f}",
        sum_int_mm_bound_ms=f"{sum(r['int_mm_bound_ms'] for r in rows):.4f}",
        im2col_bytes=sum(r["im2col_bytes"] for r in rows),
        **{f"peak_extra_bytes_{b}_videos": v for b, v in peaks.items()},
        quantize_seconds=f"{quantize_s:.2f}",
        finish_seconds=f"{finish_s:.2f}")
    launches = collections.Counter(read_counts())

    # 6. the deployment workflow through the CLI: quantize-export of the
    #    workflow phase's train-vid run -> sample-wall --quantized
    art, wall = (os.path.join(workdir, n) for n in ("int8_art", "int8_wall"))
    secs, counts, peak = _drive(
        ["quantize-export", "--checkpoint", vid_ckpt, "--out-dir", art,
         "--calib-batches", str(INT8_CALIB), "--calib-mode", "mse",
         "--bias-correct", "--finish-steps", str(INT8_FINISH_STEPS)])
    launches.update(counts)
    art_q, _ = quant.load_artifact(art, device=DEVICE)
    check(all(quant._is_q(art_q[g_][n]) and "as" in art_q[g_][n]
              for g_, n in quant._VID_LAYER_ORDER), "artifact int8, static")
    du = lambda d: sum(os.path.getsize(os.path.join(r, f))
                       for r, _, fs in os.walk(d) for f in fs)
    float_step = os.path.join(vid_ckpt, f"step_{ckpt.latest_step(vid_ckpt):010d}")
    float_gen = sum(v.nbytes for k, v in ckpt.load_flat(vid_ckpt).items()
                    if k.startswith("params/") and "generator" in k)
    say("serve_int8", run="quantize_export", seconds=f"{secs:.2f}",
        peak_bytes=peak, artifact_bytes=du(art),
        float_checkpoint_bytes=du(float_step),
        float_generator_param_bytes=float_gen)
    ms, secs, counts, peak = _drive_wall(
        ["sample-wall", "--checkpoint", art, "--quantized", "--out-dir",
         wall, "--num-batches", str(WALL_REQUESTS), "--batch-size",
         str(BATCH), "--seed", str(seed)])
    launches.update(counts)
    gifs = [f for f in os.listdir(wall) if f.endswith(".gif")]
    check(len(gifs) == WALL_REQUESTS * BATCH, f"{len(gifs)} GIFs written")
    frames = read_gif(os.path.join(wall, gifs[0]))
    s = cfg.image_gan.output_size
    check(frames.shape == (cfg.vid_length, s, s, cfg.image_gan.c_dim),
          f"a quantized wall GIF is {frames.shape}")
    say("serve_int8", run="sample_wall_quantized", requests=WALL_REQUESTS,
        videos_per_request=BATCH, gifs=len(gifs), ms_per_request=f"{ms:.1f}",
        seconds_with_artifact_load=f"{secs:.2f}", peak_bytes=peak)

    # 7. sample-wall --int8 --int8-calib 2 on the float run
    wall8 = os.path.join(workdir, "int8_wall_calib")
    ms, secs, counts, peak = _drive_wall(
        ["sample-wall", "--checkpoint", vid_ckpt, "--int8", "--int8-calib",
         str(INT8_CALIB), "--out-dir", wall8, "--num-batches", "1",
         "--batch-size", str(BATCH), "--seed", str(seed)])
    n8 = len([f for f in os.listdir(wall8) if f.endswith(".gif")])
    check(n8 == BATCH, f"--int8 wall wrote {n8} GIFs")
    launches.update(counts)
    launches = {k["name"]: launches[k["name"]] for k in KERNELS}
    say("serve_int8", run="sample_wall_int8_calib", gifs=n8,
        ms_per_request=f"{ms:.1f}", seconds_with_quantize=f"{secs:.2f}",
        peak_bytes=peak, launches=launches)
    return launches


def _invert_check(params, state, cfg, targets, z0):
    """Card vs CPU on one image inversion problem at the flagship width,
    float32 with TF32 off, over INV_CHECK_STEPS Adam steps with a rate
    decay inside them.

    dL/dz jumps where a ReLU's or lrelu's input sits within rounding of
    zero: the side is the rounding's choice, and the card's own kernels do
    not always choose alike on one input. Adam then moves each z component
    by ~lr whatever its gradient's size, so two free runs part by up to
    ~lr an update on the components such a jump tips, and the largest gap
    is chance (0.6 lr and 3.3 lr in two runs of one tree). So the card is
    held where the comparison is exact up to rounding: the loss (continuous
    at a kink) at every point z_t of the CPU's run; dL/dz at z0; the card's
    `invert` fed the gradients the CPU's Adam took, which must land on the
    CPU's z; and the free runs' losses. The free runs' z gap, dL/dz along
    the CPU's run and the card against itself there are printed."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    icfg = InvertConfig(steps=INV_CHECK_STEPS, learning_rate=INV_CHECK_LR,
                        lr_decay_every=INV_CHECK_STEPS // 2,
                        lr_decay_factor=0.5, pixel_l1=1.0, activation_l1=0.3,
                        activation_l2=0.2, generator_loss=0.05,
                        batch_size=targets.shape[0])
    cpu, card = (inv_opt.image_problem(params, state, targets, cfg32, icfg,
                                       device=dev) for dev in ("cpu", DEVICE))
    # the CPU's free run, each point z_t and the gradient taken there kept
    zs, gs = [], []

    def recorded(z):
        zs.append(z.detach().clone())
        z.register_hook(lambda g: gs.append(g.detach().clone()))
        return cpu.loss_fn(z)

    z_cpu, h_cpu, _ = inv_opt.invert(cpu._replace(loss_fn=recorded), icfg,
                                     z0=torch.as_tensor(z0))
    z_free, h_gpu, _ = inv_opt.invert(card, icfg, z0=torch.as_tensor(
        z0, device=DEVICE))
    check(len(zs) == len(gs) == INV_CHECK_STEPS, "the CPU run's points")
    loss_err, grad_errs, self_err = [], [], 0.0
    for z, g_cpu, l_cpu in zip(zs, gs, h_cpu):
        g_cpu, grads = g_cpu.numpy(), []
        for _ in range(2):
            zt = z.to(DEVICE).requires_grad_(True)
            loss, _ = card.loss_fn(zt)
            grads.append(torch.autograd.grad(loss, zt)[0].cpu().numpy())
        loss_err.append(abs(float(loss.detach()) - l_cpu) / abs(l_cpu))
        scale = np.abs(g_cpu).max()
        grad_errs.append(np.abs(grads[0] - g_cpu) / scale)
        self_err = max(self_err, float(np.abs(grads[1] - grads[0]).max()
                                       / scale))
    # the card's optimizer on the CPU's gradients: the same Adam updates up
    # to float32 rounding of the elementwise ops, with no feedback to part
    # the two
    fed = iter([g.to(DEVICE) for g in gs])
    z_fed, _, _ = inv_opt.invert(
        inv_opt.InversionProblem(lambda z: ((z * next(fed)).sum(), None),
                                 card.z_shape, card.device),
        icfg, z0=torch.as_tensor(z0, device=DEVICE))
    torch.backends.cudnn.allow_tf32 = tf32[0]
    torch.backends.cuda.matmul.allow_tf32 = tf32[1]
    z_cpu, g0 = z_cpu.numpy(), np.abs(gs[0].numpy())
    lr = icfg.learning_rate
    opt_err = float(np.abs(z_fed.cpu().numpy() - z_cpu).max()) / lr
    free_diff = np.abs(z_free.cpu().numpy() - z_cpu)
    hist_err = float(np.abs(h_gpu - h_cpu).max() / np.abs(h_cpu).max())
    check(g0.min() > 1e-6 * g0.max(),
          f"dL/dz far above rounding: min {g0.min()}")
    check(max(loss_err) < 1e-4, f"inversion loss card vs CPU at the CPU's "
                                f"{INV_CHECK_STEPS} points: {loss_err}")
    check(grad_errs[0].max() < 1e-3,
          f"dL/dz card vs CPU: {grad_errs[0].max()} of max")
    check(opt_err < 1e-3, f"the card's Adam on the CPU's gradients: z "
                          f"{opt_err} x lr from the CPU's")
    check(hist_err < 1e-3, f"{INV_CHECK_STEPS} free Adam steps card vs CPU: "
                           f"losses {hist_err} of max")
    say("invert", check="card vs CPU, float32 TF32 off",
        batch=targets.shape[0], steps=INV_CHECK_STEPS,
        decay_at=icfg.lr_decay_every,
        loss_rel_err_max=f"{max(loss_err):.3g}", loss_tol="1e-4",
        grad_err_of_max=f"{grad_errs[0].max():.3g}", grad_tol="1e-3",
        grad_min_over_max=f"{g0.min() / g0.max():.3g}",
        fed_z_err_over_lr=f"{opt_err:.3g}", fed_z_tol="1e-3 x lr",
        losses_err_of_max=f"{hist_err:.3g}", losses_tol="1e-3",
        run_grad_err_of_max=f"{max(e.max() for e in grad_errs):.3g}",
        run_grad_median_of_max=(
            f"{max(float(np.median(e)) for e in grad_errs):.3g}"),
        card_vs_itself_grad_of_max=f"{self_err:.3g}",
        free_z_max_abs_err_over_lr=f"{float(free_diff.max()) / lr:.3g}",
        free_z_share_within_0p001=f"{float((free_diff <= 1e-3).mean()):.4f}",
        loss_first=f"{h_gpu[0]:.5f}", loss_last=f"{h_gpu[-1]:.5f}")


def _write_clips(params, state, cfg, clip_dir, seed):
    """INV_CLIPS GIF clips of 16 frames drawn by the image generator along
    straight z paths."""
    os.makedirs(clip_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(INV_CLIPS):
        z0 = rng.uniform(-0.8, 0.8, cfg.z_dim)
        step = rng.uniform(-0.02, 0.02, cfg.z_dim)
        zs = (z0 + np.arange(CLIP_LEN)[:, None] * step).astype(np.float32)
        frames = dcgan.sample(params, state,
                              torch.as_tensor(zs, device=DEVICE), cfg)
        write_gif(os.path.join(clip_dir, f"clip{i:02d}.gif"),
                  denorm_u8(frames))


def phase_invert(seed, workdir, img_ckpt, vid_ts, vid_cfg, smi,
                 profile=False):
    """Latent inversion (gifgan_tpu_torch/invert/) on the workflow phase's
    train-dcgan run at the flagship width: card vs CPU; make-paths ->
    z-extract -> derive-paths -> invert --input-paths -> visualize through
    the CLI; the nested variant on the flagship VidGAN; step times."""
    reset_counts()
    cfg, params, state = cli._load_dcgan_from_run(img_ckpt, DEVICE)
    rng = np.random.default_rng(seed + 40)
    z_true = rng.uniform(-1, 1, (BATCH, cfg.z_dim)).astype(np.float32)
    images = dcgan.sample(params, state, torch.as_tensor(
        z_true, device=DEVICE), cfg)
    side = cfg.output_size
    check(images.shape == (BATCH, side, side, cfg.c_dim)
          and bool(torch.isfinite(images).all()), "generator targets")

    # 1. card vs CPU (float32), on 8 of the targets
    z0 = rng.uniform(-1, 1, (INV_CHECK_BATCH, cfg.z_dim)).astype(np.float32)
    _invert_check(params, state, cfg, images[:INV_CHECK_BATCH], z0)

    # 2. the CLI: make-paths, z-extract -> derive-paths, invert
    tgt_dir, clip_dir = (os.path.join(workdir, n)
                         for n in ("inv_targets", "inv_clips"))
    os.makedirs(tgt_dir)
    for i, im in enumerate(denorm_u8(images)):
        write_png(os.path.join(tgt_dir, f"{i:02d}.png"), im)
    _write_clips(params, state, cfg, clip_dir, seed + 41)
    d = lambda n: os.path.join(workdir, n)
    check(cli.main(["make-paths", "--out-dir", d("inv_paths"), "--z-dim",
                    str(cfg.z_dim)]) == 0, "make-paths")
    secs, counts, peak = _drive(
        ["z-extract", "--checkpoint", img_ckpt, "--input-directory",
         clip_dir, "--output-z-folder", d("inv_zs"), "--batch-size",
         str(INV_CLIPS), "--num-initial-steps", "50",
         "--num-steps-per-frame", "10", "--write-comparisons"])
    launches = collections.Counter(counts)
    trajs = sorted(f for f in os.listdir(d("inv_zs")) if f.endswith(".npy")
                   and not f.endswith("_comparison.npy"))
    check(len(trajs) == INV_CLIPS and all(
        np.load(os.path.join(d("inv_zs"), f)).shape == (CLIP_LEN, cfg.z_dim)
        for f in trajs), f"z-extract wrote {trajs}")
    comps = [f for f in os.listdir(d("inv_zs")) if f.endswith(".gif")]
    check(len(comps) == INV_CLIPS, f"{len(comps)} comparison GIFs")
    check(read_gif(os.path.join(d("inv_zs"), comps[0])).shape
          == (CLIP_LEN, side, 2 * side, 3), "comparison GIF target | recon")
    say("invert", run="z_extract", clips=INV_CLIPS, frames=CLIP_LEN,
        steps=f"50+{CLIP_LEN}x10", seconds=f"{secs:.2f}",
        seconds_per_clip=f"{secs / INV_CLIPS:.3f}", peak_bytes=peak,
        card=repr(smi))
    check(cli.main(["derive-paths", "--traj-dir", d("inv_zs"), "--out-dir",
                    d("inv_dpaths")]) == 0, "derive-paths")
    derived = sorted(os.listdir(d("inv_dpaths")))
    check(len(derived) == 4, f"derive-paths wrote {derived}")

    runs = []
    real = inv_api.invert_images

    def invert_images(*a, **kw):
        out = real(*a, **kw)
        runs.append(out[1])
        return out

    inv_api.invert_images = invert_images
    try:
        secs, counts, peak = _drive(
            ["invert", "--checkpoint", img_ckpt, "--input-images",
             *sorted(os.path.join(tgt_dir, f) for f in os.listdir(tgt_dir)),
             "--input-paths", d("inv_paths/smile.txt"),
             d("inv_dpaths/" + derived[0]),
             os.path.join(d("inv_zs"), trajs[0]),
             "--sample-dir", d("inv_out"), "--batch-size", str(BATCH),
             "--num-steps", str(INV_STEPS), "--progress-vid-sections",
             "0,1", "50,10"])
    finally:
        inv_api.invert_images = real
    launches.update(counts)
    losses = runs[0]
    check(losses.shape == (INV_STEPS,) and np.isfinite(losses).all(),
          "invert losses finite")
    check(losses[-1] < 0.9 * losses[0],
          f"invert: last loss {losses[-1]} under 0.9 x first {losses[0]}")
    z = np.load(d("inv_out/z.npy"))
    check(z.shape == (BATCH, cfg.z_dim), f"z.npy is {z.shape}")
    for f in ("final.png", "path_00.gif", "path_01.gif", "path_02.gif"):
        check(os.path.exists(d("inv_out/" + f)), f"invert wrote {f}")
    say("invert", run="invert_cli", batch=BATCH, steps=INV_STEPS,
        loss_first=f"{losses[0]:.5f}", loss_last=f"{losses[-1]:.5f}",
        ratio=f"{losses[-1] / losses[0]:.4f}", seconds=f"{secs:.2f}",
        peak_bytes=peak, input_paths="make-paths, derive-paths, z-extract")
    secs, counts, _ = _drive(["visualize", "--checkpoint", img_ckpt,
                              "--out-dir", d("inv_vis"), "--option", "4",
                              "--num-dims", "8"])
    launches.update(counts)
    check(len(os.listdir(d("inv_vis"))) == 9, "visualize: 8 GIFs + merged")
    say("invert", run="visualize", option=4, dims=8, seconds=f"{secs:.2f}")

    # 3. the nested variant on the flagship VidGAN (random weights)
    ncfg = InvertConfig(steps=INV_NESTED_STEPS, batch_size=INV_CLIPS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    nz, nl, _ = inv_api.invert_nested_first_frame(
        vid_ts.params, vid_ts.state, images[:INV_CLIPS], vid_cfg, ncfg,
        seed=seed, device=DEVICE)
    torch.cuda.synchronize()
    check(nz.shape == (INV_CLIPS, vid_cfg.z_input_size)
          and np.isfinite(nl).all() and bool(torch.isfinite(nz).all()),
          f"nested inversion finite: {nl}")
    say("invert", run="nested_first_frame", videos=INV_CLIPS,
        frames=vid_cfg.vid_length, steps=INV_NESTED_STEPS,
        ms_per_step=f"{(time.perf_counter() - t) * 1e3 / INV_NESTED_STEPS:.2f}",
        loss_first=f"{nl[0]:.5f}", loss_last=f"{nl[-1]:.5f}")

    # 4. ms per inversion step: the invert command's problem (batch 64,
    #    the run's dtype), one 50-step chunk between CUDA events
    icfg = InvertConfig(activation_l1=0.0, pixel_l1=0.0, activation_l2=1.0,
                        batch_size=BATCH)
    prob = inv_opt.image_problem(params, state, images, cfg, icfg,
                                 device=DEVICE)
    zt = inv_opt.initial_z(prob.z_shape, seed, prob.device)
    st = gan.Adam(icfg.learning_rate).init({"z": zt})
    inv_opt._run_chunk(prob, zt, st, icfg, 0, 5)             # warm
    ms = event_ms(lambda: inv_opt._run_chunk(prob, zt, st, icfg, 0,
                                             INV_TIMED_STEPS),
                  [()], warmup=1, reps=1) / INV_TIMED_STEPS
    ms2 = event_ms(lambda: inv_opt._run_chunk(prob, zt, st, icfg, 0,
                                              INV_TIMED_STEPS),
                   [()], warmup=0, reps=1) / INV_TIMED_STEPS
    launches.update(read_counts())
    launches = {k["name"]: launches[k["name"]] for k in KERNELS}
    say("invert", timing="image problem", batch=BATCH, dtype=cfg.compute_dtype,
        steps_per_chunk=INV_TIMED_STEPS, ms_per_step=f"{ms:.3f},{ms2:.3f}",
        card=repr(smi), launches=launches)
    if profile:
        profile_step("invert_step", lambda: inv_opt._run_chunk(
            prob, zt, st, icfg, 0, 1))
    return launches


REC_VARIANTS = {
    "plain": {},
    "share_disc_conv": dict(share_disc_conv=True),
    "deep_dropout": dict(num_lstm_layers=3, lstm_dropout=0.2),
    "residual_pixel_warmup": dict(residual_prediction=True,
                                  pixel_loss_scalar=10.0,
                                  adversarial_after_steps=5),
}


def _warm_adam(flat, rng):
    """Adam slots of a flat state at count 3 (phase_check says why)."""
    for k, v in flat.items():
        if k.endswith("/count"):
            flat[k] = np.full_like(v, 3)
        elif "/mu/" in k:
            flat[k] = (1e-3 * rng.standard_normal(v.shape)).astype(v.dtype)
        elif "/nu/" in k:
            flat[k] = (1e-6 * (1 + rng.random(v.shape))).astype(v.dtype)
    return flat


def _rel(got, want):
    """max |got - want| / max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _card_vs_cpu(what, run, lr):
    """run(device) -> (outputs {name: array or float}, flat JAX-layout
    state after the step); the card's against the CPU's: outputs relative
    (forwards under 1e-4, step metrics under 1e-3), weights in units of lr
    (Adam moves a weight by ~lr whatever its gradient's size: at most 3),
    other state leaves (BN moments) relative under 1e-3."""
    (out_cpu, st_cpu), (out_gpu, st_gpu) = run("cpu"), run(DEVICE)
    fwd = max([_rel(out_gpu[k], v) for k, v in out_cpu.items()
               if not isinstance(v, float)] or [0.0])
    met = max([_rel(out_gpu[k], v) for k, v in out_cpu.items()
               if isinstance(v, float)] or [0.0])
    w = max(float(np.abs(st_gpu[k] - v).max()) for k, v in st_cpu.items()
            if k.startswith("params")) / lr
    other = max([_rel(st_gpu[k], v) for k, v in st_cpu.items()
                 if k.startswith("state/")] or [0.0])
    check(fwd < 1e-4, f"{what}: forwards card vs CPU rel err {fwd}")
    check(met < 1e-3, f"{what}: step metrics card vs CPU rel err {met}")
    check(w <= 3.0, f"{what}: weights card vs CPU {w} x lr")
    check(other < 1e-3, f"{what}: BN state card vs CPU rel err {other}")
    return fwd, met, w, other


def _recurrent_checks(seed):
    """The new families on the card against the CPU, float32, TF32 off,
    from one state converted onto each device: the recurrent G, D, rollout
    and one train step for each variant (dropout masks passed in), one
    conditional DCGAN step (instance noise passed in), PredNet's loss and
    gradient."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed + 50)
    tcfg = TrainConfig(batch_size=4)
    clips = rng.uniform(0, 1, (4, 5, 32, 32, 3)).astype(np.float32)
    errs = {}
    for variant, kw in REC_VARIANTS.items():
        cfg = RecurrentImageConfig(image_size=32, c_dim=3, seq_length=4,
                                   base_filters=8, lstm_units=16, **kw)
        flat = _warm_adam(interop.to_jax_flat(rtrain.init_train_state(
            torch.Generator().manual_seed(seed + 51), cfg, tcfg,
            device="cpu")), rng)
        masks = None
        if cfg.lstm_dropout:
            g = torch.Generator().manual_seed(seed + 52)
            masks = [rimage.dropout_masks(g, cfg, 4, 4) for _ in range(3)]

        def run(dev, cfg=cfg, flat=flat, masks=masks):
            ts = rtrain.RecurrentTrainState.from_tree(
                interop.from_jax_flat(flat, dev))
            x = torch.from_numpy(clips).to(dev)
            m = None if masks is None else [k.to(dev) for k in masks]
            with torch.no_grad():
                out = {
                    "generator": rimage.generator(
                        ts.params_g, x[:, :-1], cfg, d_params=ts.params_d,
                        dropout=None if m is None else m[0]),
                    "discriminator": rimage.discriminator(ts.params_d,
                                                          x[:, 1:], cfg),
                    "rollout": rimage.rollout(ts.params_g, x[:, 0], 6, cfg,
                                              d_params=ts.params_d)}
            out = {k: v.cpu().numpy() for k, v in out.items()}
            ts, metrics = rtrain.train_step(ts, x, None, cfg, tcfg,
                                            dropout_masks=m)
            out.update({k: float(v) for k, v in metrics.items()})
            return out, interop.to_jax_flat(ts)

        errs[variant] = _card_vs_cpu(f"recurrent {variant}", run,
                                     tcfg.learning_rate)

    ccfg = DCGANConfig(output_size=28, c_dim=1, z_dim=16, gf_dim=8,
                       df_dim=8, noise_std=0.1)
    ctcfg = TrainConfig(batch_size=16, d_learning_rate=5e-4)
    flat = _warm_adam(interop.to_jax_flat(gan.init_cond_train_state(
        torch.Generator().manual_seed(seed + 53), ccfg, 10, ctcfg,
        device="cpu")), rng)
    images, y = synthetic_digits(16, seed=seed)
    z = rng.uniform(-1, 1, (16, 16)).astype(np.float32)
    noise = (0.1 * rng.standard_normal(images.shape)).astype(np.float32)

    def run_cond(dev):
        t = lambda a: torch.from_numpy(a).to(dev)
        ts = gan.CondTrainState.from_tree(interop.from_jax_flat(flat, dev))
        ts, m = gan.cond_train_step(ts, t(images), t(y), t(z), None, ccfg,
                                    ctcfg, noise=[t(noise)])
        return ({k: float(v) for k, v in m.items()},
                interop.to_jax_flat(ts))

    errs["cond_dcgan"] = _card_vs_cpu("cond_train_step", run_cond,
                                      ctcfg.d_learning_rate)

    pcfg = prednet.PredNetConfig(image_size=16, c_dim=3, channels=(8, 16))
    pflat = interop.to_jax_flat(prednet.init(
        torch.Generator().manual_seed(seed + 54), pcfg, device="cpu"))
    pclips = synthetic_clips(4, length=6, size=16, seed=seed).astype(
        np.float32) / 255.0

    def run_prednet(dev):
        keys, leaves, p = _differentiable(interop.from_jax_flat(pflat, dev))
        with torch.enable_grad():
            loss = prednet.loss_fn(p, torch.from_numpy(pclips).to(dev), pcfg)
            grads = interop.to_jax_flat(_grads(loss, keys, leaves))
        return loss.item(), grads

    (l_cpu, g_cpu), (l_gpu, g_gpu) = run_prednet("cpu"), run_prednet(DEVICE)
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_err = max(_rel(g_gpu[k], v) for k, v in g_cpu.items())
    check(loss_err < 1e-4, f"PredNet loss card vs CPU rel err {loss_err}")
    # a value within rounding of a relu kink may take the other branch on
    # the card and move a leaf's gradient by ~1e-3 of its largest entry
    # (1.5e-3 seen on the CPU against the JAX package, tests/
    # test_torch_prednet.py); a wrong function is off by O(1)
    check(grad_err < 1e-2, f"PredNet gradient card vs CPU rel err {grad_err}")
    torch.backends.cudnn.allow_tf32 = tf32[0]
    torch.backends.cuda.matmul.allow_tf32 = tf32[1]
    say("recurrent", check="card vs CPU (float32, TF32 off)",
        **{f"{k}_fwd_met_w_bn": ",".join(f"{e:.3g}" for e in v)
           for k, v in errs.items()},
        prednet_loss_rel_err=f"{loss_err:.3g}",
        prednet_grad_rel_err=f"{grad_err:.3g}",
        tolerances="fwd 1e-4, metrics 1e-3, weights 3 lr, bn 1e-3, "
                   "prednet loss 1e-4 grad 1e-2")


def _timed_steps(step):
    """(ms per step by CUDA events over TIMED_STEPS warm calls of step(),
    peak device bytes over them)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = event_ms(step, [()], warmup=WARM_STEPS, reps=TIMED_STEPS)
    return ms, torch.cuda.max_memory_allocated()


def _fit_proto(name, params, loss_fn, data_fn, steps, lr, ratio, acc_fn,
               min_acc):
    t = time.perf_counter()
    params, first, last = protos.fit(params, loss_fn, data_fn, steps=steps,
                                     lr=lr)
    secs = time.perf_counter() - t
    acc = acc_fn(params) if acc_fn else None
    check(last < ratio * first, f"{name}: last loss {last} under {ratio} x "
                                f"first {first}")
    check(acc is None or acc > min_acc, f"{name}: accuracy {acc}")
    say("recurrent", prototype=name, steps=steps, loss_first=f"{first:.5f}",
        loss_last=f"{last:.5f}", accuracy=acc, seconds=f"{secs:.2f}")


def phase_recurrent(seed, workdir, smi, profile=False):
    """The other model families: card vs CPU; train-recurrent through the
    CLI at full width on both data paths with a resume, its checkpoint
    restored, ms/step and a 16-frame rollout; the conditional DCGAN at
    MNIST width; PredNet at its study's width; the prototypes' fit."""
    t0 = time.perf_counter()
    reset_counts()
    _recurrent_checks(seed)

    # train-recurrent, the JAX command's defaults (gf 64, batch 40, 17-frame
    # 64x64x3 clips, LSTM 100, float32)
    d = lambda n: os.path.join(workdir, n)
    flags = ["--dataset-size", str(REC_CLIPS), "--sample-every",
             str(REC_STEPS)]
    runs = {}
    for name, argv in (
            ("host", ["--run-dir", d("rec_host"), "--steps-limit",
                      str(REC_STEPS), "--checkpoint-every", "2"]),
            ("device_corpus", ["--run-dir", d("rec_dc"), "--steps-limit",
                               str(REC_STEPS), "--device-corpus"]),
            ("resume", ["--run-dir", d("rec_dc"), "--steps-limit",
                        str(REC_STEPS + REC_RESUME_STEPS),
                        "--device-corpus"])):
        secs, counts, peak = _drive(["train-recurrent"] + argv + flags)
        run_dir = argv[1]
        steps = int(argv[3])
        ms, last = _check_run(f"train-recurrent {name}", run_dir, steps,
                              [("pred_", ".gif")])
        check(math.isfinite(last["pixel_mae"]), f"{name} pixel_mae")
        runs[name] = run_dir
        say("recurrent", run=f"train_recurrent_{name}", steps=steps,
            seconds=f"{secs:.2f}",
            ms_per_step_host_clock=",".join(f"{x:.1f}" for x in ms),
            d_loss=f"{last['d_loss']:.5f}", g_loss=f"{last['g_loss']:.5f}",
            pixel_mae=f"{last['pixel_mae']:.5f}", peak_bytes=peak,
            launches=counts)
    check(ckpt.all_steps(d("rec_host/checkpoints")) == [2, REC_STEPS],
          "host run checkpoints every 2 steps and at the end")
    steps = [r["step"] for r in _records(runs["resume"])]
    check(steps == list(range(1, REC_STEPS + REC_RESUME_STEPS + 1)),
          f"resumed run logged steps {steps}")
    check(ckpt.all_steps(d("rec_dc/checkpoints"))
          == [REC_STEPS, REC_STEPS + REC_RESUME_STEPS], "resumed checkpoints")
    run_cfg = load_config(d("rec_dc/params.json"))
    cfg, tcfg = run_cfg["model"], run_cfg["train"]
    width = {k: getattr(tcfg if k == "batch_size" else cfg, k)
             for k in REC_WIDTH}
    check(width == REC_WIDTH and cfg.compute_dtype == "float32",
          f"train-recurrent ran at {width}, {cfg.compute_dtype}")
    fresh = rtrain.init_train_state(torch.Generator().manual_seed(seed + 60),
                                    cfg, tcfg, device=DEVICE)
    ts = ckpt.restore(d("rec_dc/checkpoints"), fresh)
    check(isinstance(ts, rtrain.RecurrentTrainState)
          and int(ts.step) == REC_STEPS + REC_RESUME_STEPS,
          "the checkpoint restores into a fresh RecurrentTrainState")
    w0, w = fresh.params_g["lstm0"]["w"], ts.params_g["lstm0"]["w"]
    check(bool(torch.isfinite(w).all()) and not torch.equal(w, w0),
          "restored weights are the trained ones")

    corpus = DeviceCorpus(synthetic_clips(REC_CLIPS, length=cfg.seq_length
                                          + 1, size=cfg.image_size),
                          method="take", out_range="unit", device=DEVICE)
    clips = corpus.sample(np.arange(tcfg.batch_size))
    ms, peak = _timed_steps(lambda: rtrain.train_step(ts, clips, None, cfg,
                                                      tcfg))
    t = time.perf_counter()
    video = rtrain.sample_rollout(ts, clips[:, 0], REC_ROLLOUT, cfg)
    torch.cuda.synchronize()
    roll_ms = (time.perf_counter() - t) * 1e3
    check(video.shape == (tcfg.batch_size, REC_ROLLOUT, cfg.image_size,
                          cfg.image_size, cfg.c_dim)
          and bool(torch.isfinite(video).all()) and float(video.min()) >= 0
          and float(video.max()) <= 1, "rollout of 16 frames in [0, 1]")
    say("recurrent", timing="train_step", width=width, dtype="float32",
        ms_per_step=f"{ms:.3f}", peak_bytes=peak,
        rollout_frames=REC_ROLLOUT, rollout_ms=f"{roll_ms:.1f}",
        card=repr(smi))
    if profile:
        profile_step("recurrent_step", lambda: rtrain.train_step(
            ts, clips, None, cfg, tcfg))

    # the conditional DCGAN at MNIST width on synthetic digits
    ccfg = DCGANConfig(output_size=28, c_dim=1, gf_dim=64, df_dim=64)
    ctcfg = TrainConfig(batch_size=COND_BATCH)
    cts = gan.init_cond_train_state(torch.Generator().manual_seed(seed + 70),
                                    ccfg, 10, ctcfg, device=DEVICE)
    x, y = (torch.from_numpy(a).to(DEVICE).reshape(4, COND_BATCH,
                                                   *a.shape[1:])
            for a in synthetic_digits(4 * COND_BATCH, seed=seed))
    g = torch.Generator(device=DEVICE).manual_seed(seed + 71)
    losses = []
    for i in range(COND_STEPS):
        z = torch.rand(COND_BATCH, ccfg.z_dim, device=DEVICE,
                       generator=g) * 2 - 1
        cts, m = gan.cond_train_step(cts, x[i % 4], y[i % 4], z, g, ccfg,
                                     ctcfg)
        losses.append((float(m["d_loss"]), float(m["g_loss"])))
    check(np.isfinite(losses).all(), "conditional DCGAN losses finite")
    labels = torch.eye(10, device=DEVICE)[torch.arange(COND_BATCH) % 10]
    samples = gan.cond_sample_step(cts, z, labels, ccfg)
    check(samples.shape == (COND_BATCH, 28, 28, 1)
          and float(samples.min()) >= 0
          and float(samples.max()) <= 1, "conditional samples in [0, 1]")
    ms, peak = _timed_steps(lambda: gan.cond_train_step(
        cts, x[0], y[0], z, g, ccfg, ctcfg))
    say("recurrent", timing="cond_train_step", model="28x28x1 y 10, gf=df=64"
        f", gfc=dfc=1024, batch {COND_BATCH}, float32", steps=COND_STEPS,
        d_loss=f"{losses[0][0]:.4f}->{losses[-1][0]:.4f}",
        g_loss=f"{losses[0][1]:.4f}->{losses[-1][1]:.4f}",
        ms_per_step=f"{ms:.3f}", peak_bytes=peak, card=repr(smi))

    # PredNet at the study's width (examples/train_prednet_study.py)
    pcfg = prednet.PredNetConfig(image_size=64, c_dim=3, channels=(32, 64))
    params = prednet.init(torch.Generator().manual_seed(seed + 80), pcfg,
                          device=DEVICE)
    pclips = torch.from_numpy(synthetic_clips(
        PREDNET_CLIPS, length=PREDNET_LEN, size=64, seed=seed + 1).astype(
        np.float32) / 255.0).to(DEVICE)
    opt = gan.Adam(1e-3)
    state = opt.init(params)

    def pn_step(params, state, batch):
        keys, leaves, p = _differentiable(params)
        with torch.enable_grad():
            loss = prednet.loss_fn(p, batch, pcfg)
            grads = _grads(loss, keys, leaves)
        updates, state = opt.update(grads, state)
        return gan.apply_updates(params, updates), state, loss.detach()

    with torch.no_grad():
        loss0 = float(prednet.loss_fn(params, pclips[:PREDNET_BATCH], pcfg))
    prng = np.random.default_rng(seed + 81)
    for _ in range(PREDNET_STEPS):
        idx = torch.as_tensor(prng.integers(0, PREDNET_CLIPS, PREDNET_BATCH))
        params, state, _ = pn_step(params, state, pclips[idx.to(DEVICE)])
    with torch.no_grad():
        loss1 = float(prednet.loss_fn(params, pclips[:PREDNET_BATCH], pcfg))
    check(math.isfinite(loss1) and loss1 < loss0,
          f"PredNet loss falls: {loss0} -> {loss1}")
    ms, peak = _timed_steps(lambda: pn_step(params, state,
                                            pclips[:PREDNET_BATCH]))
    say("recurrent", timing="prednet_step", model="64x64x3, channels "
        f"(32, 64), batch {PREDNET_BATCH}, T {PREDNET_LEN}, Adam 1e-3",
        steps=PREDNET_STEPS,
        loss=f"{loss0:.5f}->{loss1:.5f}", ratio=f"{loss1 / loss0:.4f}",
        ms_per_step=f"{ms:.3f}", peak_bytes=peak, card=repr(smi))

    # the prototypes, at tests/test_prototypes.py's sizes and thresholds
    gen = lambda s: torch.Generator().manual_seed(seed + s)
    dgen = lambda s: torch.Generator(device=DEVICE).manual_seed(seed + s)

    def echo_acc(p):
        x, y = protos.echo_data(dgen(99), 64, 12, 2)
        pred = protos.echo_rnn_apply(p, x).argmax(-1)
        return float((pred[:, 2:] == y[:, 2:]).float().mean())

    def cls_acc(p):
        x, labels = protos.conv_cls_data(dgen(7), 32, 6)
        return float((protos.conv_cls_apply(p, x).argmax(-1) == labels)
                     .float().mean())

    _fit_proto("echo", protos.echo_rnn_init(gen(90), device=DEVICE),
               protos.echo_loss,
               lambda g: protos.echo_data(g, 32, 12, 2), 150, 1e-2, 0.5,
               echo_acc, 0.9)
    _fit_proto("vector_echo", protos.vector_echo_init(gen(91), 6,
                                                      device=DEVICE),
               protos.vector_echo_loss,
               lambda g: protos.vector_echo_data(g, 32, 10, 6, 1), 200,
               1e-2, 0.5, None, None)
    _fit_proto("conv_cls", protos.conv_cls_init(gen(92), device=DEVICE),
               protos.conv_cls_loss,
               lambda g: protos.conv_cls_data(g, 16, 6), 120, 3e-3, 0.7,
               cls_acc, 0.6)
    launches = read_counts()
    say("recurrent", launches=launches,
        seconds=f"{time.perf_counter() - t0:.1f}")
    return launches


def _self_device_us(e):           # named self_cuda_time_total before 2.4
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def _launches_without_device_row(log_dir):
    """Kernel launches (the host's cudaLaunchKernel rows) of the newest
    capture under `log_dir` whose kernel has no device row: what the
    capture lost."""
    events = tprofile.newest_events(log_dir)
    seen = {e.get("args", {}).get("correlation") for e in events
            if e.get("cat") in tprofile.DEVICE_CATS}
    return sum(1 for e in events if e.get("cat") == "cuda_runtime"
               and "LaunchKernel" in e.get("name", "")
               and e.get("args", {}).get("correlation") not in seen)


def profile_step(name, step, top=15):
    """One call of `step` (one warm training step, batch or request) under
    core/profile.py's trace, read back by its summarize_trace: the wall
    time, the device busy time (`total_us`) beside the same capture's
    key_averages() device total, the idle share, the device time and
    launches by category, and the `top` rows. Returns (summary with every
    row, wall ms, key_averages us, launches by category)."""
    with tempfile.TemporaryDirectory() as log_dir:
        with tprofile.trace(log_dir) as p:
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        s = tprofile.summarize_trace(log_dir, top=10 ** 9)
        lost = _launches_without_device_row(log_dir)
    # a span's record_function range comes back as a device row too (a
    # user annotation over its kernels' time): torch's own table leaves
    # those out of its device total, and so does this
    rows = [e for e in p.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and _self_device_us(e) > 0]
    kav_us = sum(_self_device_us(e) for e in rows)
    calls = collections.Counter()
    for e in rows:
        calls[tprofile.category(e.key)] += e.count
    busy = s["total_us"] / 1e3
    say("profile", step=name, step_wall_ms=f"{wall:.2f}",
        device_busy_ms=f"{busy:.3f}",
        key_averages_device_ms=f"{kav_us / 1e3:.3f}",
        idle_share=f"{max(0.0, 1 - busy / wall):.3f}",
        kernel_launches=sum(calls.values()),
        launches_without_device_row=lost)
    say("profile", step=name,
        **{f"{c}_ms": f"{us / 1e3:.3f}" for c, us in s["by_category"].items()},
        **{f"{c}_launches": n for c, n in calls.items()})
    for n, us, pct in s["ops"][:top]:
        say("profile", step=name, kernel=repr(n[:150]),
            device_ms=f"{us / 1e3:.3f}", pct=f"{pct:.1f}")
    return s, wall, kav_us, calls


def profile_launches(name, wrapper, step):
    """profile_step of one call that launches a hand-written kernel: its
    rows are in the summary, with time, as many as the wrapper counted.
    Returns profile_step's summary, wall ms and key_averages us."""
    before = wrapper.launches
    s, wall, kav_us, calls = profile_step(name, step)
    n, rows = wrapper.launches - before, calls[wrapper.__name__]
    us = dict((k, v) for k, v, _ in s["ops"]).get(wrapper.__name__, 0)
    check(n > 0 and rows == n and us > 0,
          f"{name}: {wrapper.__name__}'s trace rows ({rows}, {us} us) "
          f"equal its {n} launches")
    say("profile", step=name, kernel=wrapper.__name__, launches=n,
        trace_rows=rows, device_us=f"{us:.3f}")
    return s, wall, kav_us


def profile_child(what, *args):
    """profile_launches of one warm flagship train step ("train": the
    seed), of one feed batch ("feed": the seed, the crop GIFs) or of one
    detect_clips dispatch of the track phase's detector ("track": the
    cascade, a source GIF), in a process of its own: on the card's machine
    a capture in a process that has run much else has lost kernel rows
    (PERF.md sections 6 and 7), and these captures count the rows. Returns
    the child's standard output, which it also prints."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--capture", what, *map(str, args)], cwd=REPO,
                         capture_output=True, text=True,
                         timeout=CHILD_TIMEOUT_S)
    print(out.stdout, end="", flush=True)
    check(out.returncode == 0, f"the {what} capture exits 0: "
                               f"{out.stderr[-2000:]}")
    return out.stdout


def _capture(what, *args):
    """profile_child's process: one warm call (the kernel's load, the
    detector's plan), then its capture."""
    if what == "train":
        (seed,) = map(int, args)
        cfg, tcfg = flagship()
        ts = vid.init_train_state(torch.Generator().manual_seed(seed), cfg,
                                  tcfg, device=DEVICE)
        corpus = DeviceCorpus(np.random.default_rng(seed).integers(
            0, 256, (PROFILE_CLIPS, CLIP_LEN, CLIP_SIZE, CLIP_SIZE, 3),
            np.uint8), device=DEVICE)
        launches = _profile_train(ts, cfg, tcfg, corpus, seed)
        print(PROFILE_LAUNCHES + json.dumps(launches), flush=True)
        return 0
    if what == "feed":
        seed, *crops = args
        paths = (crops * FEED_PATHS)[:FEED_PATHS]
        name, wrapper = "feed_batch", resize_normalize
        run = lambda: list(clip_batches_from_files(
            paths, BATCH, CLIP_LEN, CLIP_SIZE, epochs=1, seed=int(seed)))
    else:
        xml, gif = args
        det = tpipe._default_detector(TrackConfig(), xml, "device", DEVICE)
        gray = tpipe._to_gray64(read_gif(gif))
        name, wrapper = "track_detect_clips", haar_stages
        run = lambda: det.detect_clips([gray])
    run()
    torch.cuda.synchronize()
    profile_launches(name, wrapper, run)
    return 0


def phase_train(ts, cfg, tcfg, corpus, seed):
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
    check(launches["lrelu"] == K_STEPS * LRELU_PER_STEP,
          f"lrelu launched {LRELU_PER_STEP} times a step: {launches}")
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
    return launches


def phase_profile(seed):
    """The train step's capture (_profile_train) in a process of its own
    (profile_child): a capture in this process, even its first, has lost
    kernel rows on the card after the kernel phases (PERF.md section 6).
    Returns the child's launch counts of the profiled step."""
    out = profile_child("train", seed)
    line = [x for x in out.splitlines() if x.startswith(PROFILE_LAUNCHES)]
    check(len(line) == 1, "the train capture reports its launches")
    return json.loads(line[0][len(PROFILE_LAUNCHES):])


def _profile_train(ts, cfg, tcfg, corpus, seed):
    """One warm train_chunk_ids step (K1 gathers its frames) through
    core/profile.py: trace -> summarize_trace. K1's rows are in the
    summary, `total_us` agrees with the capture's key_averages() device
    total within PROFILE_AGREE and lies under the step's wall time."""
    g = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    ids = torch.randint(0, corpus.n, (1, BATCH), device=DEVICE, generator=g)
    z = torch.rand(1, BATCH, cfg.z_input_size, device=DEVICE,
                   generator=g) * 2 - 1
    step = lambda: vid.train_chunk_ids(ts, ids, z, g, corpus.data, cfg,
                                       tcfg, corpus.fold_sample_fn)
    step()                                        # warm
    torch.cuda.synchronize()
    reset_counts()
    s, wall, kav_us = profile_launches("train", gather_rows_scaled, step)
    launches = read_counts()
    total = s["total_us"]
    check(launches["gather_rows_scaled"] == 1,
          f"K1 launched once in the profiled step: {launches}")
    check(abs(total - kav_us) <= PROFILE_AGREE * kav_us,
          f"total_us {total:.1f} within {PROFILE_AGREE:.0%} of "
          f"key_averages' {kav_us:.1f}")
    check(0 < total < wall * 1e3, f"total_us {total:.1f} under the step's "
                                  f"wall {wall * 1e3:.1f} us")
    say("profile", step="train_step", total_us=f"{total:.1f}",
        key_averages_us=f"{kav_us:.1f}",
        agree=f"{abs(total - kav_us) / max(kav_us, 1e-9):.5f}",
        wall_us=f"{wall * 1e3:.1f}",
        idle_share=f"{1 - total / (wall * 1e3):.4f}",
        by_category=json.dumps({c: round(us, 3) for c, us
                                in s["by_category"].items()}),
        launches=launches)
    return launches


def phase_bench(smi):
    """`python -m gifgan_tpu_torch bench` in a process of its own, as a
    user runs it: its last line is the JAX bench's JSON line."""
    torch.cuda.empty_cache()      # give this process's cached blocks back
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "gifgan_tpu_torch", "bench"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT_S)
    for line in out.stdout.splitlines():
        if line:
            say("cli", command="bench", out=line)
    check(out.returncode == 0, f"bench exits 0: {out.returncode} "
                               f"{out.stderr[-2000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    check(res["metric"] == "vid_dcgan_train_steps_per_sec_b64_64x64x16"
          and res["unit"] == "steps/sec",
          f"bench's metric and unit are the JAX bench's: {res}")
    check(math.isfinite(res["value"]) and res["value"] > 0,
          f"bench's value finite and above 0: {res}")
    say("bench", steps_per_sec=res["value"],
        compile_cache=res["compile_cache"], nvidia_smi=repr(smi),
        seconds=f"{time.perf_counter() - t:.1f}")


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
    merged = TrackStats()
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
        merged.update(stats)
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
    merged.total_files = SRC_FILES
    merged.write(os.path.join(workdir, "prep_stats"))
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


def phase_feed(ts, cfg, tcfg, crop_paths, seed, profile=False):
    """Crop GIFs -> clip_batches_from_files (K2) -> train_chunk. `profile`
    adds a core/profile.py table of one feed batch."""
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
    if profile:
        profile_child("feed", seed, *crop_paths)
    return launches



def cli_out(argv, echo=True):
    """cli.main(argv) in process; its standard output (echoed unless
    echo=False)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(cli.main(argv) == 0, f"{argv[0]} exits 0")
    out = buf.getvalue()
    for line in out.splitlines() if echo else ():
        if line:
            say("cli", command=argv[0], out=line)
    return out


def mp4_frames(path):
    """Frames cv2 reads back from a written mp4 (0 if it cannot open it)."""
    import cv2

    cap = cv2.VideoCapture(path)
    n = 0
    while cap.isOpened():
        ok, _ = cap.read()
        if not ok:
            break
        n += 1
    cap.release()
    return n


def mp4_probe(path):
    """cv2's mp4v writer and reader in the running build: (opened for write,
    frames read back of 3 written)."""
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                             (64, 48))
    opened = writer.isOpened()
    for i in range(3):
        writer.write(np.full((48, 64, 3), 40 * i, np.uint8))
    writer.release()
    return opened, mp4_frames(path)


def write_mjpg(path, frames, fps=25.0):
    """(T, H, W, 3) uint8 RGB -> an MJPG avi through OpenCV's own encoder,
    which needs no codec library."""
    import cv2

    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps,
                             (w, h))
    check(writer.isOpened(), "cv2 writes MJPG avi")
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


def fixture_fetch(per_page):
    """An in-process search API and CDN for the scraper (no network): each
    keyword's first result page lists `per_page` mp4 URLs, later pages none;
    a media URL serves deterministic bytes."""
    from urllib.parse import parse_qs, urlparse

    def fetch(url):
        u = urlparse(url)
        if u.netloc == "api.giphy.com":
            q = parse_qs(u.query)
            offset = int(q["offset"][0])
            if offset >= per_page:
                return b"{}"
            items = ",".join(
                f'{{"mp4":"https://media.giphy.com/media/'
                f'{q["q"][0].replace(" ", "_")}{offset + i:05d}/giphy.mp4"}}'
                for i in range(per_page))
            return ('{"data":[' + items + ']}').encode()
        return b"clip:" + url.encode()

    return fetch


def phase_dataprep(xml, seed, workdir, detect_sets, track_out,
                   profile=False):
    """The data-collection tools on the card: scrape (dry run and a fake
    fetch), sample-frames (K2), video_to_frames with the device detector
    (K3), the mp4 probe with bulk-resize and video-to-gif, combine-stats,
    process_video with the gather flow against the device flow (K4), and
    the batched gather detector against the host detector. `profile`
    adds a torch.profiler table of 16 frames through the gather flow."""
    out = {}
    # scrape: the work plan, then the scraper over a fake fetch
    keyword_file = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "keywords.txt")
    plan = json.loads(cli_out(["scrape", "--keywords", keyword_file,
                               "--out-dir", os.path.join(workdir, "raw"),
                               "--dry-run"]))
    keywords = plan["keywords"][:SCRAPE_KEYWORDS]
    check(plan["dry_run"] and len(keywords) == SCRAPE_KEYWORDS
          and plan["planned_requests_per_keyword"] == 16,
          f"scrape --dry-run plan: {plan}")
    raw = os.path.join(workdir, "raw")
    stats = tscrape.Scraper(raw, fixture_fetch(SCRAPE_PER_PAGE),
                            num_threads=2).scrape(keywords)
    files = sum(len(f) for _, _, f in os.walk(raw))
    again = tscrape.Scraper(raw, fixture_fetch(SCRAPE_PER_PAGE),
                            num_threads=2).scrape(keywords)
    check(stats.new_total == files == SCRAPE_KEYWORDS * SCRAPE_PER_PAGE
          and stats.errors == 0 and again.new_total == 0,
          f"scraper: {stats}, {files} files, then {again}")
    say("dataprep", step="scrape", keywords=len(keywords),
        planned_requests_per_keyword=plan["planned_requests_per_keyword"],
        new=stats.new_total, files=files, second_pass_new=again.new_total)

    # sample-frames over the track phase's 256x256 crop GIFs (K2 on each)
    frames_dir = os.path.join(workdir, "stills")
    clips = sorted(f for f in os.listdir(track_out) if f.endswith(".gif"))
    reset_counts()
    t = time.perf_counter()
    cli_out(["sample-frames", "--input-directory", track_out,
             "--output-directory", frames_dir, "--frames-per-video",
             str(SAMPLE_FRAMES), "--size", str(CLIP_SIZE), "--seed",
             str(seed)])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / len(clips)
    out["sample_frames"] = read_counts()
    pngs = sorted(os.listdir(frames_dir))
    check(len(pngs) == SAMPLE_FRAMES * len(clips),
          f"{len(pngs)} stills from {len(clips)} clips")
    still = cli._stills_u8(argparse.Namespace(dataset=frames_dir,
                                              dataset_size=0),
                           DCGANConfig(output_size=CLIP_SIZE))
    check(still.shape == (len(pngs), CLIP_SIZE, CLIP_SIZE, 3)
          and still.std() > 5, f"stills read back: {still.shape}")
    check(out["sample_frames"]["resize_normalize"] == len(clips),
          f"sample-frames resized each clip by K2: {out['sample_frames']}")
    say("dataprep", step="sample_frames", clips=len(clips), resize="256->64",
        stills=len(pngs), ms_per_clip=f"{ms:.1f}",
        launches=out["sample_frames"])

    # a glyph video (MJPG avi: OpenCV's own codec) through video_to_frames
    # with the device detector, and through video-to-gif
    src, boxes = source_clip(seed + 60)
    vids = os.path.join(workdir, "videos")
    os.makedirs(vids)
    write_mjpg(os.path.join(vids, "glyph.avi"), src)
    det = DeviceHaarDetector(xml, min_neighbors=3, device=DEVICE)
    reset_counts()
    t = time.perf_counter()
    v2f = tvideo.video_to_frames(os.path.join(vids, "glyph.avi"),
                                 os.path.join(workdir, "faces"), rate=5,
                                 detector=det, crop_size=BOX)
    ms = (time.perf_counter() - t) * 1e3
    out["video_to_frames"] = read_counts()
    faces = sorted(os.listdir(os.path.join(workdir, "faces")))
    check(v2f["frames"] == SRC_FRAMES // 5 + 1 and len(faces) == v2f["kept"]
          and v2f["kept"] * 5 >= v2f["frames"] * 4,
          f"video_to_frames kept the glyph frames: {v2f}")
    check(out["video_to_frames"]["haar_stages"] >= v2f["frames"],
          f"video_to_frames detected on the card: {out['video_to_frames']}")
    say("dataprep", step="video_to_frames", **v2f, ms=f"{ms:.1f}",
        launches=out["video_to_frames"])

    # the mp4 codec: bulk-resize and video-to-gif on mp4s where cv2 has it
    mp4_write, mp4_read = mp4_probe(os.path.join(workdir, "probe.mp4"))
    mp4 = mp4_write and mp4_read == 3
    sources = [vids]
    if mp4:
        mp4s = os.path.join(workdir, "mp4s")
        os.makedirs(mp4s)
        tvideo.encode_mp4(os.path.join(mp4s, "glyph.mp4"), src)
        tvideo.encode_mp4(os.path.join(mp4s, "short.mp4"), src[:8])
        sources.append(mp4s)
        got = json.loads(cli_out(["bulk-resize", "--input-directory", mp4s,
                                  "--output-directory",
                                  os.path.join(workdir, "resized"),
                                  "--width", str(CLIP_SIZE), "--length",
                                  str(CLIP_LEN)]))
        check(got == {"written": 1, "skipped_short": 1, "errors": 0},
              f"bulk-resize: {got}")
        resized = tvideo.decode_clip(
            os.path.join(workdir, "resized", "glyph.mp4"), CLIP_LEN, None)
        check(resized.shape == (CLIP_LEN, CLIP_SIZE, CLIP_SIZE, 3),
              f"bulk-resize output {resized.shape}")
    for d in sources:
        gifs = os.path.join(d, "gifs")
        cli_out(["video-to-gif", "--input-directory", d,
                 "--output-directory", gifs])
        gif = read_gif(os.path.join(gifs, "glyph.gif"))
        check(gif.shape == src.shape
              and np.abs(gif.astype(int) - src.astype(int)).mean() < 8,
              f"video-to-gif of {os.listdir(d)}: {gif.shape}")
    say("dataprep", step="codecs", mp4_write=mp4_write, mp4_read=mp4_read,
        bulk_resize="ran" if mp4
        else "not run: no mp4 codec in this cv2 (the CPU tests gate it)",
        video_to_gif="avi and mp4" if mp4 else "avi")

    # combine-stats over the track and prep stats
    text = cli_out(["combine-stats", os.path.join(track_out, "stats.json"),
                    os.path.join(workdir, "prep_stats", "stats.json"),
                    "--out-dir", os.path.join(workdir, "combined")],
                   echo=False)
    with open(os.path.join(workdir, "combined", "stats.json")) as f:
        combined = json.load(f)
    parts = [TrackStats.from_dict(json.load(open(os.path.join(d,
                                                              "stats.json"))))
             for d in (track_out, os.path.join(workdir, "prep_stats"))]
    check(combined["total_files"] == TRACK_FILES + SRC_FILES
          and combined["counters"]["cnt_final_tracks"]
          == sum(p.cnt_final_tracks for p in parts) and text,
          f"combine-stats: {combined['counters']}")
    say("dataprep", step="combine_stats", files=combined["total_files"],
        final_tracks=combined["counters"]["cnt_final_tracks"])

    # process_video with the gather flow ("jax") against the device flow
    # (K4) on the prep phase's sources, one injected detector
    crops, times = {}, {}
    for backend in ("auto", "jax"):
        cfg = TrackConfig(flow_backend=backend)
        crops[backend], times[backend] = [], []
        reset_counts()
        for i in range(SRC_FILES):
            frames, boxes = source_clip(seed + 10 + i)

            def detector(frame, n, boxes=boxes):
                if n % 5:
                    return []
                x, y, side = boxes[n]
                return [Detection(x, y, x + side, y + side, n)]

            seen = []
            real = tpipe.crop_and_resize_tracks
            tpipe.crop_and_resize_tracks = lambda f, tr, *a, **kw: (
                seen.append(tr) or real(f, tr, *a, **kw))
            t = time.perf_counter()
            try:
                clips = process_video(frames, detector, cfg, TrackStats())
            finally:
                tpipe.crop_and_resize_tracks = real
            torch.cuda.synchronize()
            times[backend].append((time.perf_counter() - t) * 1e3)
            check(len(clips) == 1 and len(seen[0]) == 1,
                  f"{backend}: one track for source {i}")
            crops[backend].append(np.array(
                [[d.x1, d.y1, d.x2, d.y2] for d in seen[0][0]]))
        out[f"process_video_{backend}"] = read_counts()
    dev = max(int(np.abs(a - b).max()) if a.shape == b.shape else 10 ** 6
              for a, b in zip(crops["auto"], crops["jax"]))
    check(dev <= CENTRE_TOL_PX, f"gather flow's boxes within "
          f"{CENTRE_TOL_PX} px of the device flow's: {dev}")
    check(out["process_video_jax"]["lk_refine"] == 0
          and out["process_video_auto"]["lk_refine"] > 0,
          f"the gather flow has no K4, the device flow has: {out}")
    say("dataprep", step="flow_backend_jax", files=SRC_FILES,
        ms_per_file_jax=",".join(f"{t:.1f}" for t in times["jax"]),
        ms_per_file_auto_k4=",".join(f"{t:.1f}" for t in times["auto"]),
        box_max_abs_diff_px=dev, tolerance_px=CENTRE_TOL_PX)
    if profile:       # a third of a file: the profiler's own cost grows
        short = TrackConfig(flow_backend="jax", min_frame_count=10,
                            min_total_detections=3)   # with the launches
        profile_step("process_video_jax", lambda: process_video(
            frames[:16], detector, short, TrackStats()))

    # the batched gather detector on the detect phase's clips
    gather = BatchedGatherHaarDetector(xml, min_neighbors=3, device=DEVICE)
    for px, clips, truth, want in detect_sets:
        gather.detect_batch(np.stack(clips[0]))            # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = [gather.detect_batch(np.stack(c)) for c in clips]
        ms = (time.perf_counter() - t) * 1e3 / len(clips)
        glyphs, agree, found, noise, quiet = detect_agreement(got, want,
                                                              truth)
        say("dataprep", step="gather_detector", px=px, clips=len(clips),
            glyph_frames=glyphs, agree_with_host=agree, planted_found=found,
            noise_frames=noise, noise_frames_quiet=quiet,
            device_ms_per_clip=f"{ms:.2f}")
        check(agree * 6 >= glyphs * 5, f"gather {px}: primary boxes agree "
              f"with the host detector on {agree}/{glyphs}")
        check(found * 6 >= glyphs * 5, f"gather {px}: planted glyphs found "
              f"on {found}/{glyphs}")
        check(quiet == noise, f"gather {px}: nothing on noise frames")
    return out


def glyph_gif_clip(seed, frames=CLIP_LEN, size=CLIP_SIZE, side=44):
    """A (frames, size, size, 3) clip of the cascade's glyph drifting over
    black, as a generated sample that must track."""
    rng = np.random.default_rng(seed)
    x0, y0 = (int(v) for v in rng.integers(0, size - side - frames // 2, 2))
    glyph = np.rint(synthetic_cascade.glyph_image(side)).astype(np.uint8)
    clip = np.zeros((frames, size, size, 3), np.uint8)
    for t in range(frames):
        x, y = x0 + t // 2, y0 + t // 3
        clip[t, y:y + side, x:x + side] = glyph[..., None]
    return clip


def phase_eval(xml, seed, workdir, ts, cfg, profile=False):
    """The evaluation tools on the workflow's runs: eval-fad at the flagship
    width, eval-track-rate over the wall's GIFs and glyph GIFs (K3, K4),
    face-detect (K3), survey-pairs, and the plateau stop on the phase's own
    rate and FAD. `profile` adds a torch.profiler table of the track rate
    of 2 glyph clips."""
    out = {}
    img_ckpt = os.path.join(workdir, "img", "checkpoints")
    icfg, params, state = cli._load_dcgan_from_run(img_ckpt, DEVICE)
    real_dir, fake_dir = (os.path.join(workdir, d) for d in ("real", "fake"))
    for d in (real_dir, fake_dir):
        os.makedirs(d)
    img_side = icfg.output_size
    for i, im in enumerate(synthetic_stills(FAD_IMAGES, size=img_side,
                                            seed=seed + 70)):
        write_png(os.path.join(real_dir, f"{i:04d}.png"), im)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 71)
    z = torch.rand(FAD_IMAGES, icfg.z_dim, device=DEVICE, generator=g) * 2 - 1
    fake = denorm_u8(dcgan.sample(params, state, z, icfg))
    for i, im in enumerate(fake):
        write_png(os.path.join(fake_dir, f"{i:04d}.png"), im)
    argv = ["eval-fad", "--checkpoint", img_ckpt, "--batch-size",
            str(FAD_BATCH)]
    t = time.perf_counter()
    got = json.loads(cli_out(argv + ["--real-dir", real_dir, "--fake-dir",
                                     fake_dir]))
    cmd_s = time.perf_counter() - t
    self_fad = json.loads(cli_out(argv + ["--real-dir", real_dir,
                                          "--fake-dir", real_dir]))["fad"]
    check(got["n_real"] == got["n_fake"] == FAD_IMAGES
          and math.isfinite(got["fad"]) and got["fad"] > 0,
          f"eval-fad: {got}")
    check(self_fad < 1e-6, f"FAD of a set against itself: {self_fad}")
    reals = cli._image_dir_to_batch(real_dir, img_side, icfg.c_dim)
    pd, sd = params["discriminator"], state["discriminator"]
    tfad.embed(pd, sd, reals[:FAD_BATCH], icfg, FAD_BATCH, DEVICE)  # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    tfad.embed(pd, sd, reals, icfg, FAD_BATCH, DEVICE)
    torch.cuda.synchronize()
    embed_ms = (time.perf_counter() - t) * 1e3 * FAD_BATCH / FAD_IMAGES
    # card vs CPU on one set's features, float32 with TF32 off
    f32 = dataclasses.replace(icfg, compute_dtype="float32")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = tfad.embed(pd, sd, reals[:FAD_BATCH], f32, FAD_BATCH, DEVICE)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    host = tfad.embed(to_device(pd, "cpu"), to_device(sd, "cpu"),
                      reals[:FAD_BATCH], f32, FAD_BATCH, "cpu")
    err = float(np.abs(card - host).max() / np.abs(host).max())
    check(err <= FEATURE_TOL, f"h2 features card vs CPU: {err} of the "
          f"largest (tolerance {FEATURE_TOL})")
    say("eval", step="fad", images=FAD_IMAGES, batch=FAD_BATCH,
        fad=got["fad"], self_fad=self_fad, command_s=f"{cmd_s:.2f}",
        extract_ms_per_256=f"{embed_ms:.3f}",
        features_card_vs_cpu_rel=f"{err:.3g}", tolerance=FEATURE_TOL)

    # eval-track-rate: the wall's GIFs (upscaled 2x) and glyph GIFs
    wall = os.path.join(workdir, "wall_eval")
    glyphs = os.path.join(workdir, "glyphs")
    os.makedirs(wall)
    os.makedirs(glyphs)
    src_wall = os.path.join(workdir, "wall")
    for f in sorted(os.listdir(src_wall), key=lambda n: int(n[:-4]))[
            :TRACK_RATE_CLIPS]:
        os.link(os.path.join(src_wall, f), os.path.join(wall, f))
    for i in range(GLYPH_CLIPS):
        write_gif(os.path.join(glyphs, f"{i}.gif"), glyph_gif_clip(seed + i))
    reset_counts()
    t = time.perf_counter()
    report = cli_out(["eval-track-rate", "--sample-dirs", wall, glyphs,
                      "--cascade", xml, "--limit", str(TRACK_RATE_CLIPS),
                      "--out-dir", os.path.join(workdir, "rates")])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / (TRACK_RATE_CLIPS + GLYPH_CLIPS)
    out["eval_track_rate"] = read_counts()
    rates = {}
    for name, n in (("wall_eval", TRACK_RATE_CLIPS), ("glyphs", GLYPH_CLIPS)):
        with open(os.path.join(workdir, "rates", f"{name}_results",
                               "stats.json")) as f:
            st = json.load(f)
        check(st["counters"]["cnt_files_errored"] == 0
              and st["counters"]["cnt_files_processed"] == n
              and st["total_files"] == n,
              f"{name}: no clip errored: {st['counters']}")
        line = [ln for ln in report.splitlines()
                if ln.startswith(name + ":")][0]
        tracked, total = (int(v) for v in
                          line.split()[1].split("/"))
        rates[name] = tracked / total
    check(rates["glyphs"] >= 0.75, f"glyph set's track rate: {rates}")
    check(out["eval_track_rate"]["haar_stages"] > 0
          and out["eval_track_rate"]["lk_refine"] > 0,
          f"eval-track-rate went through K3 and K4: {out}")
    say("eval", step="track_rate", wall_clips=TRACK_RATE_CLIPS,
        glyph_clips=GLYPH_CLIPS, frames="128x128 (64 upscaled 2x)",
        rate_wall=rates["wall_eval"], rate_glyphs=rates["glyphs"],
        ms_per_clip=f"{ms:.1f}", launches=out["eval_track_rate"])
    if profile:
        det = DeviceHaarDetector(xml, min_neighbors=2, device=DEVICE)
        clips = [np.repeat(np.repeat(glyph_gif_clip(seed + i), 2, 1), 2, 2)
                 for i in range(2)]
        face_track_rate(clips[:1], det)                   # warm
        profile_step("eval_track_rate", lambda: face_track_rate(clips, det))

    # face-detect on a 360x480 glyph frame
    frames, boxes = source_clip(seed + 80)
    write_png(os.path.join(workdir, "frame.png"), frames[0])
    x, y, side = boxes[0]
    write_png(os.path.join(workdir, "query.png"),
              frames[0][y:y + side, x:x + side])
    reset_counts()
    t = time.perf_counter()
    faces = json.loads(cli_out(["face-detect", "--image",
                                os.path.join(workdir, "frame.png"),
                                "--cascade", xml, "--best", "--biggest",
                                "--query",
                                os.path.join(workdir, "query.png")]))
    ms = (time.perf_counter() - t) * 1e3
    out["face_detect"] = read_counts()
    best = faces.get("best")
    check(best is not None and iou((best[0], best[1], best[2] - best[0],
                                    best[3] - best[1]),
                                   (x, y, side, side)) > 0.6,
          f"face-detect's best box is the glyph at {boxes[0]}: {faces}")
    check(out["face_detect"]["haar_stages"] > 0,
          f"face-detect went through K3: {out['face_detect']}")
    say("eval", step="face_detect", frame=f"{SRC_H}x{SRC_W}",
        faces=len(faces["faces"]), best=best, planted=boxes[0],
        ms=f"{ms:.1f}", launches=out["face_detect"])

    # survey-pairs on exported samples of the flagship sampler
    sample = vid_sample_fn(ts, cfg)
    rng = np.random.default_rng(seed + 90)

    def nested(n):
        z = rng.uniform(-1, 1, (n, cfg.z_input_size)).astype(np.float32)
        return denorm_u8(sample(z))

    grids = np.stack([denorm_u8(dcgan.sample(
        params, state, torch.rand(64, icfg.z_dim, device=DEVICE,
                                  generator=g) * 2 - 1, icfg)).reshape(
        8, 8, img_side, img_side, 3).transpose(0, 2, 1, 3, 4).reshape(
        8 * img_side, 8 * img_side, 3) for _ in range(2)])
    survey = os.path.join(workdir, "survey")
    manifest = tsurvey.export_survey_samples(
        {"nested": nested,
         "stride": lambda n: tsurvey.stride_control_videos(
             grids, img_side, cfg.vid_length, n, seed=seed)},
        survey, samples_per_variant=SURVEY_SAMPLES)
    cli_out(["survey-pairs", "--sample-dir", survey, "--variant-a", "nested",
             "--variant-b", "stride", "--seed", str(seed)])
    with open(os.path.join(survey, "pairs.json")) as f:
        pairs = json.load(f)
    with open(os.path.join(survey, "pairs.csv")) as f:
        rows = f.read().splitlines()
    check(len(pairs["pairs"]) == SURVEY_SAMPLES == len(rows) - 1
          and all(len(v) == SURVEY_SAMPLES
                  for v in manifest["variants"].values()),
          f"survey-pairs: {len(pairs['pairs'])} pairs, {len(rows)} rows")
    check(read_gif(os.path.join(survey, manifest["variants"]["nested"][0]))
          .shape == (cfg.vid_length, img_side, img_side, 3),
          "survey GIF shape")
    say("eval", step="survey_pairs", samples_per_variant=SURVEY_SAMPLES,
        pairs=len(pairs["pairs"]),
        swaps=sum(p["swap"] for p in pairs["pairs"]))

    # the plateau stop on this phase's own rate and FAD, then its replay
    policy = early_stop.QualityEarlyStop(early_stop.EarlyStopConfig(
        patience=2, warmup_evals=2))
    r_wall, r_glyph, fad = rates["wall_eval"], rates["glyphs"], got["fad"]
    trace = [(r_wall, fad), (r_glyph, fad), (r_glyph, fad),
             (r_glyph, self_fad), (r_wall, fad), (r_wall, fad)]
    log = os.path.join(workdir, "evals.jsonl")
    events = []
    with open(log, "w") as f:
        for i, (rate, fad) in enumerate(trace):
            ev = policy.observe(rate, fad, chunk=i + 1, step=(i + 1) * 100)
            events += [ev] if ev else []
            f.write(json.dumps({"kind": "eval", "chunk": i + 1,
                                "step": (i + 1) * 100, "rate": rate,
                                "fad": fad}) + "\n")
    replayed = early_stop.QualityEarlyStop(policy.config)
    check(early_stop.replay_eval_log(log, replayed) == events
          and replayed == policy, "the replay equals the live policy")
    say("eval", step="early_stop", evals=policy.evals,
        events=",".join(e["kind"] for e in events), stopped=policy.stopped,
        best_chunk=policy.best_chunk, replay="equal")
    return out


def http_json(url, data=None, token=None, timeout=600):
    """(status, JSON body) of one request to a local service; an HTTP
    error's status and body are returned, not raised."""
    import urllib.error
    import urllib.request

    headers = {"Authorization": f"Bearer {token}"} if token else {}
    req = urllib.request.Request(url, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def declared_body_status(port, path, n_bytes, token):
    """Status of an authorized POST that declares an n-byte body and sends
    none: a service that checks the cap answers from the header alone."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.putrequest("POST", path)
    conn.putheader("Authorization", f"Bearer {token}")
    conn.putheader("Content-Length", str(n_bytes))
    conn.endheaders()
    status = conn.getresponse().status
    conn.close()
    return status


def _explorer_session(base, token, z_dim, seed):
    """One pass of the explorer's actions over HTTP: {action: ms}, the
    last response. Each response must say success."""
    from urllib.parse import urlencode

    zs = np.random.default_rng(seed).uniform(
        -1, 1, (EXPLORER_LOAD, z_dim)).astype(np.float32)
    steps = [("init_face", "/init_face?step_size=0.5", None),
             ("random_faces", "/random_faces", None),
             ("init_directions", "/init_directions?step_size=0.5", None),
             ("add_image", "/add_image?row=0&col=2&step_size=0.5", None),
             ("get_similar", "/get_similar?row=1&col=1&step_size=0.5"
              "&similarity=0.3", None),
             ("load_video_description", "/load_video_description",
              urlencode({"description": repr(zs.tolist())}).encode()),
             ("save", "/save?frame_rate=8", None)]
    ms, last = {}, None
    for name, route, data in steps:
        t = time.perf_counter()
        status, last = http_json(base + route, data, token)
        ms[name] = (time.perf_counter() - t) * 1e3
        check(status == 200 and last["response"] == "success",
              f"explorer {name}: {status} {last}")
    return ms, last


def phase_serve_web(xml, seed, workdir):
    """The serving and checkpoint tools on the workflow's train-dcgan run
    at the flagship width: the explorer over HTTP (float, then int8), the
    webcam service (capture_face with the device detector, K3; two
    /animate requests of 1200 inversion steps), export-web, survey-serve
    on the eval phase's export, ckpt-inspect and ckpt-downgrade."""
    import cv2

    from gifgan_tpu_torch.core import ckpt_tools
    from gifgan_tpu_torch.ops.image import encode_png
    from gifgan_tpu_torch.serve import STATIC_DIR
    from gifgan_tpu_torch.serve import explorer, survey, web_export, webcam
    from gifgan_tpu_torch.serve.http_common import MAX_IMAGE_BODY
    from gifgan_tpu_torch.track.detect import default_detector

    out, token = {}, "chip-smoke-token"
    img_ckpt = os.path.join(workdir, "img", "checkpoints")
    cfg, params, state = cli._load_dcgan_from_run(img_ckpt, DEVICE)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")

    # 1. explorer, float: the sampler card vs CPU, then the actions
    z = np.random.default_rng(seed + 100).uniform(
        -1, 1, (BATCH, cfg.z_dim)).astype(np.float32)
    with quant._true_float32():
        card = explorer.dcgan_sampler(params, state, f32, device=DEVICE)(z)
    host = explorer.dcgan_sampler(to_device(params, "cpu"),
                                  to_device(state, "cpu"), f32,
                                  device="cpu")(z)
    err = float(np.abs(card - host).max())
    check(err <= EXPLORER_TOL, f"explorer sampler card vs CPU: {err}")
    say("serve_web", check="explorer sampler card vs CPU", batch=BATCH,
        dtype="float32 (TF32 off)", max_abs_err=f"{err:.3g}",
        tolerance=EXPLORER_TOL)

    def explorer_ms(sampler, media, sessions):
        core = explorer.ExplorerCore(sampler, cfg.z_dim, media,
                                     batch_size=BATCH)
        server = explorer.serve(core, port=0, background=True,
                                static_dir=STATIC_DIR, auth_token=token)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            status, _ = http_json(base + "/random_faces")
            check(status == 401, f"explorer without the token: {status}")
            runs = [sessions(base, i) for i in range(EXPLORER_REPEATS)]
        finally:
            server.shutdown()
            server.server_close()
        return core, runs

    sampler = explorer.dcgan_sampler(params, state, cfg, device=DEVICE)
    sampler(np.zeros((BATCH, cfg.z_dim), np.float32))          # warm
    reset_counts()
    core, runs = explorer_ms(sampler, os.path.join(workdir, "explorer"),
                             lambda base, i: _explorer_session(
                                 base, token, cfg.z_dim, seed + i))
    torch.cuda.synchronize()
    out["explorer"] = read_counts()
    last = runs[-1][1]
    frames = mp4_frames(last["path"])
    check(frames == len(core.video_zs) > 0,
          f"the saved mp4 opens: {frames} frames of {len(core.video_zs)}")
    faces = len(last["msg"]["direction_paths"]) * len(
        last["msg"]["direction_paths"][0])
    say("serve_web", step="explorer", sampler=f"float ({cfg.compute_dtype})",
        batch=BATCH, faces=faces, repeats=EXPLORER_REPEATS,
        saved_mp4_frames=frames, launches=out["explorer"],
        **{f"{k}_ms": f"{float(np.median([r[0][k] for r in runs])):.2f}"
           for k in runs[0][0]})

    # 2. explorer, int8 with 2 calibration batches: random_faces
    q_sampler = explorer.dcgan_sampler(params, state, cfg, batch_size=BATCH,
                                       int8=True, int8_calib=2,
                                       device=DEVICE)
    q_sampler(np.zeros((BATCH, cfg.z_dim), np.float32))        # warm

    def faces_only(base, i):
        t = time.perf_counter()
        status, r = http_json(base + "/random_faces", None, token)
        check(status == 200 and r["response"] == "success",
              f"explorer int8 random_faces: {status} {r}")
        return (time.perf_counter() - t) * 1e3

    reset_counts()
    q_core, q_ms = explorer_ms(q_sampler, os.path.join(workdir, "explorer8"),
                               faces_only)
    torch.cuda.synchronize()
    out["explorer_int8"] = read_counts()
    zs = q_core.direction_zs.reshape(-1, cfg.z_dim)
    x, y = q_sampler(zs).astype(np.float64), sampler(zs).astype(np.float64)
    mse_u8 = float(np.mean((denorm_u8(x).astype(np.float64)
                            - denorm_u8(y)) ** 2))
    psnr = 10 * math.log10(255.0 ** 2 / max(mse_u8, 1e-12))
    corr = float(np.corrcoef(x.ravel(), y.ravel())[0, 1])
    check(corr > 0.99, f"int8 faces track the float faces: corr {corr}")
    say("serve_web", step="explorer_int8", calib_batches=2, faces=len(zs),
        random_faces_ms=f"{float(np.median(q_ms)):.2f}",
        vs=f"float sampler ({cfg.compute_dtype})", psnr_db=f"{psnr:.2f}",
        corr=f"{corr:.5f}", launches=out["explorer_int8"])

    # 3. webcam: capture_face with the device detector (K3), then /animate
    frames_src, boxes = source_clip(seed + 101)
    detector = default_detector(cascade_path=xml, min_neighbors=3,
                                device=DEVICE)
    reset_counts()
    capture_ms = []
    for _ in range(2):               # the first call builds the K3 plan
        t = time.perf_counter()
        face, box = webcam.capture_face(
            iter([(frames_src[0], False), (frames_src[1], True)]), detector,
            target_size=cfg.output_size)
        torch.cuda.synchronize()
        capture_ms.append((time.perf_counter() - t) * 1e3)
    out["capture_face"] = read_counts()
    check(face is not None and face.shape == (cfg.output_size,) * 2 + (3,),
          f"capture_face found the glyph: {box}")
    x1, y1, side = boxes[1]
    overlap = iou((box.x1, box.y1, box.x2 - box.x1, box.y2 - box.y1),
                  (x1, y1, side, side))
    check(box.frame_number == 1 and overlap > 0.5,
          f"the captured box {box} is the planted glyph {boxes[1]}")
    check(out["capture_face"]["haar_stages"] > 0,
          f"capture_face went through K3: {out['capture_face']}")
    say("serve_web", step="capture_face", frame=f"{SRC_H}x{SRC_W}",
        box=(box.x1, box.y1, box.x2, box.y2), planted=boxes[1],
        iou=f"{overlap:.3f}", frames=2,
        ms=",".join(f"{v:.1f}" for v in capture_ms),
        launches=out["capture_face"])

    paths_dir = os.path.join(workdir, "web_paths")
    os.makedirs(paths_dir)
    for name in WEBCAM_PATHS:
        os.link(os.path.join(workdir, "inv_paths", f"{name}.txt"),
                os.path.join(paths_dir, f"{name}.txt"))
    backend = webcam.WebcamBackend(
        params, state, cfg, os.path.join(workdir, "webcam"),
        paths=webcam.load_latent_paths(paths_dir, cfg.z_dim),
        device=DEVICE)
    inversions = []
    inner = webcam.invert_images

    def timed_inversion(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = inner(*a, **kw)
        torch.cuda.synchronize()
        inversions.append((time.perf_counter() - t, res[1]))
        return res

    webcam.invert_images = timed_inversion
    server = webcam.serve(backend, port=0, background=True,
                          auth_token=token)
    port = server.server_address[1]
    base = f"http://127.0.0.1:{port}"
    try:
        png = encode_png(face)
        status, body = http_json(base + "/animate", png)
        check(status == 401, f"/animate without the token: {status} {body}")
        status = declared_body_status(port, "/animate", MAX_IMAGE_BODY + 1,
                                      token)
        check(status == 413, f"an oversized /animate body: {status}")
        reset_counts()
        req_ms, results = [], []
        for _ in range(WEBCAM_REQUESTS):
            t = time.perf_counter()
            status, r = http_json(base + "/animate", png, token)
            req_ms.append((time.perf_counter() - t) * 1e3)
            check(status == 200 and r["response"] == "success",
                  f"/animate: {status} {r}")
            results.append(r)
        torch.cuda.synchronize()
        out["webcam"] = read_counts()
    finally:
        webcam.invert_images = inner
        server.shutdown()
        server.server_close()
    steps = backend.icfg.steps
    say("serve_web", step="webcam", requests=WEBCAM_REQUESTS, steps=steps,
        batch=backend.icfg.batch_size, paths=",".join(WEBCAM_PATHS),
        request_ms=",".join(f"{v:.1f}" for v in req_ms),
        inversion_ms=",".join(f"{s * 1e3:.1f}" for s, _ in inversions),
        ms_per_step=",".join(f"{s * 1e3 / steps:.3f}"
                             for s, _ in inversions),
        first_loss=",".join(f"{ls[0]:.5f}" for _, ls in inversions),
        last_loss=",".join(f"{ls[-1]:.5f}" for _, ls in inversions),
        loss_ratio=",".join(f"{ls[-1] / ls[0]:.4f}" for _, ls in inversions),
        progress_frames=mp4_frames(results[-1]["progress_video"]),
        unauthorized=401, oversized=413, launches=out["webcam"])
    for r, (secs, losses) in zip(results, inversions):
        check(len(losses) == steps and losses[-1] < 0.9 * losses[0],
              f"the inversion's loss falls: {losses[0]} -> {losses[-1]}")
        check(len(r["paths"]) == len(WEBCAM_PATHS)
              and all(mp4_frames(p) > 0 for p in r["paths"].values())
              and mp4_frames(r["progress_video"]) > 0,
              f"the webcam's mp4s open: {r}")
        recon = cv2.imread(r["reconstruction"], cv2.IMREAD_COLOR)
        check(recon is not None and recon.shape == face.shape,
              f"reconstruction.png: {r['reconstruction']}")

    # 4. export-web through the CLI: golden.json against the card's
    #    generator (float32, TF32 off) and generator_forward_reference
    web = os.path.join(workdir, "web")
    reset_counts()
    t = time.perf_counter()
    cli_out(["export-web", "--checkpoint", img_ckpt, "--out-dir", web])
    export_s = time.perf_counter() - t
    out["export_web"] = read_counts()
    with open(os.path.join(web, "weights.json")) as f:
        doc = json.load(f)
    with open(os.path.join(web, "golden.json")) as f:
        golden = json.load(f)
    gz = torch.tensor([golden["z"]], device=DEVICE)
    with quant._true_float32():
        card32 = dcgan.sample(params, state, gz, f32)[0].cpu().numpy()
    served = dcgan.sample(params, state, gz, cfg)[0].float().cpu().numpy()

    def u8(img):
        return np.clip(np.round(255.0 * (np.asarray(img) + 1.0) / 2.0), 0,
                       255).astype(int).ravel()

    ref = u8(web_export.generator_forward_reference(doc, golden["z"]))
    d_card = int(np.abs(ref - u8(card32)).max())
    d_golden = int(np.abs(ref - np.asarray(golden["image_u8"])).max())
    d_served = int(np.abs(ref - u8(served)).max())
    check(d_card <= 1 and d_golden <= 1,
          f"generator_forward_reference vs the card {d_card}, vs "
          f"golden.json {d_golden} (u8 levels)")
    say("serve_web", step="export_web", seconds=f"{export_s:.2f}",
        files=len(os.listdir(web)),
        weights_json_bytes=os.path.getsize(os.path.join(web,
                                                        "weights.json")),
        ref_vs_card_f32_u8=d_card, ref_vs_golden_u8=d_golden,
        ref_vs_served_bf16_u8=d_served, launches=out["export_web"])

    # 5. survey-serve on the eval phase's export: 8 ratings -> /results
    srv = survey.serve(survey.SurveyServer(os.path.join(workdir, "survey")),
                       port=0, background=True)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        status, manifest = http_json(base + "/manifest.json")
        check(status == 200, f"survey manifest: {status}")
        ratings = collections.defaultdict(list)
        for i in range(SURVEY_RATINGS):
            variant = sorted(manifest["variants"])[i % 2]
            gif = manifest["variants"][variant][i // 2]
            rating = 1 + (3 * i) % 5
            status, r = http_json(base + "/response", json.dumps(
                {"gif": gif, "variant": variant, "rating": rating,
                 "worker": f"w{i % 3}"}).encode())
            check(status == 200 and r["response"] == "success",
                  f"survey response {i}: {status} {r}")
            ratings[variant].append(rating)
        status, res = http_json(base + "/results")
    finally:
        srv.shutdown()
        srv.server_close()
    want = {v: {"n": len(rs), "mean_rating": sum(rs) / len(rs)}
            for v, rs in sorted(ratings.items())}
    check(status == 200 and res["variants"] == want,
          f"survey /results {res} against {want}")
    say("serve_web", step="survey_serve", ratings=SURVEY_RATINGS,
        results=json.dumps(res["variants"], sort_keys=True),
        ab_responses=res.get("ab", {}).get("n_responses"))

    # 6. ckpt-inspect (the workflow run, the TF fixture), ckpt-downgrade
    fixture = os.path.join(REPO, "tests", "fixtures", "tf_ref_dcgan")
    lines = cli_out(["ckpt-inspect", img_ckpt], echo=False).splitlines()
    check(lines[-1].startswith("total parameters: ")
          and len(lines) == len(ckpt.load_flat(img_ckpt)) + 1,
          f"ckpt-inspect of the run: {lines[-1]}")
    tf_lines = cli_out(["ckpt-inspect", os.path.join(fixture, "ref.ckpt")],
                       echo=False).splitlines()
    v1 = os.path.join(workdir, "ref_v1.ckpt")
    cli_out(["ckpt-downgrade", "--input-prefix",
             os.path.join(fixture, "ref.ckpt"), "--output", v1])
    back = ckpt_tools.read_tf_checkpoint(v1)
    with np.load(os.path.join(fixture, "expected.npz")) as e:
        expected = {k: e[k] for k in e.files}
    check(len(tf_lines) == len(expected) == len(back)
          and all(back[k].dtype == v.dtype and np.array_equal(back[k], v)
                  for k, v in expected.items()),
          "ckpt-downgrade's V1 file reads back bit-equal to expected.npz")
    say("serve_web", step="ckpt_tools", run_keys=len(lines) - 1,
        run_total=lines[-1].split(": ")[1], tf_variables=len(tf_lines),
        v1_bytes=os.path.getsize(v1), v1_bit_equal=True)
    return out

def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def exact_f32():
    """float32 without TF32, and the deterministic kernels (cuDNN's, and
    PyTorch's deterministic index_put for the packed convs' weight
    gathers; warn_only: ops without one warn), restored after. Without
    them two runs of the same flagship steps on the card part by ~5e-3 in
    the losses after one Adam update (PERF.md section 6)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = prev[:3]
        torch.use_deterministic_algorithms(prev[3], warn_only=prev[4])


def _f32(cfg):
    return dataclasses.replace(
        cfg, compute_dtype="float32",
        image_gan=dataclasses.replace(cfg.image_gan, compute_dtype="float32"))


def mesh_bytes(ts, tcfg, n=2):
    """What one flagship step moves over the data axis, counted from the
    state's leaves: the gradient all-reduce of DP (the vid-D's floats once,
    the vid-G's once a G update), and under FSDP over n ranks the
    all-gather of every sharded params and state leaf in each of the
    step's updates, and the reduce-scatter of the sharded trainable
    leaves."""
    p = ts.params
    count = lambda tree: sum(v.numel() for v in flatten(tree).values())
    d, g = count(p["vid_discriminator"]), count(p["vid_generator"])
    frozen = count(p["img_generator"]) + count(p["img_discriminator"])
    shard = {k: tfsdp.shard_dim(k, v.shape, n, 2048)
             for k, v in flatten(ts).items()}
    flat = {k: v.numel() for k, v in flatten(ts).items()}
    gathered = sum(v for k, v in flat.items() if shard[k] is not None
                   and k.startswith(("params/", "state/")))
    scattered = lambda role: sum(
        v for k, v in flat.items()
        if shard[k] is not None and k.startswith(f"opt_{role}/mu/"))
    updates = tcfg.disc_updates + tcfg.gen_updates
    return {"vid_d_floats": d, "vid_g_floats": g, "frozen_img_floats": frozen,
            "grad_all_reduce_bytes": 4 * (d * tcfg.disc_updates
                                          + g * tcfg.gen_updates),
            "fsdp_all_gather_bytes": 4 * gathered * updates,
            "fsdp_reduce_scatter_bytes": 4 * (
                scattered("d") * tcfg.disc_updates
                + scattered("g") * tcfg.gen_updates)}


def _mesh_one_rank(seed, workdir, clips):
    """(a): one NCCL rank drives train_vid_dcgan(mesh=) at the flagship
    widths in float32 with TF32 off, DP and FSDP, against the no-mesh run;
    then the bf16 flagship's ms/step on each path."""
    initialize(f"localhost:{_free_port()}", num_processes=1, process_id=0)
    try:
        check(dist.get_backend() == "nccl", "one rank on the card is NCCL")
        one = torch.ones(4, device=DEVICE)
        dist.all_reduce(one)
        check(float(one.sum()) == 4.0, "an NCCL all_reduce of one rank")
        cfg, tcfg = flagship()
        cfg32 = _f32(cfg)
        runs, counts = {}, {}
        with exact_f32():
            for name, kw in (("none", {}), ("dp", {"mesh": make_mesh()}),
                             ("fsdp", {"mesh": make_mesh(), "fsdp": True})):
                run = os.path.join(workdir, f"one_rank_{name}")
                tc = dataclasses.replace(tcfg, run_dir=run, seed=seed,
                                         sample_every=0,
                                         checkpoint_every=MESH_STEPS // 2)
                reset_counts()
                loops.train_vid_dcgan(None, cfg32, tc, clips_u8=clips,
                                      chunk=MESH_STEPS // 2,
                                      steps_limit=MESH_STEPS, device=DEVICE,
                                      **kw)
                torch.cuda.synchronize()
                counts[name] = read_counts()
                check(counts[name]["gather_rows_scaled"] == MESH_STEPS,
                      f"{name}: K1 once a step: {counts[name]}")
                runs[name] = (_records(run), [ckpt.load_flat(
                    os.path.join(run, "checkpoints"), step) for step in
                    (MESH_STEPS // 2, MESH_STEPS)])
        base_recs, base_flat = runs["none"]
        for name in ("dp", "fsdp"):
            recs, flats = runs[name]
            loss = max(abs(recs[0][k] - base_recs[0][k])
                       for k in ("d_loss", "g_loss", "first_frame_loss"))
            err = [max(float(np.abs(f[k].astype(np.float64) - b[k]).max())
                       for k in b if k.startswith("params/"))
                   for f, b in zip(flats, base_flat)]
            check(loss <= MESH_PARITY_TOL and err[0] <= MESH_PARITY_TOL,
                  f"{name} after {MESH_STEPS // 2} steps: losses {loss}, "
                  f"params {err[0]} within {MESH_PARITY_TOL}")
            say("mesh", case="one_rank_nccl_f32", path=name,
                steps=MESH_STEPS // 2, loss_max_abs_err=loss,
                param_max_abs_err=err[0],
                step4_loss_max_abs_err=max(
                    abs(recs[-1][k] - base_recs[-1][k])
                    for k in ("d_loss", "g_loss", "first_frame_loss")),
                step4_param_max_abs_err=err[1], launches=counts[name])

        # the flagship's own dtype: ms/step of train_chunk_ids, K steps a
        # chunk, on each path
        ts0 = vid.init_train_state(torch.Generator().manual_seed(seed), cfg,
                                   tcfg, device=DEVICE)
        corpus = DeviceCorpus(clips, device=DEVICE)
        g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
        ids = torch.randint(0, len(clips), (K_STEPS, BATCH), device=DEVICE,
                            generator=g)
        z = torch.rand(K_STEPS, BATCH, cfg.z_input_size, device=DEVICE,
                       generator=g) * 2 - 1
        static = dict(corpus_data=corpus.data, cfg=cfg, tcfg=tcfg,
                      sample_fn=corpus.fold_sample_fn)
        mesh = make_mesh()
        timing = {}
        for name in ("none", "dp", "fsdp"):
            if name == "none":
                ts = ts0
                fn = lambda t, i, zz, gg: vid.train_chunk_ids(t, i, zz, gg,
                                                              **static)
            else:
                sh = None
                if name == "fsdp":
                    ts, sh = tfsdp.place_and_shardings(mesh, ts0)
                else:
                    ts = shard_train_state(mesh, ts0)
                fn = make_sharded_step(vid.train_chunk_ids, mesh,
                                       static_args=static, batch_axis=1,
                                       state_shardings=sh)
            ts, m = fn(ts, ids, z, g)                       # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t = time.perf_counter()
            for _ in range(MESH_TIMED_CHUNKS):
                ts, m = fn(ts, ids, z, g)
            float(m["d_loss"][-1])
            torch.cuda.synchronize()
            timing[name] = ((time.perf_counter() - t) * 1e3
                            / (MESH_TIMED_CHUNKS * K_STEPS))
            launches = read_counts()
            check(launches["gather_rows_scaled"]
                  == MESH_TIMED_CHUNKS * K_STEPS, f"bf16 {name}: K1 once a "
                                                  f"step: {launches}")
            check(all(math.isfinite(float(v[-1])) for v in m.values()),
                  f"bf16 {name} metrics finite")
            counts[f"bf16_{name}"] = launches
            say("mesh", case="one_rank_nccl_bf16", path=name,
                ms_per_step=f"{timing[name]:.3f}",
                peak_bytes=torch.cuda.max_memory_allocated(),
                launches=launches)
        say("mesh", case="bytes_per_flagship_step", **mesh_bytes(ts0, tcfg))
    finally:
        dist.destroy_process_group()
    return counts, timing


MESH_MODEL_FLAGS = ["--output-size", "64", "--z-dim", "100", "--gf-dim", "64",
                    "--df-dim", "64", "--compute-dtype", "float32",
                    "--packed-c3"]


def _mesh_plan(seed, workdir):
    """(b)'s commands: train-vid DP, train-vid FSDP, then sample-wall,
    float and int8, on the DP run's checkpoint; the one-rank reference of
    each drops --data-parallel and --fsdp."""
    train = (["train-vid", "--device-corpus", "--chunk", "1", "--steps-limit",
              str(MESH_CLI_STEPS), "--dataset-size", str(MESH_CLIPS),
              "--batch-size", str(BATCH), "--first-frame-loss-scalar", "1.0",
              "--seed", str(seed)] + MESH_MODEL_FLAGS)
    ck = os.path.join(workdir, "two_dp", "checkpoints")
    wall = ["sample-wall", "--checkpoint", ck, "--num-batches", "1",
            "--batch-size", str(BATCH), "--seed", str(seed)]
    return [
        ("train_vid_dp", train + ["--run-dir", os.path.join(workdir,
                                                            "two_dp")],
         ["--data-parallel", "2"]),
        ("train_vid_fsdp", train + ["--run-dir", os.path.join(
            workdir, "two_fsdp")], ["--data-parallel", "2", "--fsdp"]),
        ("wall", wall + ["--out-dir", os.path.join(workdir, "two_wall")],
         ["--data-parallel", "2"]),
        ("wall_int8", wall + ["--int8", "--out-dir", os.path.join(
            workdir, "two_wall_int8")], ["--data-parallel", "2"]),
    ]


def _fsdp_collectives_ok():
    """Whether the two ranks' gloo group takes FSDP's all-gather and
    reduce-scatter (staged through the host): "" or the error."""
    from gifgan_tpu_torch.parallel.collectives import DataGroup

    dg = DataGroup(None, dist.get_rank(), dist.get_world_size())
    x = torch.arange(8, dtype=torch.float32, device=DEVICE)
    try:
        full = dg.all_gather(dg.rows(x), 0)
        total = dg.reduce_scatter(x, 0)
    except RuntimeError as e:
        return str(e).splitlines()[0]
    if not (torch.equal(full, x) and torch.equal(total,
                                                 dg.rows(x) * dg.size)):
        return "wrong values"
    return ""


def mesh_rank(plan_path):
    """One rank of (b), started by torch.distributed.run: each planned
    command through cli.main, launch counts zeroed before and read after;
    writes rank<R>.json beside the plan."""
    with open(plan_path) as f:
        plan = json.load(f)
    initialize()
    rank = dist.get_rank()
    report = {"backend": dist.get_backend(), "runs": {}}
    fsdp_error = _fsdp_collectives_ok()
    report["fsdp_collectives"] = fsdp_error or "ok"
    meshes = []
    made = cli._mesh_arg
    cli._mesh_arg = lambda args: meshes.append(made(args)) or meshes[-1]
    with exact_f32():
        for name, argv in plan:
            if "--fsdp" in argv and fsdp_error:
                continue
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t = time.perf_counter()
            (tp_sp_grads if argv[0] == "grads" else cli.main)(argv)
            torch.cuda.synchronize()
            mesh = meshes[-1]
            report["runs"][name] = {
                "seconds": time.perf_counter() - t,
                "launches": read_counts(),
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "bytes": mesh.collective_bytes(),
                "model_gathers": [
                    [list(shape), n] for (kind, shape), n in
                    mesh.group(MODEL_AXIS).shapes.items()
                    if kind == "all_gather"]}
    with open(os.path.join(os.path.dirname(plan_path),
                           f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    return 0


def _wall_frames(out_dir):
    names = sorted(os.listdir(out_dir), key=lambda n: int(n.split(".")[0]))
    return np.stack([read_gif(os.path.join(out_dir, n)) for n in names])


def _mesh_two_ranks(seed, workdir):
    """(b): two ranks on the one card over gloo, started by
    torch.distributed.run, run the CLI (mesh_rank); the same commands on
    one rank in this process are the reference."""
    plan = _mesh_plan(seed, workdir)
    plan_path = os.path.join(workdir, "plan.json")
    with open(plan_path, "w") as f:
        json.dump([(name, argv + extra) for name, argv, extra in plan], f)
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", os.path.join(REPO, "chip_smoke.py"),
         "--mesh-rank", plan_path], cwd=REPO, timeout=MESH_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True)
    if proc.returncode:
        print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
    check(proc.returncode == 0, f"the two ranks exit 0 "
                                f"(rc {proc.returncode})")
    seconds = time.perf_counter() - t
    reports = []
    for r in range(2):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    ran = sorted(reports[0]["runs"])
    say("mesh", case="two_ranks_gloo", backend=reports[0]["backend"],
        fsdp_collectives=json.dumps(reports[0]["fsdp_collectives"]),
        ran=",".join(ran), seconds=f"{seconds:.1f}")
    counts = {}
    for r, rep in enumerate(reports):
        for name, run in rep["runs"].items():
            counts[f"rank{r}_{name}"] = run["launches"]
            if name.startswith("train_vid"):
                check(run["launches"]["gather_rows_scaled"] == MESH_CLI_STEPS,
                      f"rank {r} {name}: K1 once a step: {run['launches']}")
            say("mesh", case="two_ranks_gloo", rank=r, run=name,
                seconds=f"{run['seconds']:.2f}",
                peak_bytes=run["peak_bytes"],
                collective_bytes=json.dumps(run["bytes"]),
                launches=run["launches"])

    with exact_f32():
        for name, argv, _ in plan:
            if name not in ran:
                continue
            one = [os.path.join(workdir, "one_" + a[len(workdir) + 5:])
                   if a.startswith(os.path.join(workdir, "two_"))
                   and "checkpoints" not in a else a for a in argv]
            reset_counts()
            cli.main(one)
            if name.startswith("train_vid"):
                check(read_counts()["gather_rows_scaled"] == MESH_CLI_STEPS,
                      f"one rank {name}: K1 once a step")
                two = _records(os.path.join(workdir, f"two_{name[10:]}"))
                ref = _records(os.path.join(workdir, f"one_{name[10:]}"))
                check([r["step"] for r in two] == list(range(
                    1, MESH_CLI_STEPS + 1)), f"{name}: one record a step "
                                             f"(rank 0 alone writes)")
                keys = ("d_loss", "d_loss_real", "d_loss_fake", "g_loss",
                        "first_frame_loss")
                gaps = [max(abs(a[k] - b[k]) for k in keys)
                        for a, b in zip(two, ref)]
                check(gaps[0] <= MESH_CLI_TOL, f"{name}: first step's "
                      f"losses {gaps[0]} within {MESH_CLI_TOL} of one rank")
                ms = [1e3 / r["steps_per_sec"] for r in two[1:]]
                ms_one = [1e3 / r["steps_per_sec"] for r in ref[1:]]
                say("mesh", case="two_ranks_gloo_f32", run=name,
                    loss_gap_by_step=",".join(f"{x:.3g}" for x in gaps),
                    ms_per_step_warm_median=f"{float(np.median(ms)):.1f}",
                    one_rank_ms_per_step_warm_median=
                    f"{float(np.median(ms_one)):.1f}")
            else:
                two = _wall_frames(os.path.join(workdir, f"two_{name}"))
                ref = _wall_frames(os.path.join(workdir, f"one_{name}"))
                diff = np.abs(two.astype(int) - ref.astype(int))
                say("mesh", case="two_ranks_gloo_wall", run=name,
                    gifs=len(two), differing_bytes=int((diff > 0).sum()),
                    max_abs_diff=int(diff.max()))
                check(two.shape == ref.shape and not diff.any(),
                      f"{name}: the two-rank wall's frames equal one rank's")
    return counts


def phase_mesh(seed):
    """The data axis of the mesh: (a) one NCCL rank, (b) two gloo ranks on
    the card through the CLI. Returns the K1 launches of each run."""
    t = time.perf_counter()
    clips = synthetic_clips(MESH_CLIPS, length=CLIP_LEN, size=CLIP_SIZE)
    with tempfile.TemporaryDirectory() as workdir:
        counts, _ = _mesh_one_rank(seed, workdir, clips)
        counts.update(_mesh_two_ranks(seed, workdir))
    say("mesh", seconds=f"{time.perf_counter() - t:.1f}")
    return counts


def _tp_sp_plan(seed, workdir):
    """mesh_tp_sp's commands: train-vid on each mesh of TP_SP_MESHES, and
    the gradient check on each; the one-rank reference drops the mesh
    flags."""
    train = (["train-vid", "--device-corpus", "--chunk", "1",
              "--steps-limit", str(TP_SP_STEPS), "--dataset-size",
              str(MESH_CLIPS), "--batch-size", str(TP_SP_BATCH),
              "--first-frame-loss-scalar", "1.0", "--sample-every", "0",
              "--seed", str(seed)] + MESH_MODEL_FLAGS)
    plan = []
    for name, flags in TP_SP_MESHES.items():
        plan.append((name, train + ["--run-dir", os.path.join(workdir, name)]
                     + flags))
        plan.append((f"grads_{name}", ["grads", os.path.join(
            workdir, f"grads_{name}.pt"), str(seed)] + flags))
    return train, plan


def _grads_inputs(seed):
    """The gradient check's flagship state (float32, TP_SP_BATCH clips),
    frames (K1 from a synthetic corpus) and z, whole, on the card: the
    seeded init that train-vid starts from."""
    cfg, tcfg = flagship()
    cfg, tcfg = _f32(cfg), dataclasses.replace(tcfg, batch_size=TP_SP_BATCH)
    ts = vid.init_train_state(torch.Generator().manual_seed(seed), cfg,
                              tcfg, device=DEVICE)
    corpus = DeviceCorpus(synthetic_clips(TP_SP_BATCH, length=CLIP_LEN,
                                          size=CLIP_SIZE), device=DEVICE)
    frames = corpus.fold_sample_fn(corpus.data, torch.arange(
        TP_SP_BATCH, device=DEVICE))
    z = torch.rand(TP_SP_BATCH, cfg.z_input_size, device=DEVICE,
                   generator=torch.Generator(device=DEVICE).manual_seed(
                       seed)) * 2 - 1
    return cfg, tcfg, ts, frames, z


def _one_pass_grads(ts, frames, z, cfg, tcfg):
    """({"d": D-pass gradients, "g": G-pass gradients} summed over the
    ranks, the D pass's losses), from one state: no Adam update between
    them, so float32 rounding is not amplified by one."""
    d, m, _ = vid._d_grads(ts, frames, z, None, cfg, tcfg)
    g, _, _ = vid._g_grads(ts, z, None, cfg, tcfg)
    return ({"d": collectives.reduce_gradients(d, "opt_d",
                                               per_clip=("vid",)),
             "g": collectives.reduce_gradients(g, "opt_g")}, m)


def tp_sp_grads(argv):
    """A mesh_rank plan entry ["grads", OUT, SEED, mesh flags...]: one
    D pass's and one G pass's gradients of the seeded flagship state on
    that mesh (the steps' code, from _d_grads/_g_grads to
    reduce_gradients), the model blocks made whole; rank 0 saves them to
    OUT."""
    out, seed, flags = argv[1], int(argv[2]), argv[3:]
    ask = dict(zip(flags[::2], (int(v) for v in flags[1::2])))
    mesh = cli._mesh_arg(argparse.Namespace(
        data_parallel=ask.get("--data-parallel", 0),
        seq_parallel=ask.get("--seq-parallel", 1),
        tensor_parallel=ask.get("--tensor-parallel", 1)))
    cfg, tcfg, ts, frames, z = _grads_inputs(seed)
    sh = (ttp.vid_state_tp_shardings(mesh, ts, full=True)
          if mesh.shape[MODEL_AXIS] > 1 else None)
    ts = (tfsdp.place_state(ts, sh) if sh is not None
          else shard_train_state(mesh, ts))
    f_s, z_s = tsp.shard_vid_batch(mesh, frames, z)
    with collectives.use_mesh(mesh, seq=mesh.shape["seq"] > 1):
        grads, m = _one_pass_grads(ts, f_s, z_s, cfg, tcfg)
    flat_sh = flatten(sh) if sh is not None else {}
    whole = {}
    for role, tree in grads.items():
        for k, v in flatten(tree).items():
            s = flat_sh.get(f"opt_{role}/mu/{k}")
            whole[f"{role}/{k}"] = (v if s is None or s.dim is None else
                                    mesh.group(MODEL_AXIS).all_gather(
                                        v, s.dim)).cpu()
    if dist.get_rank() == 0:
        torch.save({"grads": whole,
                    "metrics": {k: float(v) for k, v in m.items()}}, out)


def grads_gap(got, want):
    """{net: the largest gradient gap over the net's leaves, divided by
    the net's largest gradient} ("d/vid", "g/vid", ...): a pre-BN bias,
    whose true gradient is 0, is held to the net's scale, not its own."""
    nets = collections.defaultdict(lambda: [0.0, 0.0])
    for k, w in want.items():
        net = "/".join(k.split("/")[:2])
        w = w.double()
        nets[net][0] = max(nets[net][0], float((got[k].double() - w).abs()
                                               .max()))
        nets[net][1] = max(nets[net][1], float(w.abs().max()))
    return {net: gap / scale for net, (gap, scale) in nets.items()}


def tp_block_shapes(cfg, tcfg, flags):
    """The shapes of the blocks a rank holds of the split leaves of a
    train-vid state on the mesh of `flags` (parallel/tp.py, full layout),
    counted: what the final checkpoint's gather over `model` all-gathers,
    once each."""
    ask = dict(zip(flags[::2], (int(v) for v in flags[1::2])))
    m = ask.get("--tensor-parallel", 1)
    if m == 1:
        return collections.Counter()
    mesh = make_mesh(list(range(TP_SP_RANKS)),
                     data_parallel=ask.get("--data-parallel", 0),
                     seq_parallel=ask.get("--seq-parallel", 1),
                     model_parallel=m)
    ts = vid.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg,
                              device="cpu")
    sh = flatten(ttp.vid_state_tp_shardings(mesh, ts, full=True))
    out = collections.Counter()
    for k, v in flatten(ts).items():
        if sh[k].dim is not None:
            shape = list(v.shape)
            shape[sh[k].dim] //= m
            out[tuple(shape)] += 1
    return out


def tp_sp_bytes(cfg, tcfg, batch, d, s, m):
    """What one train-vid step sends from a rank over each axis of a
    (d, s, m) mesh, counted from the activations' and the leaves' shapes:
    the tensor-parallel collectives of the image G and D, the vid-G MLP
    and the vid-D (ops/nn.py forms: all-gathers and all-reduces forward,
    reduce-scatters, all-gathers and all-reduces backward, the G passes
    differentiating through every net, the D pass through the vid-D's
    weights only), the seq gather of the tap before each vid-D call, and
    the gradient all-reduce over data of this rank's trainable floats.
    The BN moments, the loss sums and the BN vectors' gradients (a few KB)
    are left out."""
    img, f4 = cfg.image_gan, 4
    sz, gf, df, c = img.output_size, img.gf_dim, img.df_dim, img.c_dim
    rows, clips = batch * cfg.vid_length // (d * s), batch // d
    h, t8 = cfg.hidden_dim, (cfg.vid_length + 1) // 2
    px = lambda k: (sz // k) ** 2
    g_in = [px(16) * 8 * gf, px(8) * 4 * gf, px(4) * 2 * gf, px(2) * gf]
    g_out = g_in[1:] + [px(1) * c]
    d_in = [px(2) * df, px(4) * 2 * df]              # h1, h2 inputs
    tap = px(8) * 4 * df
    v_in = [t8 * px(16) * cfg.d_filters, (t8 + 1) // 2 * px(32)
            * cfg.d_filters]                           # vid-D h2, h3 inputs
    v_out = (t8 + 3) // 4 * px(64) * cfg.d_filters
    out = collections.Counter()
    if m > 1:
        img_g_fwd = rows * (g_in[0] / m + sum(g_out))
        img_g_bwd = rows * (sum(g_in) / m + cfg.z_output_size)
        img_d_fwd = rows * (sum(d_in) + tap) / m
        img_d_bwd = rows * (sum(d_in) + px(1) * c)
        vid_g_fwd = rows * (3 * h + cfg.z_output_size) / m
        vid_g_bwd = rows * 3 * h
        vid_d_fwd = clips * (sum(v_in) + v_out) / m
        vid_d_bwd = clips * sum(v_in)
        d_pass = (img_g_fwd + 2 * img_d_fwd + vid_g_fwd + 2 * vid_d_fwd
                  + 2 * vid_d_bwd)
        g_pass = (img_g_fwd + img_g_bwd + img_d_fwd + img_d_bwd + vid_g_fwd
                  + vid_g_bwd + vid_d_fwd + vid_d_bwd
                  + clips * cfg.vid_length * tap)
        out["model"] = f4 * (tcfg.disc_updates * d_pass
                             + tcfg.gen_updates * g_pass)
    if s > 1:
        out["seq"] = f4 * rows * tap * (2 * tcfg.disc_updates
                                        + tcfg.gen_updates)
    ts = vid.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg,
                              device="cpu")
    sh = flatten(ttp.vid_state_tp_shardings(make_mesh(
        list(range(d * s * m)), data_parallel=d, seq_parallel=s,
        model_parallel=m), ts, full=True)) if m > 1 else {}
    local = lambda pre: sum(
        v.numel() // (m if k in sh and sh[k].dim is not None else 1)
        for k, v in flatten(ts).items() if k.startswith(pre))
    # the vid-D's gradients over data, the vid-G's over (data, seq),
    # named as Mesh.collective_bytes names that group
    if d > 1:
        out["data"] += f4 * tcfg.disc_updates * local("params/vid_disc")
    frames = ("data+seq" if d > 1 and s > 1 else "data" if d > 1
              else "seq" if s > 1 else None)
    if frames:
        out[frames] += f4 * tcfg.gen_updates * local("params/vid_gen")
    return {k: int(v) for k, v in out.items()}


def phase_mesh_tp_sp(seed):
    """The seq and model axes: four gloo ranks sharing the card, started by
    torch.distributed.run, run train-vid through the CLI (mesh_rank) on
    each mesh of TP_SP_MESHES; the same command on one rank in this process
    is the reference. Returns the K1 launches of each run."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        train, plan = _tp_sp_plan(seed, workdir)
        plan_path = os.path.join(workdir, "plan.json")
        with open(plan_path, "w") as f:
            json.dump(plan, f)
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(TP_SP_RANKS),
             os.path.join(REPO, "chip_smoke.py"), "--mesh-rank", plan_path],
            cwd=REPO, timeout=MESH_TIMEOUT_S,
            env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
            text=True)
        if proc.returncode:
            print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
        check(proc.returncode == 0, f"the {TP_SP_RANKS} ranks exit 0 "
                                    f"(rc {proc.returncode})")
        say("mesh_tp_sp", ranks=TP_SP_RANKS,
            seconds=f"{time.perf_counter() - t:.1f}")
        reports = []
        for r in range(TP_SP_RANKS):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                reports.append(json.load(f))
        one = os.path.join(workdir, "one_rank")
        with exact_f32():
            reset_counts()
            t = time.perf_counter()
            cli.main(train + ["--run-dir", one])
            torch.cuda.synchronize()
            one_launches = read_counts()
        check(one_launches["gather_rows_scaled"] == TP_SP_STEPS,
              f"one rank: K1 once a step: {one_launches}")
        ref = _records(one)
        doc = load_config(os.path.join(one, "params.json"))
        cfg, tcfg = doc["model"], doc["train"]
        ms_one = [1e3 / r["steps_per_sec"] for r in ref[1:]]
        say("mesh_tp_sp", run="one_rank",
            seconds=f"{time.perf_counter() - t:.1f}",
            ms_per_step_warm_median=f"{float(np.median(ms_one)):.1f}",
            launches=one_launches)
        counts = {"one_rank": one_launches}
        keys = ("d_loss", "d_loss_real", "d_loss_fake", "g_loss",
                "first_frame_loss")
        gates = []
        # one rank's gradients, and the same with the clips in reverse
        # order: the same sums in another order, the float32 floor that
        # the mesh's gaps are held to
        whole = lambda g: {f"{role}/{k}": v.cpu() for role, tree in
                           g.items() for k, v in flatten(tree).items()}
        with exact_f32():
            gcfg, gtcfg, gts, frames, z = _grads_inputs(seed)
            ref_grads, ref_m = _one_pass_grads(gts, frames, z, gcfg, gtcfg)
            rev = torch.arange(TP_SP_BATCH - 1, -1, -1, device=DEVICE)
            rows = (rev[:, None] * gcfg.vid_length + torch.arange(
                gcfg.vid_length, device=DEVICE)).reshape(-1)
            rev_grads, _ = _one_pass_grads(gts, frames[rows], z[rev], gcfg,
                                           gtcfg)
        ref_grads = whole(ref_grads)
        floor = grads_gap(whole(rev_grads), ref_grads)
        say("mesh_tp_sp", run="one_rank_clips_reversed",
            grads_gap_by_net=json.dumps({k: float(f"{v:.3g}")
                                         for k, v in floor.items()}))
        for name, argv in plan:
            if name.startswith("grads_"):
                got = torch.load(argv[1], weights_only=False)
                gap = grads_gap(got["grads"], ref_grads)
                loss = max(abs(got["metrics"][k] - float(ref_m[k]))
                           for k in ("d_loss", "d_loss_real", "d_loss_fake"))
                bound = {k: max(TP_SP_GRAD_TOL, TP_SP_FLOOR_X * floor[k])
                         for k in gap}
                gates.append((all(gap[k] <= bound[k] for k in gap)
                              and loss <= MESH_CLI_TOL,
                              f"{name}: one D and one G pass's gradients "
                              f"{gap} within {bound} of each net's "
                              f"largest, D losses {loss}"))
                say("mesh_tp_sp", run=name, grads_gap_by_net=json.dumps(
                    {k: float(f"{v:.3g}") for k, v in gap.items()}),
                    d_loss_gap=f"{loss:.3g}")
                continue
            run_dir = os.path.join(workdir, name)
            blocks = tp_block_shapes(cfg, tcfg, TP_SP_MESHES[name])
            ask = dict(zip(argv[-len(TP_SP_MESHES[name])::2],
                           argv[-len(TP_SP_MESHES[name]) + 1::2]))
            axes = (int(ask.get("--data-parallel", 1)),
                    int(ask.get("--seq-parallel", 1)),
                    int(ask.get("--tensor-parallel", 1)))
            axes = (TP_SP_RANKS // (axes[1] * axes[2]),) + axes[1:]
            want_bytes = tp_sp_bytes(cfg, tcfg, TP_SP_BATCH, *axes)
            ckpt_bytes = 4 * sum(math.prod(k) * n for k, n in blocks.items())
            for r, rep in enumerate(reports):
                run = rep["runs"][name]
                counts[f"rank{r}_{name}"] = run["launches"]
                check(run["launches"]["gather_rows_scaled"] == TP_SP_STEPS,
                      f"rank {r} {name}: K1 once a step: {run['launches']}")
                weights = collections.Counter({
                    tuple(shape): n for shape, n in run["model_gathers"]
                    if tuple(shape) in blocks})
                check(weights == blocks, f"rank {r} {name}: the only "
                      f"weight-shaped gathers over model are the "
                      f"checkpoint's: {dict(weights)} vs {dict(blocks)}")
                # per step: every kind but the placement's broadcast, less
                # the checkpoint's gather over model
                per_step = {ax: (sum(v for k, v in kinds.items()
                                     if k != "broadcast")
                                 - (ckpt_bytes if ax == "model" else 0))
                            // TP_SP_STEPS
                            for ax, kinds in run["bytes"].items()
                            if set(kinds) != {"broadcast"}}
                say("mesh_tp_sp", run=name, rank=r,
                    bytes_per_step=json.dumps(per_step),
                    counted_bytes_per_step=json.dumps(want_bytes),
                    seconds=f"{run['seconds']:.2f}",
                    peak_bytes=run["peak_bytes"],
                    collective_bytes=json.dumps(run["bytes"]),
                    weight_gathers_in_steps=sum(weights.values())
                    - sum(blocks.values()), launches=run["launches"])
            got = _records(run_dir)
            check([r["step"] for r in got] == list(range(
                1, TP_SP_STEPS + 1)), f"{name}: one record a step (rank 0 "
                                      f"alone writes)")
            gaps = [max(abs(a[k] - b[k]) for k in keys)
                    for a, b in zip(got, ref)]
            first = {k: abs(got[0][k] - ref[0][k]) for k in keys}
            gates.append((max(first[k] for k in keys[:3]) <= MESH_CLI_TOL,
                          f"{name}: first step's D losses {first} within "
                          f"{MESH_CLI_TOL} of one rank"))
            check(all(math.isfinite(r[k]) for r in got for k in keys),
                  f"{name}: finite losses")
            # the checkpoint rank 0 wrote from the gathered state, restored
            # in this process, trains a step
            ck = os.path.join(run_dir, "checkpoints")
            check(ckpt.all_steps(ck) == [TP_SP_STEPS], f"{name}: the final "
                                                       f"checkpoint")
            _, ts = vid.load_vid_train_state(ck, device=DEVICE)
            corpus = DeviceCorpus(synthetic_clips(
                TP_SP_BATCH, length=cfg.vid_length,
                size=cfg.image_gan.output_size), device=DEVICE)
            frames = corpus.fold_sample_fn(corpus.data, torch.arange(
                TP_SP_BATCH, device=DEVICE))
            z = torch.rand(TP_SP_BATCH, cfg.z_input_size, device=DEVICE,
                           generator=torch.Generator(device=DEVICE)
                           .manual_seed(seed)) * 2 - 1
            with exact_f32():
                ts, m = vid.train_step(ts, frames, z, None, cfg, tcfg)
            check(int(ts.step) == TP_SP_STEPS + 1
                  and all(math.isfinite(float(v)) for v in m.values()),
                  f"{name}: its checkpoint restores and trains a step")
            ms = [1e3 / r["steps_per_sec"] for r in got[1:]]
            say("mesh_tp_sp", run=name, flags=" ".join(TP_SP_MESHES[name]),
                first_step_gaps=json.dumps({k: float(f"{v:.3g}")
                                            for k, v in first.items()}),
                loss_gap_by_step=",".join(f"{x:.3g}" for x in gaps),
                ms_per_step_warm_median=f"{float(np.median(ms)):.1f}",
                restored_step_d_loss=f"{float(m['d_loss']):.6f}")
    say("mesh_tp_sp", seconds=f"{time.perf_counter() - t0:.1f}")
    for ok, what in gates:
        check(ok, what)
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--capture", nargs="+", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-rank", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it runs on the card",
              file=sys.stderr)
        return 2
    if args.capture:
        return _capture(*args.capture)
    if args.mesh_rank:
        return mesh_rank(args.mesh_rank)
    t0 = time.perf_counter()
    smi = phase_card()
    phase_build()
    corpus = phase_corpus(args.seed)
    measured = {"gather_rows_scaled": phase_k1(corpus, args.seed)}
    measured["gather_rows_scaled"]["stills"] = phase_k1_stills(corpus,
                                                               args.seed)
    measured.update({"resize_normalize": phase_k2(args.seed),
                     "lk_refine": phase_k4(args.seed)})
    measured["lrelu"] = phase_lrelu(args.seed)
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
    new_paths = {"profile": {"train_step": phase_profile(args.seed)}}
    phase_bench(smi)
    # the workflow's runs stay for the eval phase
    wf_dir = tempfile.TemporaryDirectory()
    workdir = wf_dir.name
    measured["gather_rows_scaled"]["workflow_launches"] = \
        phase_workflow(args.seed, workdir, args.profile)
    phase_serve_int8(ts, cfg, args.seed, workdir,
                     os.path.join(workdir, "vid", "checkpoints"),
                     args.profile)
    phase_invert(args.seed, workdir,
                 os.path.join(workdir, "img", "checkpoints"), ts, cfg, smi,
                 args.profile)
    phase_recurrent(args.seed, workdir, smi, args.profile)
    launches = {"train": phase_train(ts, cfg, tcfg, corpus, args.seed)}
    with tempfile.TemporaryDirectory() as workdir:
        _, launches["prep"] = phase_prep(args.seed, workdir)
        detect_sets = phase_detect(xml, args.seed)
        crop_paths, launches["track"] = phase_track(xml, args.seed, workdir,
                                                        args.profile)
        launches["feed"] = phase_feed(ts, cfg, tcfg, crop_paths, args.seed,
                                      args.profile)
        t = time.perf_counter()
        new_paths["dataprep"] = phase_dataprep(
            xml, args.seed, workdir, detect_sets,
            os.path.join(workdir, "track_out"), args.profile)
        say("dataprep", seconds=f"{time.perf_counter() - t:.1f}")
    t = time.perf_counter()
    new_paths["eval"] = phase_eval(xml, args.seed, wf_dir.name, ts, cfg,
                                   args.profile)
    say("eval", seconds=f"{time.perf_counter() - t:.1f}")
    t = time.perf_counter()
    new_paths["serve_web"] = phase_serve_web(xml, args.seed, wf_dir.name)
    say("serve_web", seconds=f"{time.perf_counter() - t:.1f}")
    wf_dir.cleanup()
    cascade_dir.cleanup()
    new_paths["mesh"] = phase_mesh(args.seed)
    new_paths["mesh_tp_sp"] = phase_mesh_tp_sp(args.seed)

    line = []
    for k in KERNELS:
        row = {key: k[key] for key in ("name", "route", "source", "replaces",
                                       "path")}
        row["launches"] = launches[k["path"]][k["name"]]
        row.update(measured[k["name"]])
        for phase, steps in new_paths.items():
            row[f"launches_{phase}"] = {step: n[k["name"]]
                                        for step, n in steps.items()}
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
