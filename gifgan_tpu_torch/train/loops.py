"""Training loops (gifgan_tpu/train/loops.py): epochs, sample grids,
checkpoints, metrics, resume, on one device or on a mesh's data axis.

The reference's behaviours are kept: per-epoch data seeds (seed + start
step + epoch), the device-corpus id order (a numpy permutation per epoch,
full batches only, so the port and the JAX package visit the same ids for
a seed), K batches per `train_chunk`, the epoch-tail partial chunk trained
and not dropped, sample and checkpoint cadence by `_crossed`, resume from
the latest checkpoint with a stream that does not replay the first run's,
and the collapse controller's knobs restored from the metrics log. A chunk
of 1 is the per-step loop.

Differences, each by design: the random streams are torch's
(core/rng.py), the image grid is a PNG written by ops/image.py write_png
and the video grids are GIFs (data/native_gif.py), not mp4, since the
card's machine has no imaging library; the cadence is checked after every
chunk, the epoch-tail one too.

On a mesh (`mesh=`, core/mesh.py; the JAX branches of loops.py:160-178 and
:351-411) every rank runs the loop: it visits the same id permutation,
draws the same global z and noise, resumes from the same checkpoint, and
trains its rows of each batch through parallel/dp.py make_sharded_step,
K1 gathering its own ids on a device corpus. `fsdp=True` shards the state
(parallel/fsdp.py). The video GAN's mesh is also its parallelism request,
as in the JAX package: a model axis above 1 selects the full
tensor-parallel layout (parallel/tp.py: the weights and their Adam slots
split over `model`; refused with fsdp), a seq axis above 1 the
sequence-parallel step (parallel/sp.py: each clip's frames over `seq`,
K1 gathering each rank's block of its clips' frames). Sharded states are
gathered whole for checkpoints and grids, and a resume places the
restored state again. Only rank 0 writes params.json, the metrics log,
the grids and the checkpoints (core/checkpoint.py save_multihost).
"""

from __future__ import annotations

import inspect
import json
import os
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core import checkpoint as ckpt
from gifgan_tpu_torch.core.config import (DCGANConfig, RecurrentImageConfig,
                                          TrainConfig, VidGANConfig,
                                          save_config)
from gifgan_tpu_torch.core.mesh import AXIS_SETS, MODEL_AXIS, SEQ_AXIS
from gifgan_tpu_torch.core.metrics import MetricsLogger
from gifgan_tpu_torch.core.rng import PRNGSequence, uniform_z
from gifgan_tpu_torch.data.device import DeviceCorpus
from gifgan_tpu_torch.data.loader import PrefetchLoader
from gifgan_tpu_torch.data.video import write_gif
from gifgan_tpu_torch.models.prednet import PredNetConfig
from gifgan_tpu_torch.ops.image import (denorm_u8, inverse_transform,
                                        merge_grid, to_uint8, write_png)
from gifgan_tpu_torch.parallel import fsdp as fsdp_lib
from gifgan_tpu_torch.parallel import tp
from gifgan_tpu_torch.parallel.dp import make_sharded_step, shard_train_state
from gifgan_tpu_torch.parallel.sp import make_sp_step
from gifgan_tpu_torch.train import gan
from gifgan_tpu_torch.train import prednet as ptrain
from gifgan_tpu_torch.train import recurrent as rtrain
from gifgan_tpu_torch.train import vid as vid_train
from gifgan_tpu_torch.train.controller import CollapseController


def _resume_rngs(seed: int, start_step: int, device=None) -> PRNGSequence:
    """The stream of a run that starts at `start_step`: the step is folded
    into the seed, so a resumed run draws fresh z and noise instead of
    replaying what the steps before the checkpoint drew."""
    if start_step:
        return PRNGSequence(np.random.SeedSequence([seed, start_step]),
                            device)
    return PRNGSequence(seed, device)


def _epoch_iter(factory: Callable, epoch_seed: int) -> Iterator:
    """Call a data-iterator factory with the epoch's seed when it takes
    one, so shuffles differ across epochs and resume segments."""
    try:
        if len(inspect.signature(factory).parameters) >= 1:
            return factory(epoch_seed)
    except (TypeError, ValueError):
        pass
    return factory()


def _restore_controller(controller: CollapseController, metrics_path: str,
                        max_step: Optional[int] = None) -> None:
    """Replay the intervention events of a run's metrics log into a resumed
    controller, so it starts at the knob levels the run last trained at.
    Only events at or before `max_step` (the restored checkpoint's step):
    later ones belong to a lost tail that is about to be trained again."""
    try:
        with open(metrics_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("kind") == "auto_intervention" and (
                        max_step is None
                        or rec.get("step", max_step + 1) <= max_step):
                    controller.image_noise = rec["image_noise_std"]
                    controller.activation_noise = rec["activation_noise_std"]
                    controller.d_lr_scale = rec["d_lr_scale"]
    except OSError:
        pass


def _crossed(prev_step: int, step: int, every: int) -> bool:
    """True when [prev_step+1, step] holds a multiple of `every`: a chunk
    advances several steps and an epoch-tail chunk shifts the step off the
    multiples, so `step % every == 0` would stop firing."""
    return bool(every) and (step // every) > (prev_step // every)


def _save_grid(samples: torch.Tensor, rows: int, cols: int, path: str,
               from_range: str = "[-1,1]") -> None:
    """(N, s, s, c) samples -> a rows x cols PNG grid."""
    x = samples.detach().float()
    if from_range == "[-1,1]":
        x = inverse_transform(x)
    write_png(path, to_uint8(merge_grid(x, rows, cols)).cpu().numpy())


def cross_sample_z(rows: int, cols: int, z_in: int, z_out: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Face x expression grid: each row shares a face latent (dims :z_out),
    each column an expression latent (z_out:)."""
    face = rng.uniform(-1, 1, (rows, 1, z_out))
    face = np.repeat(face, cols, axis=1)
    expr = rng.uniform(-1, 1, (1, cols, z_in - z_out))
    expr = np.repeat(expr, rows, axis=0)
    return np.concatenate([face, expr], axis=2).reshape(rows * cols, z_in)


def _write_video_grid(videos, cols: int, path: str,
                      fps: float = 25.0) -> None:
    """(B, T, h, w, c) in [-1, 1] -> one GIF of the tiled videos; a short
    last row is padded with black tiles."""
    u8 = denorm_u8(videos)
    b, t, h, w, c = u8.shape
    cols = max(1, min(cols, b))
    rows = -(-b // cols)
    if rows * cols > b:
        pad = np.zeros((rows * cols - b, t, h, w, c), np.uint8)
        u8 = np.concatenate([u8, pad], axis=0)
    grid = u8.reshape(rows, cols, t, h, w, c)
    grid = grid.transpose(2, 0, 3, 1, 4, 5).reshape(t, rows * h, cols * w, c)
    if c == 1:
        grid = np.repeat(grid, 3, axis=-1)
    write_gif(path, grid, fps=fps)


def _to_device(batch, device: torch.device) -> torch.Tensor:
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    return torch.from_numpy(np.ascontiguousarray(batch)).to(device)


def _id_batches(n: int, batch_size: int, epoch_seed: int):
    """One epoch of a device corpus: one shuffled pass over the ids, full
    batches only (the reference drops the epoch tail too)."""
    perm = np.random.default_rng(epoch_seed).permutation(n)
    for i in range(n // batch_size):
        yield perm[i * batch_size:(i + 1) * batch_size]


def _corpus(u8: np.ndarray, item_shape: tuple, what: str, batch_size: int,
            device, **kw) -> DeviceCorpus:
    """A DeviceCorpus of (N, *item_shape) uint8, N >= batch_size; `kw` go
    to DeviceCorpus. `what` names the argument and the shape, e.g.
    "clips_u8 (N, vid_length, s, s, c)"."""
    if u8.ndim != len(item_shape) + 1 or u8.shape[1:] != item_shape:
        raise ValueError(f"{what} must have shape (N,) + {item_shape}, got "
                         f"{u8.shape}")
    corpus = DeviceCorpus(np.ascontiguousarray(u8), device=device, **kw)
    if corpus.n < batch_size:
        raise ValueError(f"{what.split()[0]} has {corpus.n} items < "
                         f"batch_size {batch_size}")
    return corpus


class _Loop:
    """What the loops share: run dir, stream, state restore and placement
    on the mesh, the pending chunk, the epoch walk, cadence and the final
    checkpoint. `step_chunk` trains the pending chunk; `on_chunk` logs it
    and writes samples. A z_dim of None draws no z (the recurrent GAN has
    no latent)."""

    def __init__(self, cfg, tcfg: TrainConfig, init_fn: Callable,
                 resume: bool, device, mesh=None, fsdp: bool = False,
                 fsdp_min_size: int = 2048):
        if fsdp and mesh is None:
            raise ValueError("fsdp=True requires a device mesh "
                             "(--data-parallel 0 or N, not 1)")
        if mesh is not None:
            mesh.group(AXIS_SETS[-1])     # its ranks' process group, or raise
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.primary = (mesh is None
                        or not torch.distributed.is_initialized()
                        or torch.distributed.get_rank() == 0)
        self.device = resolve_device(device)
        self.run_dir = tcfg.run_dir
        os.makedirs(self.run_dir, exist_ok=True)
        if self.primary:
            save_config({"model": cfg, "train": tcfg},
                        os.path.join(self.run_dir, "params.json"))
        self.rngs = PRNGSequence(tcfg.seed, self.device)
        self.ts = init_fn(torch.Generator().manual_seed(
            self.rngs.next_seed()), cfg, tcfg, device=self.device)
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints")
        self.resumed = resume and ckpt.latest_step(self.ckpt_dir) is not None
        if self.resumed:
            self.ts = ckpt.restore(self.ckpt_dir, self.ts)
            print(f"resumed from step {int(self.ts.step)}")
            self.rngs = _resume_rngs(tcfg.seed, int(self.ts.step),
                                     self.device)
        self.step = int(self.ts.step)
        self.fsdp, self.fsdp_min_size = fsdp, fsdp_min_size
        self.shardings = None

    def place(self, tensor_parallel: bool = False) -> None:
        """Lay the (restored or grafted) state out on the mesh: replicated,
        FSDP's blocks, or with tensor_parallel on a model axis the full
        tensor-parallel layout of a VidTrainState."""
        if self.mesh is None:
            return
        if self.fsdp:
            self.ts, self.shardings = fsdp_lib.place_and_shardings(
                self.mesh, self.ts, min_size=self.fsdp_min_size)
        elif tensor_parallel and self.mesh.shape[MODEL_AXIS] > 1:
            self.shardings = tp.vid_state_tp_shardings(self.mesh, self.ts,
                                                       full=True)
            self.ts = fsdp_lib.place_state(self.ts, self.shardings)
        else:
            self.ts = shard_train_state(self.mesh, self.ts)

    def stepper(self, fn: Callable, batch_axis: int,
                pass_knobs: bool = False, folded: Optional[bool] = None,
                **static) -> Callable:
        """fn(ts, *arrays, gen, [knobs=], **static) as call(ts, *arrays,
        gen[, knobs]) on the global arrays: sharded over the mesh when
        there is one (batch_axis: the arrays' batch axis). `folded` marks
        a video step (frames, or clip ids with folded=False), which a seq
        axis above 1 runs sequence-parallel."""
        if self.mesh is not None and folded is not None \
                and self.mesh.shape[SEQ_AXIS] > 1:
            return make_sp_step(fn, self.mesh, static_args=static,
                                batch_axis=batch_axis,
                                state_shardings=self.shardings,
                                pass_knobs=pass_knobs, folded=folded)
        if self.mesh is not None:
            return make_sharded_step(fn, self.mesh, static_args=static,
                                     batch_axis=batch_axis,
                                     state_shardings=self.shardings,
                                     pass_knobs=pass_knobs)
        if pass_knobs:
            return lambda ts, *a: fn(ts, *a[:-1], knobs=a[-1], **static)
        return lambda ts, *a: fn(ts, *a, **static)

    def full_state(self):
        """The whole train state (FSDP's or tensor parallelism's blocks
        gathered: every rank calls this together)."""
        return fsdp_lib.gather_state(self.ts, self.shardings)

    def run(self, batches_of_epoch: Callable[[int], Iterator], z_dim: int,
            batch_len: Callable, step_chunk: Callable, on_chunk: Callable,
            chunk: int, steps_limit: Optional[int]):
        tcfg = self.tcfg
        self.log = MetricsLogger(self.run_dir if self.primary else None,
                                 print_every=1 if self.primary else 0)
        saver = ckpt.AsyncCheckpointer(multihost=self.mesh is not None)
        start_step, pending, pending_z = self.step, [], []
        epoch = 0

        def flush():
            if not pending:
                return
            prev, k = self.step, len(pending)
            z = torch.stack(pending_z) if pending_z else None
            self.ts, metrics = step_chunk(self.ts, pending, z,
                                          self.rngs.next())
            pending.clear()
            pending_z.clear()
            self.step += k
            on_chunk(metrics, prev, epoch)
            if _crossed(prev, self.step, tcfg.checkpoint_every):
                saver.save(self.ckpt_dir, self.step, self.full_state(),
                           max_to_keep=tcfg.max_checkpoints_to_keep)

        done = lambda: bool(steps_limit) and self.step >= steps_limit
        try:
            for epoch in range(tcfg.epochs):
                batches = batches_of_epoch(tcfg.seed + start_step + epoch)
                try:
                    for batch in batches:
                        if z_dim is not None:
                            pending_z.append(uniform_z(
                                self.rngs.next(), (batch_len(batch), z_dim)))
                        pending.append(batch)
                        if len(pending) == chunk:
                            flush()
                            if done():
                                break
                finally:
                    if isinstance(batches, PrefetchLoader):
                        batches.close()
                flush()                       # the epoch-tail partial chunk
                if done():
                    break
            final = self.full_state()
            saver.save(self.ckpt_dir, self.step, final,
                       max_to_keep=tcfg.max_checkpoints_to_keep)
        finally:
            saver.close()
            self.log.close()
        return final

    def host_batches(self, factory: Callable) -> Callable[[int], Iterator]:
        """Epoch batches from a host iterator factory, uploaded to the
        device by the prefetch thread."""
        return lambda seed: PrefetchLoader(
            _epoch_iter(factory, seed),
            device_put=lambda b: _to_device(b, self.device))


def train_dcgan(images_iter: Optional[Callable[[], Iterator]],
                cfg: DCGANConfig, tcfg: TrainConfig, resume: bool = True,
                steps_limit: Optional[int] = None, chunk: int = 1,
                stills_u8: Optional[np.ndarray] = None,
                device=None, mesh=None, fsdp: bool = False,
                fsdp_min_size: int = 2048) -> gan.TrainState:
    """Train the image DCGAN; returns the final TrainState.

    images_iter: () or (epoch_seed) -> iterator of (B, s, s, c) float
    [-1, 1] batches (numpy or tensors), one pass an epoch.
    stills_u8: instead, an (N, s, s, c) uint8 corpus uploaded once; each
    step's batch is gathered on the device (K1 on the card) and the host
    ships ids only. chunk: batches per `train_chunk` call. mesh: train
    data-parallel on its data axis; fsdp: shard the state over it (leaves
    of at least fsdp_min_size elements)."""
    loop = _Loop(cfg, tcfg, gan.init_train_state, resume, device, mesh,
                 fsdp, fsdp_min_size)
    loop.place()
    s, c = cfg.output_size, cfg.c_dim
    corpus = None
    if stills_u8 is not None:
        corpus = _corpus(stills_u8, (s, s, c), "stills_u8 (N, s, s, c)",
                         tcfg.batch_size, loop.device, mesh=mesh)
        chunk_fn = loop.stepper(gan.train_chunk_ids, 1,
                                corpus_data=corpus.data, cfg=cfg, tcfg=tcfg,
                                sample_fn=corpus.sample_fn)
    else:
        chunk_fn = loop.stepper(gan.train_chunk, 1, cfg=cfg, tcfg=tcfg)
    sample_z = uniform_z(loop.rngs.next(), (64, cfg.z_dim))

    def step_chunk(ts, pending, z, gen):
        if corpus is not None:
            ids = torch.as_tensor(np.stack(pending), device=loop.device)
            return chunk_fn(ts, ids, z, gen)
        return chunk_fn(ts, torch.stack(pending), z, gen)

    def on_chunk(metrics, prev, epoch):
        loop.log.log(loop.step, {k: v[-1] for k, v in metrics.items()})
        if _crossed(prev, loop.step, tcfg.sample_every):
            full = loop.full_state()
            if loop.primary:
                _save_grid(gan.sample_step(full, sample_z, cfg), 8, 8,
                           os.path.join(loop.run_dir, f"train_{epoch:02d}_"
                                                      f"{loop.step:06d}.png"))

    batches = (
        (lambda seed: _id_batches(corpus.n, tcfg.batch_size, seed))
        if corpus is not None else loop.host_batches(images_iter))
    return loop.run(batches, cfg.z_dim, len, step_chunk, on_chunk, chunk,
                    steps_limit)


def train_vid_dcgan(clips_iter: Optional[Callable[[], Iterator]],
                    cfg: VidGANConfig, tcfg: TrainConfig,
                    image_gan_ckpt: Optional[str] = None,
                    resume: bool = True, steps_limit: Optional[int] = None,
                    chunk: int = 1, clips_u8: Optional[np.ndarray] = None,
                    auto_intervene: bool = False, device=None,
                    mesh=None, fsdp: bool = False,
                    fsdp_min_size: int = 2048) -> vid_train.VidTrainState:
    """Train the video GAN; returns the final VidTrainState.

    clips_iter: () or (epoch_seed) -> iterator of time-folded
    (B*T, s, s, c) float [-1, 1] batches (numpy or tensors).
    image_gan_ckpt: a train-dcgan run's checkpoints dir, grafted into the
    image nets of a fresh run (load_image_gan); a resumed run restores its
    own. clips_u8: an (N, T, s, s, c) uint8 corpus uploaded once, each
    step's clips gathered on the device (K1 on the card). auto_intervene:
    the collapse controller (train/controller.py) drives the noise and
    D-lr knobs from each chunk's d_loss; its events go to the metrics log,
    from which a resumed run restores the knob levels. mesh: train
    data-parallel on its data axis, each rank's clips gathered by K1 from
    its own ids, tensor-parallel on a model axis above 1 and
    sequence-parallel on a seq axis above 1 (the module docstring); fsdp:
    shard the state over the data axis (leaves of at least fsdp_min_size
    elements), not with a model axis."""
    if fsdp and mesh is not None and mesh.shape[MODEL_AXIS] > 1:
        raise ValueError("--fsdp and --tensor-parallel shard the train "
                         "state along different mesh axes; pick one")
    loop = _Loop(cfg, tcfg, vid_train.init_train_state, resume, device,
                 mesh, fsdp, fsdp_min_size)
    if not loop.resumed and image_gan_ckpt:
        loop.ts = vid_train.load_image_gan(loop.ts, image_gan_ckpt)
        if loop.primary:
            print(f"loaded frozen image GAN from {image_gan_ckpt}")
    loop.place(tensor_parallel=True)
    img = cfg.image_gan
    corpus = None
    if clips_u8 is not None:
        s = img.output_size
        corpus = _corpus(clips_u8, (cfg.vid_length, s, s, img.c_dim),
                         "clips_u8 (N, vid_length, s, s, c)",
                         tcfg.batch_size, loop.device, mesh=mesh)
        chunk_fn = loop.stepper(vid_train.train_chunk_ids, 1,
                                pass_knobs=auto_intervene, folded=False,
                                corpus_data=corpus.data, cfg=cfg, tcfg=tcfg,
                                sample_fn=corpus.fold_sample_fn)
    else:
        chunk_fn = loop.stepper(vid_train.train_chunk, 1,
                                pass_knobs=auto_intervene, folded=True,
                                cfg=cfg, tcfg=tcfg)

    controller, knobs = None, None
    if auto_intervene:
        controller = CollapseController(cfg.image_noise_std,
                                        cfg.activation_noise_std)
        if loop.resumed:
            _restore_controller(controller,
                                os.path.join(loop.run_dir,
                                             "train_metrics.jsonl"),
                                max_step=loop.step)
        knobs = vid_train.make_knobs(cfg, **controller.knob_values(),
                                     device=loop.device)

    np_rng = np.random.default_rng(tcfg.seed)
    b = tcfg.batch_size
    grids = [("sample", np_rng.uniform(-1, 1, (b, cfg.z_input_size)))]
    # rows are faces, columns expressions (8 expressions a face row)
    cross = cross_sample_z(max(1, b // 8), min(8, b), cfg.z_input_size,
                           cfg.z_output_size, np_rng)
    if cfg.first_frame_loss_scalar > 0:
        grids.append(("cross_sample", cross))
    grids = [(name, torch.as_tensor(z.astype(np.float32),
                                    device=loop.device))
             for name, z in grids]

    def step_chunk(ts, pending, z, gen):
        data = (torch.as_tensor(np.stack(pending), device=loop.device)
                if corpus is not None else torch.stack(pending))
        return chunk_fn(ts, data, z, gen, *([knobs] if auto_intervene
                                            else []))

    def on_chunk(metrics, prev, epoch):
        nonlocal knobs
        last = {k: v[-1] for k, v in metrics.items()}
        if controller is not None:
            last.update(controller.knob_values())
        scalars = loop.log.log(loop.step, last)
        if controller is not None:
            event = controller.observe(scalars["d_loss"])
            if event is not None:
                knobs = vid_train.make_knobs(cfg, **controller.knob_values(),
                                             device=loop.device)
                loop.log.log(loop.step, event)
                if loop.primary:
                    print(f"[train-vid] auto-intervention @step {loop.step}: "
                          f"{event['action']} -> "
                          f"noise={controller.image_noise} "
                          f"d_lr_scale={controller.d_lr_scale}", flush=True)
        if _crossed(prev, loop.step, tcfg.sample_every):
            full = loop.full_state()
            for name, z in grids if loop.primary else ():
                _write_video_grid(
                    vid_train.sample_videos(full, z, cfg), 8,
                    os.path.join(loop.run_dir,
                                 f"{name}_{epoch:02d}_{loop.step:06d}.gif"))

    if corpus is not None:
        batches = lambda seed: _id_batches(corpus.n, tcfg.batch_size, seed)
        batch_len = len
    else:
        batches = loop.host_batches(clips_iter)
        batch_len = lambda frames: frames.shape[0] // cfg.vid_length
    return loop.run(batches, cfg.z_input_size, batch_len, step_chunk,
                    on_chunk, chunk, steps_limit)


def train_recurrent(clips_iter: Optional[Callable[[], Iterator]],
                    cfg: RecurrentImageConfig, tcfg: TrainConfig,
                    resume: bool = True, allow_overwrite: bool = False,
                    steps_limit: Optional[int] = None,
                    clips_u8: Optional[np.ndarray] = None,
                    device=None) -> rtrain.RecurrentTrainState:
    """Train the recurrent_image GAN, one step a batch; returns the final
    RecurrentTrainState.

    clips_iter: () or (epoch_seed) -> iterator of (B, T+1, s, s, c) float
    [0, 1] batches. clips_u8: instead, an (N, T+1, s, s, c) uint8 corpus
    uploaded once and sampled on the device in [0, 1] (DeviceCorpus
    method "take": the gather kernel bakes the [-1, 1] scale); the host
    ships ids only. Refuses to reuse a checkpoint directory unless
    resuming or allow_overwrite. Every sample_every steps a GIF grid of the
    step's teacher-forced predictions, pred_<step>.gif."""
    ckpt_dir = os.path.join(tcfg.run_dir, "checkpoints")
    existing = ckpt.latest_step(ckpt_dir)
    if existing is not None and not resume and not allow_overwrite:
        raise RuntimeError(
            f"checkpoint dir {ckpt_dir} exists (step {existing}); pass "
            "resume=True or allow_overwrite=True")
    loop = _Loop(cfg, tcfg, rtrain.init_train_state, resume, device)
    corpus = None
    if clips_u8 is not None:
        s = cfg.image_size
        corpus = _corpus(clips_u8, (cfg.seq_length + 1, s, s, cfg.c_dim),
                         "clips_u8 (N, seq_length+1, s, s, c)",
                         tcfg.batch_size, loop.device, method="take",
                         out_range="unit")
    last = {}

    def step_chunk(ts, pending, z, gen):
        (batch,) = pending
        clips = (corpus.sample(torch.as_tensor(batch, device=loop.device))
                 if corpus is not None else batch)
        last["clips"] = clips
        return rtrain.train_step(ts, clips, gen, cfg, tcfg)

    def on_chunk(metrics, prev, epoch):
        loop.log.log(loop.step, metrics)
        if _crossed(prev, loop.step, tcfg.sample_every):
            preds = rtrain.predict(loop.ts, last["clips"], cfg)
            _write_video_grid(preds * 2.0 - 1.0, min(4, preds.shape[0]),
                              os.path.join(loop.run_dir,
                                           f"pred_{loop.step:06d}.gif"))

    batches = (
        (lambda seed: _id_batches(corpus.n, tcfg.batch_size, seed))
        if corpus is not None else loop.host_batches(clips_iter))
    return loop.run(batches, None, len, step_chunk, on_chunk, 1,
                    steps_limit)


def train_prednet(clips_iter: Optional[Callable[[], Iterator]],
                  cfg: PredNetConfig, tcfg: TrainConfig, resume: bool = True,
                  steps_limit: Optional[int] = None,
                  clips_u8: Optional[np.ndarray] = None,
                  device=None) -> ptrain.PredNetTrainState:
    """Train PredNet, one Adam update a batch; returns the final
    PredNetTrainState.

    clips_iter: (epoch_seed) -> iterator of (B, T, h, w, c) float [0, 1]
    batches. clips_u8: instead, an (N, T, h, w, c) uint8 corpus uploaded
    once and sampled on the device in [0, 1] (DeviceCorpus method "take");
    the host ships ids only. Resumes from the run's latest checkpoint
    when `resume`. Every sample_every steps a GIF grid of the step's
    predictions, pred_<step>.gif."""
    loop = _Loop(cfg, tcfg, ptrain.init_train_state, resume, device)
    corpus = None
    if clips_u8 is not None:
        h, w = cfg.hw()
        corpus = _corpus(clips_u8, (*clips_u8.shape[1:2], h, w, cfg.c_dim),
                         "clips_u8 (N, T, h, w, c)", tcfg.batch_size,
                         loop.device, method="take", out_range="unit")
    last = {}

    def step_chunk(ts, pending, z, gen):
        (last["batch"],) = pending
        if corpus is not None:
            ids = torch.as_tensor(last["batch"], device=loop.device)
            return ptrain.train_step_ids(ts, ids, corpus.sample, cfg, tcfg)
        return ptrain.train_step(ts, last["batch"], cfg, tcfg)

    def on_chunk(metrics, prev, epoch):
        loop.log.log(loop.step, metrics)
        if _crossed(prev, loop.step, tcfg.sample_every):
            batch = last["batch"]
            clips = corpus.sample(batch) if corpus is not None else batch
            preds = ptrain.predict(loop.ts, clips, cfg)
            _write_video_grid(preds * 2.0 - 1.0, min(4, preds.shape[0]),
                              os.path.join(loop.run_dir,
                                           f"pred_{loop.step:06d}.gif"))

    batches = (
        (lambda seed: _id_batches(corpus.n, tcfg.batch_size, seed))
        if corpus is not None else loop.host_batches(clips_iter))
    return loop.run(batches, None, len, step_chunk, on_chunk, 1,
                    steps_limit)
