"""GAN inversion (gifgan_tpu/invert/optimize.py): optimize the latent z
against a frozen generator and discriminator.

Four variants, as in the reference:

  - image inversion, one z per image;
  - whole-video joint: one z per frame of a time-folded clip batch;
  - whole-video iterative: frame by frame with warm starts;
  - nested: the VID_DCGAN video latent, so that generated frame 0 matches a
    target image.

Loss = the normalized weighted sum of pixel L1/L2, D-activation (h2 tap)
L1/L2 and the generator loss, each a mean per sample, then a mean over the
batch. A term whose weight is 0 is not computed. Adam(b1 0.5, b2 0.999,
eps 1e-8, optax's eps placement: train/gan.py Adam) moves z only; the step
size decays by `lr_decay_factor` every `lr_decay_every` steps (a
staircase, read at the step's count before its increment, as optax does).

The JAX package runs each chunk of steps as one `lax.scan`; here a chunk is
an eager loop whose losses stay on the device until the chunk ends. Only z
carries a gradient: the model tensors are plain tensors, so autograd
computes no weight gradient. z0 is drawn U[-1, 1) from a torch generator
seeded by an int (`initial_z`), not from a threefry key.

`mesh=` (core/mesh.py) runs an inversion data-parallel, as the JAX
package's `shard_problem` does: each rank holds its rows of the targets,
their activations and z (the model whole on every rank), the loss's batch
mean covers the whole batch (parallel/collectives.py), and `invert`
returns the whole z, gathered from the ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core.config import (DCGANConfig, InvertConfig,
                                          VidGANConfig)
from gifgan_tpu_torch.core.rng import uniform_z
from gifgan_tpu_torch.models import dcgan, vid_dcgan
from gifgan_tpu_torch.ops import nn
from gifgan_tpu_torch.parallel import collectives
from gifgan_tpu_torch.train.gan import Adam, AdamState

Tensor = torch.Tensor


class InversionProblem(NamedTuple):
    """One inversion: loss_fn(z) -> (scalar loss, generated images), with
    the model and targets bound in, for z of `z_shape` on `device`.
    `group`: the data group of a problem placed by `shard_problem` (its
    loss_fn then reads this rank's rows), None on one device."""
    loss_fn: Callable[[Tensor], Tuple[Tensor, Tensor]]
    z_shape: Tuple[int, ...]
    device: torch.device
    group: Optional[collectives.DataGroup] = None


def normalized_weights(icfg: InvertConfig) -> Dict[str, float]:
    w = {
        "pixel_l1": icfg.pixel_l1,
        "pixel_l2": icfg.pixel_l2,
        "activation_l1": icfg.activation_l1,
        "activation_l2": icfg.activation_l2,
        "generator_loss": icfg.generator_loss,
    }
    total = sum(w.values())
    if total <= 0:
        raise ValueError("at least one loss weight must be positive")
    return {k: v / total for k, v in w.items()}


def _per_sample_mean(d: Tensor) -> Tensor:
    return torch.mean(d, dim=tuple(range(1, d.ndim)))


def _weighted_loss(gen_images, gen_acts, gen_logits, targets, target_acts,
                   w) -> Tensor:
    """The weighted terms, each a per-sample mean and then a mean over the
    logical batch (over the ranks of a sharded problem)."""
    loss = 0.0
    if w["pixel_l1"]:
        loss = loss + w["pixel_l1"] * collectives.mean(
            _per_sample_mean(torch.abs(gen_images - targets)))
    if w["pixel_l2"]:
        loss = loss + w["pixel_l2"] * collectives.mean(
            _per_sample_mean(torch.square(gen_images - targets)))
    if w["activation_l1"]:
        loss = loss + w["activation_l1"] * collectives.mean(
            _per_sample_mean(torch.abs(gen_acts - target_acts)))
    if w["activation_l2"]:
        loss = loss + w["activation_l2"] * collectives.mean(
            _per_sample_mean(torch.square(gen_acts - target_acts)))
    if w["generator_loss"]:
        loss = loss + w["generator_loss"] * nn.sigmoid_ce(
            gen_logits, torch.ones_like(gen_logits))
    return loss


def _uses_acts(w) -> bool:
    return bool(w["activation_l1"] or w["activation_l2"])


def _discriminate(d_params, d_state, x, cfg: DCGANConfig, train: bool, w
                  ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """(logits, h2 tap), each None where no loss term reads it: the layers
    after the tap run only for a generator-loss term, the discriminator
    not at all for pixel terms alone."""
    if w["generator_loss"]:
        logits, acts, _ = dcgan.discriminator(d_params, d_state, x, cfg,
                                              train=train)
        return logits, acts
    if _uses_acts(w):
        acts, _ = dcgan.discriminator_tap(d_params, d_state, x, cfg,
                                          train=train)
        return None, acts
    return None, None


def target_activations(params, state, targets: Tensor, cfg: DCGANConfig,
                       train_mode: bool = False) -> Tensor:
    """The D h2 tap of the targets, computed once."""
    with torch.no_grad():
        acts, _ = dcgan.discriminator_tap(
            params["discriminator"], state["discriminator"], targets, cfg,
            train=train_mode)
    return acts


def _image_loss(z, params, state, targets, t_acts, cfg, w, train_mode):
    imgs, _ = dcgan.generator(params["generator"], state["generator"], z,
                              cfg, train=train_mode)
    logits, acts = _discriminate(params["discriminator"],
                                 state["discriminator"], imgs, cfg,
                                 train_mode, w)
    return _weighted_loss(imgs, acts, logits, targets, t_acts, w), imgs


def _as_tensor(x, device) -> Tensor:
    """A tensor on `device` (moved where it lies elsewhere), or a float32
    copy of array data."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def image_problem(params, state, targets, cfg: DCGANConfig,
                  icfg: InvertConfig, device=None) -> InversionProblem:
    """Invert targets (B, s, s, c) in [-1, 1] with one z per image. The
    model and the targets go to `device` (None: the card)."""
    device = resolve_device(device)
    params, state = dcgan.to_device(params, device), dcgan.to_device(
        state, device)
    targets = _as_tensor(targets, device)
    w = normalized_weights(icfg)
    train_mode = icfg.use_train_mode_activations
    t_acts = (target_activations(params, state, targets, cfg, train_mode)
              if _uses_acts(w) else None)
    return InversionProblem(
        functools.partial(_image_loss, params=params, state=state,
                          targets=targets, t_acts=t_acts, cfg=cfg, w=w,
                          train_mode=train_mode),
        (targets.shape[0], cfg.z_dim), device)


def nested_first_frame_problem(params, state, targets, cfg: VidGANConfig,
                               icfg: InvertConfig, device=None
                               ) -> InversionProblem:
    """Invert the VIDEO latent so that generated frame 0 of each video
    matches its target image; pixel and activation terms on every T-th
    frame."""
    device = resolve_device(device)
    params, state = dcgan.to_device(params, device), dcgan.to_device(
        state, device)
    targets = _as_tensor(targets, device)
    w = normalized_weights(icfg)
    train_mode = icfg.use_train_mode_activations
    t_acts = (target_activations(
        {"discriminator": params["img_discriminator"]},
        {"discriminator": state["img_discriminator"]}, targets,
        cfg.image_gan, train_mode) if _uses_acts(w) else None)
    return InversionProblem(
        functools.partial(_nested_first_frame_loss, params=params,
                          state=state, targets=targets, t_acts=t_acts,
                          cfg=cfg, w=w, train_mode=train_mode),
        (targets.shape[0], cfg.z_input_size), device)


def _nested_first_frame_loss(z, params, state, targets, t_acts, cfg, w,
                             train_mode):
    frames, _, _, _ = vid_dcgan.generate_videos(params, state, z, cfg,
                                                train=train_mode)
    logits, acts = _discriminate(
        params["img_discriminator"], state["img_discriminator"], frames,
        cfg.image_gan, train_mode, w)
    t = cfg.vid_length
    # pixel/activation losses on frame 0 only, the generator-loss term over
    # ALL frames (the reference's whole-video g_loss)
    loss = _weighted_loss(frames[::t], None if acts is None else acts[::t],
                          None, targets, t_acts,
                          {**w, "generator_loss": 0.0})
    if w["generator_loss"]:
        loss = loss + w["generator_loss"] * nn.sigmoid_ce(
            logits, torch.ones_like(logits))
    return loss, frames


def _learning_rate(icfg: InvertConfig, step: int) -> float:
    """The step size of 0-based `step`, in float32 as optax computes it:
    lr * factor ** (step // every) with a staircase decay, else lr."""
    if icfg.lr_decay_every > 0 and icfg.lr_decay_factor != 1.0:
        p = np.float32(step // icfg.lr_decay_every)
        return float(np.float32(icfg.learning_rate)
                     * np.float32(icfg.lr_decay_factor) ** p)
    return icfg.learning_rate


def _make_opt(icfg: InvertConfig, step: int) -> Adam:
    return Adam(_learning_rate(icfg, step), b1=0.5, b2=0.999, eps=1e-8)


def _in_group(problem: InversionProblem):
    """The context of a sharded problem's loss (parallel/collectives.py)."""
    return (contextlib.nullcontext() if problem.group is None
            else collectives.use(problem.group))


def shard_problem(problem: InversionProblem, mesh, z0: Optional[Tensor] = None
                  ) -> Tuple[InversionProblem, Optional[Tensor]]:
    """Place an inversion problem for data-parallel execution: the model
    whole on every rank, this rank's rows of the batch arrays (targets,
    target activations, z0). The loss then runs in the mesh's data group,
    so its batch mean is the whole batch's."""
    group = mesh.data_group
    n_data = mesh.shape["data"]
    b = problem.z_shape[0]
    if b % n_data:
        raise ValueError(
            f"the mesh data axis ({n_data}) must divide the inversion "
            f"batch ({b}); pad the batch (z_finder already pads partial "
            f"batches) or shrink the mesh")
    # both problem kinds bind (targets, t_acts) by keyword; a new kind with
    # other batch arrays must extend this placement
    fn = problem.loss_fn
    kw = dict(fn.keywords, targets=group.rows(fn.keywords["targets"]))
    if kw["t_acts"] is not None:
        kw["t_acts"] = group.rows(kw["t_acts"])
    problem = problem._replace(
        loss_fn=functools.partial(fn.func, *fn.args, **kw),
        z_shape=(b // n_data,) + tuple(problem.z_shape[1:]), group=group)
    if z0 is not None:
        z0 = group.rows(_as_tensor(z0, problem.device))
    return problem, z0


def _run_chunk(problem: InversionProblem, z: Tensor, opt_state: AdamState,
               icfg: InvertConfig, first_step: int, n_steps: int,
               ) -> Tuple[Tensor, AdamState, np.ndarray]:
    """n_steps of Adam on z, steps first_step.. of the schedule. Each
    step's loss stays on the device; the chunk's come to the host once."""
    losses = []
    for step in range(first_step, first_step + n_steps):
        zg = z.detach().requires_grad_(True)
        with torch.enable_grad(), _in_group(problem):
            loss, _ = problem.loss_fn(zg)
            (grad,) = torch.autograd.grad(loss, zg)
        updates, opt_state = _make_opt(icfg, step).update({"z": grad},
                                                          opt_state)
        z = z + updates["z"]
        losses.append(loss.detach())
    return z, opt_state, torch.stack(losses).float().cpu().numpy()


def initial_z(shape, seed: int, device) -> Tensor:
    """z0 ~ U[-1, 1) of `shape` on `device`, from a torch generator seeded
    with `seed` (the JAX package draws from a threefry key)."""
    return uniform_z(torch.Generator(device=device).manual_seed(seed), shape)


def invert(problem: InversionProblem, icfg: InvertConfig, seed: int = 0,
           z0: Optional[Tensor] = None,
           progress_sections: Optional[List[Tuple[int, int]]] = None,
           mesh=None) -> Tuple[Tensor, np.ndarray, List[np.ndarray]]:
    """Run the optimization: (z, loss history, progress frames).

    progress_sections: [(start_step, every)], the progress video's
    capture schedule, e.g. [(0, 1), (50, 5)]: every step early, sparser
    later. A chunk ends at each captured step; the last frames are added
    whenever any capture is asked for. mesh: shard the z batch and the
    problem's batch arrays over the mesh's data axis (`shard_problem`);
    z and the frames come back whole on every rank."""
    if z0 is None:
        z0 = initial_z(problem.z_shape, seed, problem.device)
    if mesh is not None:
        problem, z0 = shard_problem(problem, mesh, z0)
    z = _as_tensor(z0, problem.device)
    opt_state = Adam(icfg.learning_rate).init({"z": z})

    capture = _capture_steps(icfg.steps, progress_sections)
    losses: List[np.ndarray] = []
    frames: List[np.ndarray] = []
    step = 0
    boundaries = sorted(capture) + [icfg.steps]
    # dedupe + drop 0-length chunks
    chunk_plan: List[int] = []
    prev = 0
    for b in boundaries:
        if b > prev:
            chunk_plan.append(b - prev)
            prev = b
    if prev == 0:
        chunk_plan = [icfg.steps]

    for n in chunk_plan:
        if step in capture:
            frames.append(_frames(problem, z))
        z, opt_state, chunk_losses = _run_chunk(problem, z, opt_state, icfg,
                                                step, n)
        losses.append(chunk_losses)
        step += n
    if step in capture or capture:
        frames.append(_frames(problem, z))
    if problem.group is not None:
        z = problem.group.all_gather(z, 0)
    return z, np.concatenate(losses) if losses else np.zeros(0), frames


def _frames(problem: InversionProblem, z: Tensor) -> np.ndarray:
    with torch.no_grad(), _in_group(problem):
        _, imgs = problem.loss_fn(z)
    if problem.group is not None:
        imgs = problem.group.all_gather(imgs, 0)
    return imgs.float().cpu().numpy()


def _capture_steps(total: int, sections) -> set:
    if not sections:
        return set()
    sections = [list(s) for s in sections]
    sections[0][0] = 0  # the first section always starts at 0
    out = set()
    for i in range(total):
        start, every = sections[0]
        for s, e in sections[1:]:
            if s <= i:
                start, every = s, e
        if (i - start) % every == 0:
            out.add(i)
    return out


# ---------------------------------------------------------------------------
# the four reference variants
# ---------------------------------------------------------------------------

def invert_images(params, state, targets, cfg: DCGANConfig,
                  icfg: InvertConfig, seed: int = 0, progress_sections=None,
                  device=None, z0=None, mesh=None):
    """z0: the starting latents (B, z_dim); None draws them from `seed`."""
    return invert(image_problem(params, state, targets, cfg, icfg, device),
                  icfg, seed=seed, z0=z0, progress_sections=progress_sections,
                  mesh=mesh)


def invert_video_joint(params, state, video_frames, cfg: DCGANConfig,
                       icfg: InvertConfig, seed: int = 0, device=None,
                       mesh=None):
    """One z per frame, jointly optimized: video_frames is time-folded
    (V*T, s, s, c) and inverted like a batch of images."""
    return invert(image_problem(params, state, video_frames, cfg, icfg,
                                device), icfg, seed=seed, mesh=mesh)


def invert_video_iterative(params, state, video_frames, cfg: DCGANConfig,
                           icfg: InvertConfig, num_initial_steps: int = 500,
                           num_steps_per_frame: int = 100, seed: int = 0,
                           post_initial_lr_decay: float = 0.9, device=None,
                           mesh=None) -> np.ndarray:
    """One z per VIDEO, frame by frame with warm starts:
    `num_initial_steps` on frame 0 at the full rate, then
    `num_steps_per_frame` on EVERY frame (frame 0 included) at lr *
    post_initial_lr_decay, each from the previous frame's z with a fresh
    Adam state. video_frames (V, T, s, s, c); returns the z trajectory
    (T, V, z_dim) as numpy."""
    if video_frames.ndim != 5:
        raise ValueError("pass (V, T, s, s, c)")
    device = resolve_device(device)
    video_frames = _as_tensor(video_frames, device)
    v, t = video_frames.shape[:2]

    init_cfg = dataclasses.replace(icfg, steps=num_initial_steps,
                                   batch_size=v)
    z, _, _ = invert(image_problem(params, state, video_frames[:, 0], cfg,
                                   init_cfg, device), init_cfg, seed=seed,
                     mesh=mesh)

    frame_cfg = dataclasses.replace(
        icfg, steps=num_steps_per_frame,
        learning_rate=icfg.learning_rate * post_initial_lr_decay,
        batch_size=v)
    zs = []
    for frame in range(t):
        problem = image_problem(params, state, video_frames[:, frame], cfg,
                                frame_cfg, device)
        z, _, _ = invert(problem, frame_cfg, z0=z, mesh=mesh)
        zs.append(z.cpu().numpy())
    return np.stack(zs)  # (T, V, z_dim)


def invert_nested_first_frame(params, state, targets, cfg: VidGANConfig,
                              icfg: InvertConfig, seed: int = 0,
                              device=None, mesh=None):
    return invert(nested_first_frame_problem(params, state, targets, cfg,
                                             icfg, device), icfg, seed=seed,
                  mesh=mesh)


def apply_latent_path(params, state, z, path, cfg: DCGANConfig,
                      device=None) -> Tensor:
    """Animate latents z (B, z_dim) along a path (T, z_dim), applied as
    deltas from the path's first entry: (T, B, s, s, c) frames, one
    inference-mode generator call a path step."""
    device = resolve_device(device)
    params, state = dcgan.to_device(params, device), dcgan.to_device(
        state, device)
    z = _as_tensor(z, device)
    path = _as_tensor(path, device)
    with torch.no_grad():
        return torch.stack([
            dcgan.generator(params["generator"], state["generator"],
                            z + delta, cfg, train=False)[0]
            for delta in path - path[0]])


def broadcast_z_forward(zs: Tensor, from_frame: int, vid_length: int
                        ) -> Tensor:
    """Copy frame `from_frame`'s latent forward to all later frames of each
    video. zs is time-folded (V*T, z_dim)."""
    v = zs.shape[0] // vid_length
    z3 = zs.reshape(v, vid_length, -1)
    src = z3[:, from_frame:from_frame + 1, :]
    t_idx = torch.arange(vid_length, device=zs.device)[None, :, None]
    return torch.where(t_idx >= from_frame, src, z3).reshape(zs.shape)


def tween_z(z_a: Tensor, z_b: Tensor, steps: int) -> Tensor:
    """Linear z interpolation: (steps, *z.shape) for z of any rank."""
    w = torch.linspace(0.0, 1.0, steps, device=z_a.device).reshape(
        (steps,) + (1,) * z_a.ndim)
    return z_a[None] * (1 - w) + z_b[None] * w
