"""VID_DCGAN training and sampling (gifgan_tpu/train/vid.py, and the run-dir
loader of gifgan_tpu/cli.py:326-342).

Semantics, as in the JAX package:

- Fake path: vid-G in TRAIN mode -> image G in INFERENCE mode -> image
  noise -> image D in INFERENCE mode, h2 tap -> activation noise.
- Real path: image noise on the frames -> image D h2 tap (inference) ->
  activation noise.
- The vid-D BN always uses batch statistics. In the D step its state chains
  real -> fake and is kept; in the G step it is discarded.
- Only the trainable partition is differentiated and updated: the vid nets,
  plus the image G / image D when tcfg.train_img_gen / train_img_disc.
- Loss: sigmoid CE, plus first_frame_loss_scalar * first-frame MSE for G.

`lax.scan` becomes a Python loop (train_chunk, train_chunk_ids); autograd
replaces jax.value_and_grad. On a mesh (parallel/dp.py make_sharded_step,
parallel/sp.py make_sp_step) the steps run on this rank's rows: the
frames' over the (data, seq) composite, the clips' (z, the vid-D's
logits and its loss) over data. The gradients are summed over the ranks
between each `_x_grads` and its optimizer update
(parallel/collectives.py reduce_gradients): over (data, seq) for the
nets that run on frames, over data alone for the vid-D, which every seq
rank runs alike. Under FSDP the state holds this rank's blocks, gathered
where a pass reads them; under tensor parallelism (parallel/tp.py) it
holds this rank's blocks of the weights and their Adam slots, which the
layers use as they are (ops/nn.py). Noise draws come from an explicit
torch.Generator on the tensors' device, at the global shape, each rank
keeping its rows; torch's generator cannot match threefry, so the parity
tests against the JAX package run at noise 0.

Spans (core/profile.py span), recorded only while a torch.profiler
session records: `vid.step` a step; `vid.vid_g`, `vid.img_g`,
`vid.img_d_tap` and `vid.vid_d` each net's forward call; `vid.loss`,
`vid.backward` and `vid.optimizer` an update's loss terms, `_grads` and
Adam; inside `vid.backward`, `<net>.bwd` from the arrival of the
gradient of each net's output to the next net's.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core import checkpoint as ckpt
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core import profile
from gifgan_tpu_torch.core.config import TrainConfig, VidGANConfig, load_config
from gifgan_tpu_torch.core.rng import PRNGSequence, uniform_z
from gifgan_tpu_torch.models import dcgan, vid_dcgan
from gifgan_tpu_torch.ops import nn, quant
from gifgan_tpu_torch.parallel import collectives
from gifgan_tpu_torch.train.gan import (Adam, AdamState, _differentiable,
                                        _grads, _stack, apply_updates,
                                        make_optimizer, scale_updates)

Tensor = torch.Tensor


class VidTrainState(NamedTuple):
    params: Dict          # {"vid_generator", "vid_discriminator",
    state: Dict           #  "img_generator", "img_discriminator"}
    opt_g: AdamState
    opt_d: AdamState
    step: Tensor          # int32 scalar

    @classmethod
    def from_tree(cls, tree: Dict) -> "VidTrainState":
        """From the nested dicts of core/interop.from_jax_flat."""
        return cls(params=tree["params"], state=tree["state"],
                   opt_g=AdamState(**tree["opt_g"]),
                   opt_d=AdamState(**tree["opt_d"]), step=tree["step"])


class Knobs(NamedTuple):
    """Runtime training knobs as float32 tensor scalars: a value change
    never changes the code path (a tensor noise std always draws)."""
    image_noise_std: Tensor
    activation_noise_std: Tensor
    d_lr_scale: Tensor          # multiplies the D update (Adam is lr-linear)


def make_knobs(cfg: VidGANConfig, image_noise_std=None,
               activation_noise_std=None, d_lr_scale=1.0,
               device=None) -> Knobs:
    """Knobs on `device`, defaulting to cfg's noise levels."""
    device = resolve_device(device)
    img = cfg.image_noise_std if image_noise_std is None else image_noise_std
    act = (cfg.activation_noise_std if activation_noise_std is None
           else activation_noise_std)
    f = lambda v: torch.tensor(float(v), dtype=torch.float32, device=device)
    return Knobs(f(img), f(act), f(d_lr_scale))


def _g_trainable(params: Dict, tcfg: TrainConfig) -> Dict:
    t = {"vid": params["vid_generator"]}
    if tcfg.train_img_gen:
        t["img"] = params["img_generator"]
    return t


def _d_trainable(params: Dict, tcfg: TrainConfig) -> Dict:
    t = {"vid": params["vid_discriminator"]}
    if tcfg.train_img_disc:
        t["img"] = params["img_discriminator"]
    return t


def init_train_state(gen: torch.Generator, cfg: VidGANConfig,
                     tcfg: TrainConfig, device=None) -> VidTrainState:
    """Fresh state on `device`; weights drawn on the CPU from `gen`."""
    device = resolve_device(device)
    params, state = vid_dcgan.init(gen, cfg, device)
    opt = make_optimizer(tcfg)
    return VidTrainState(
        params=params, state=state,
        opt_g=opt.init(_g_trainable(params, tcfg)),
        opt_d=opt.init(_d_trainable(params, tcfg)),
        step=torch.zeros((), dtype=torch.int32, device=device))


def _noise_stds(cfg: VidGANConfig, knobs: Optional[Knobs]):
    if knobs is None:
        return cfg.image_noise_std, cfg.activation_noise_std
    return knobs.image_noise_std, knobs.activation_noise_std


def _fake_activations(params, state, z, cfg: VidGANConfig, gen,
                      knobs=None):
    """vid-G(train) -> img-G(inference) -> noise -> img-D(inference) h2 tap
    -> noise. Returns (acts, g_out, vid-G state, pre-noise act std)."""
    img_std, act_std = _noise_stds(cfg, knobs)
    with profile.span("vid.vid_g") as s:
        g_out, vid_gs = vid_dcgan.vid_generator(
            params["vid_generator"], state["vid_generator"], z, cfg,
            train=True)
        s.mark(g_out)
    with profile.span("vid.img_g") as s:
        frames, _ = dcgan.generator(params["img_generator"],
                                    state["img_generator"], g_out,
                                    cfg.image_gan, train=False)
        s.mark(frames)
    frames = nn.add_noise(gen, frames, img_std)
    with profile.span("vid.img_d_tap") as s:
        acts, _ = dcgan.discriminator_tap(params["img_discriminator"],
                                          state["img_discriminator"],
                                          frames, cfg.image_gan,
                                          train=False)
        s.mark(acts)
    pre_noise_std = nn.get_std(acts.reshape(acts.shape[0], -1))
    return nn.add_noise(gen, acts, act_std), g_out, vid_gs, pre_noise_std


def _real_activations(params, state, frames, cfg: VidGANConfig, gen,
                      knobs=None):
    img_std, act_std = _noise_stds(cfg, knobs)
    noisy = nn.add_noise(gen, frames, img_std)
    with profile.span("vid.img_d_tap") as s:
        acts, _ = dcgan.discriminator_tap(params["img_discriminator"],
                                          state["img_discriminator"], noisy,
                                          cfg.image_gan, train=False)
        s.mark(acts)
    pre_noise_std = nn.get_std(acts.reshape(acts.shape[0], -1))
    return nn.add_noise(gen, acts, act_std), pre_noise_std


def _d_grads(ts: VidTrainState, frames: Tensor, z: Tensor, gen,
             cfg: VidGANConfig, tcfg: TrainConfig,
             knobs: Optional[Knobs] = None) -> Tuple[Dict, Dict, Dict]:
    """(grads of the D loss over the D-trainable tree, metrics, new vid-D
    BN state — chained real -> fake). Under FSDP the params and state are
    all-gathered first (parallel/collectives.py gather)."""
    full = collectives.gather(ts.params, "params")
    state = collectives.gather(ts.state, "state")
    keys, leaves, tr = _differentiable(_d_trainable(full, tcfg))
    params = dict(full, vid_discriminator=tr["vid"])
    if "img" in tr:
        params["img_discriminator"] = tr["img"]
    with torch.enable_grad():
        real_acts, real_std = _real_activations(params, state, frames,
                                                cfg, gen, knobs)
        fake_acts, _, _, fake_std = _fake_activations(params, state, z,
                                                      cfg, gen, knobs)
        with profile.span("vid.vid_d") as s:
            logits_real, ds1 = vid_dcgan.vid_discriminator(
                params["vid_discriminator"], state["vid_discriminator"],
                real_acts, cfg, train=True)
            s.mark(logits_real)
        with profile.span("vid.vid_d") as s:
            logits_fake, ds2 = vid_dcgan.vid_discriminator(
                params["vid_discriminator"], ds1, fake_acts, cfg,
                train=True)
            s.mark(logits_fake)
        with profile.span("vid.loss"):
            with collectives.per_clip():
                loss_real = nn.sigmoid_ce(logits_real,
                                          torch.ones_like(logits_real))
                loss_fake = nn.sigmoid_ce(logits_fake,
                                          torch.zeros_like(logits_fake))
            d_loss = loss_real + loss_fake
        with profile.span("vid.backward"):
            grads = _grads(d_loss, keys, leaves)
    metrics = {"d_loss": d_loss, "d_loss_real": loss_real,
               "d_loss_fake": loss_fake, "real_activation_std": real_std,
               "fake_activation_std": fake_std}
    return grads, {k: v.detach() for k, v in metrics.items()}, ds2


def _d_step(ts: VidTrainState, frames: Tensor, z: Tensor, gen,
            cfg: VidGANConfig, tcfg: TrainConfig, opt: Adam,
            knobs: Optional[Knobs] = None) -> Tuple[VidTrainState, Dict]:
    grads, metrics, vid_ds = _d_grads(ts, frames, z, gen, cfg, tcfg, knobs)
    grads = collectives.reduce_gradients(grads, "opt_d", per_clip=("vid",))
    with profile.span("vid.optimizer"):
        updates, opt_d = opt.update(grads, ts.opt_d)
        if knobs is not None:
            updates = scale_updates(updates, knobs.d_lr_scale)
        new = apply_updates(_d_trainable(ts.params, tcfg), updates)
    params = dict(ts.params, vid_discriminator=new["vid"])
    if "img" in new:
        params["img_discriminator"] = new["img"]
    vid_ds = collectives.shard(vid_ds, "state/vid_discriminator")
    ts = ts._replace(params=params,
                     state=dict(ts.state, vid_discriminator=vid_ds),
                     opt_d=opt_d)
    return ts, metrics


def _g_grads(ts: VidTrainState, z: Tensor, gen, cfg: VidGANConfig,
             tcfg: TrainConfig, knobs: Optional[Knobs] = None,
             ) -> Tuple[Dict, Dict, Dict]:
    """(grads of the G loss over the G-trainable tree, metrics, new vid-G
    BN state). The vid-D BN state of this pass is discarded. Under FSDP
    the params and state are all-gathered first."""
    full = collectives.gather(ts.params, "params")
    state = collectives.gather(ts.state, "state")
    keys, leaves, tr = _differentiable(_g_trainable(full, tcfg))
    params = dict(full, vid_generator=tr["vid"])
    if "img" in tr:
        params["img_generator"] = tr["img"]
    with torch.enable_grad():
        fake_acts, g_out, vid_gs, _ = _fake_activations(params, state, z,
                                                        cfg, gen, knobs)
        with profile.span("vid.vid_d") as s:
            logits_fake, _ = vid_dcgan.vid_discriminator(
                params["vid_discriminator"], state["vid_discriminator"],
                fake_acts, cfg, train=True)
            s.mark(logits_fake)
        with profile.span("vid.loss"):
            with collectives.per_clip():
                realism = nn.sigmoid_ce(logits_fake,
                                        torch.ones_like(logits_fake))
            ff = (cfg.first_frame_loss_scalar
                  * vid_dcgan.first_frame_loss(g_out, z, cfg))
            g_loss = realism + ff
        with profile.span("vid.backward"):
            grads = _grads(g_loss, keys, leaves)
    metrics = {"g_loss": g_loss, "g_loss_realism": realism,
               "first_frame_loss": ff}
    return grads, {k: v.detach() for k, v in metrics.items()}, vid_gs


def _g_step(ts: VidTrainState, z: Tensor, gen, cfg: VidGANConfig,
            tcfg: TrainConfig, opt: Adam,
            knobs: Optional[Knobs] = None) -> Tuple[VidTrainState, Dict]:
    grads, metrics, vid_gs = _g_grads(ts, z, gen, cfg, tcfg, knobs)
    grads = collectives.reduce_gradients(grads, "opt_g")
    with profile.span("vid.optimizer"):
        updates, opt_g = opt.update(grads, ts.opt_g)
        new = apply_updates(_g_trainable(ts.params, tcfg), updates)
    params = dict(ts.params, vid_generator=new["vid"])
    if "img" in new:
        params["img_generator"] = new["img"]
    vid_gs = collectives.shard(vid_gs, "state/vid_generator")
    ts = ts._replace(params=params,
                     state=dict(ts.state, vid_generator=vid_gs), opt_g=opt_g)
    return ts, metrics


def train_step(ts: VidTrainState, frames: Tensor, z: Tensor,
               gen: Optional[torch.Generator], cfg: VidGANConfig,
               tcfg: TrainConfig, knobs: Optional[Knobs] = None,
               ) -> Tuple[VidTrainState, Dict]:
    """One batch: `disc_updates` D updates then `gen_updates` G updates.

    frames: time-folded (B*T, s, s, c) in [-1, 1]; z: (B, z_in).
    gen: the noise generator on the tensors' device (None draws no noise).
    knobs: optional runtime noise levels and D-lr scale.
    Returns the new state (the old one is not modified) and scalar metrics.
    """
    opt_g, opt_d = make_optimizer(tcfg, "g"), make_optimizer(tcfg, "d")
    metrics = {"images_std": nn.get_std(frames.reshape(frames.shape[0], -1))}
    for _ in range(tcfg.disc_updates):
        ts, m = _d_step(ts, frames, z, gen, cfg, tcfg, opt_d, knobs)
        metrics.update(m)
    for _ in range(tcfg.gen_updates):
        ts, m = _g_step(ts, z, gen, cfg, tcfg, opt_g, knobs)
        metrics.update(m)
    return ts._replace(step=ts.step + 1), metrics


def train_chunk(ts: VidTrainState, frames_stack: Tensor, z_stack: Tensor,
                gen, cfg: VidGANConfig, tcfg: TrainConfig,
                knobs: Optional[Knobs] = None) -> Tuple[VidTrainState, Dict]:
    """K train steps (frames_stack (K, B*T, s, s, c), z_stack (K, B, z_in));
    metrics stacked over the chunk."""
    ms = []
    for frames, z in zip(frames_stack, z_stack):
        with profile.span("vid.step", z.device):
            ts, m = train_step(ts, frames, z, gen, cfg, tcfg, knobs)
        ms.append(m)
    return ts, _stack(ms)


def train_chunk_ids(ts: VidTrainState, ids_stack: Tensor, z_stack: Tensor,
                    gen, corpus_data: Tensor, cfg: VidGANConfig,
                    tcfg: TrainConfig, sample_fn: Callable,
                    knobs: Optional[Knobs] = None,
                    ) -> Tuple[VidTrainState, Dict]:
    """train_chunk with each step's frames gathered on the device from a
    resident corpus (data/device.py DeviceCorpus: pass `corpus.data` and
    `corpus.sample_fn` or `corpus.fold_sample_fn`). ids_stack: (K, B).
    Only one step's frames are alive at a time."""
    ms = []
    for idx, z in zip(ids_stack, z_stack):
        with profile.span("vid.step", z.device):
            g = sample_fn(corpus_data, idx)
            frames = g.reshape((-1,) + g.shape[2:]) if g.ndim == 5 else g
            ts, m = train_step(ts, frames, z, gen, cfg, tcfg, knobs)
        ms.append(m)
    return ts, _stack(ms)


def sample_videos(ts: VidTrainState, z: Tensor, cfg: VidGANConfig) -> Tensor:
    """Inference sampler, both generators in inference mode:
    z (B, z_in) -> videos (B, T, s, s, c) float32 in [-1, 1]."""
    with torch.no_grad():
        g_out, _ = vid_dcgan.vid_generator(
            ts.params["vid_generator"], ts.state["vid_generator"], z, cfg,
            train=False)
        frames, _ = dcgan.generator(
            ts.params["img_generator"], ts.state["img_generator"], g_out,
            cfg.image_gan, train=False)
    s = cfg.image_gan.output_size
    return frames.reshape(z.shape[0], cfg.vid_length, s, s,
                          cfg.image_gan.c_dim)


# calibration z of quantize_sampler: batches of 64 from the port's stream
# seed 11 (the JAX package's defaults)
CALIB_BATCH, CALIB_SEED = 64, 11


def quantize_sampler(ts: VidTrainState, cfg: VidGANConfig,
                     calib_batches: int = 0, float_last: bool = False,
                     calib_mode: str = "max", bias_correct: bool = False):
    """int8 serving sampler (gifgan_tpu/train/vid.py quantize_sampler):
    quantize the frozen generator stack once (ops/quant.py: BN folded,
    per-channel int8 weights) and return (q tree, sample_videos_q).

    calib_batches > 0 bakes static activation scales from that many
    uniform-z batches (quant.calibrate_vid_stack, calib_mode "max" or
    "mse"). bias_correct runs quant.bias_correct_vid_stack over the
    calibration batches (8 when calib_batches is 0), after the scales. The
    z batches come from the port's streams (core/rng.py, CALIB_SEED) on
    the state's device, not from threefry."""
    q = quant.quantize_vid_stack(ts.params, ts.state, float_last=float_last)
    n_z = max(calib_batches, 8 if bias_correct else 0)
    stream = PRNGSequence(CALIB_SEED, ts.step.device)
    zs = [uniform_z(next(stream), (CALIB_BATCH, cfg.z_input_size))
          for _ in range(n_z)]
    if calib_batches > 0:
        q = quant.calibrate_vid_stack(q, zs[:calib_batches], cfg,
                                      mode=calib_mode)
    if bias_correct:
        q = quant.bias_correct_vid_stack(q, ts.params, ts.state, zs, cfg)
    return q, sample_videos_q


def sample_videos_q(q, z: Tensor, cfg: VidGANConfig) -> Tensor:
    """int8 counterpart of sample_videos over a quantized serving tree
    (quantize_sampler, or quant.load_artifact on a serving host):
    z (B, z_in) -> videos (B, T, s, s, c) float32 in [-1, 1]."""
    with torch.no_grad():
        frames, _ = quant.generate_videos_q(q, z, cfg)
    s = cfg.image_gan.output_size
    return frames.reshape(z.shape[0], cfg.vid_length, s, s,
                          cfg.image_gan.c_dim)


def load_image_gan(ts: VidTrainState, ckpt_dir: str,
                   step: Optional[int] = None) -> VidTrainState:
    """Graft an image-GAN checkpoint (a train-dcgan run's: keys
    `params/generator/...`, `state/discriminator/...`) into the nested
    image nets of a video-GAN state, params and BN state (the reference's
    load_image_gan, gifgan_tpu/train/vid.py:289)."""
    for sub, pref in (("params/img_generator", "params/generator/"),
                      ("params/img_discriminator", "params/discriminator/"),
                      ("state/img_generator", "state/generator/"),
                      ("state/img_discriminator", "state/discriminator/")):
        ts = ckpt.graft(ckpt_dir, ts, sub, ckpt_prefix=pref, step=step)
    return ts


def load_vid_train_state(checkpoint_dir: str, device=None,
                         ) -> Tuple[VidGANConfig, VidTrainState]:
    """(cfg, state) from a train-vid run's checkpoints dir, written by
    either package: reads ../params.json and the latest step.

    Every leaf of a fresh state for that config must be in the checkpoint
    with its shape; a missing one raises (serving random weights must not
    pass for a restore)."""
    device = resolve_device(device)
    params_path = os.path.join(checkpoint_dir, os.pardir, "params.json")
    if not os.path.exists(params_path):
        raise FileNotFoundError(
            f"run dir must contain params.json ({params_path})")
    doc = load_config(params_path)
    cfg, tcfg = doc["model"], doc["train"]
    flat = ckpt.load_flat(checkpoint_dir)
    want = interop.to_jax_flat(init_train_state(
        torch.Generator().manual_seed(0), cfg, tcfg, device="cpu"))
    missing = sorted(k for k in want if k not in flat)
    if missing:
        raise KeyError(f"{len(missing)} leaves missing from the checkpoint "
                       f"in {checkpoint_dir}, e.g. {missing[:5]}")
    bad = [k for k in want if flat[k].shape != want[k].shape]
    if bad:
        raise ValueError(f"shape mismatch in {checkpoint_dir}: " + ", ".join(
            f"{k} {flat[k].shape} != {want[k].shape}" for k in bad[:5]))
    extra = sorted(set(flat) - set(want))
    if extra:
        warnings.warn(f"{len(extra)} checkpoint keys unused, e.g. "
                      f"{extra[:5]}", stacklevel=2)
    tree = interop.from_jax_flat(
        {k: flat[k].astype(want[k].dtype) for k in want}, device)
    return cfg, VidTrainState.from_tree(tree)
