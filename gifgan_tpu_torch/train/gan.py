"""Image-DCGAN training (gifgan_tpu/train/gan.py: the unconditional step
:29-150, :238-275, and the conditional (MNIST) one :153-236) and the
optimizer of every GAN step (make_optimizer, :37-45).

One batch is one D update then `gen_updates` G updates, with the
reference's BN-state order: the D step runs G in train mode outside the
differentiated part and keeps G's new BN state, and D's state chains
real -> fake; in a G step both nets' states come out of the G loss. A step
returns a new state; the one it was given is not modified. `lax.scan`
becomes a Python loop (train_chunk, train_chunk_ids), autograd replaces
jax.value_and_grad, and noise draws come from an explicit torch.Generator
(None draws none): torch cannot reproduce threefry, so parity with the JAX
package holds step by step with z passed in and noise 0. On a mesh the
gradients are reduced over the ranks between each `_x_grads` and its
optimizer update (parallel/collectives.py reduce_gradients, the seam
train/vid.py shares), and FSDP-sharded state is gathered where it is read.

A functional Adam with optax's arithmetic and state, so a JAX train state's
slots resume here (core/interop.py):

    mu    = (1 - b1) g + b1 mu          nu = (1 - b2) g^2 + b2 nu
    count = count + 1                   (int32)
    u     = -lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

eps sits outside the square root (optax.adam with eps_root = 0, as TF's
AdamOptimizer). Trees are nested dicts of tensors; the update runs over
all leaves at once with torch._foreach ops.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core.config import DCGANConfig, TrainConfig
from gifgan_tpu_torch.core.tree import flatten, unflatten
from gifgan_tpu_torch.models import dcgan
from gifgan_tpu_torch.ops import nn
from gifgan_tpu_torch.parallel import collectives

Tensor = torch.Tensor


class AdamState(NamedTuple):
    count: torch.Tensor   # int32 scalar
    mu: Any               # tree like the params
    nu: Any


def _leaves(tree) -> Tuple[List[str], List[torch.Tensor]]:
    flat = flatten(tree)
    return list(flat), list(flat.values())


class Adam:
    """optax.adam(lr, b1, b2, eps) over nested dicts of tensors."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params) -> AdamState:
        keys, leaves = _leaves(params)
        zeros = lambda: unflatten(dict(zip(keys, [torch.zeros_like(p)
                                                  for p in leaves])))
        count = torch.zeros((), dtype=torch.int32,
                            device=leaves[0].device if leaves else None)
        return AdamState(count, zeros(), zeros())

    def update(self, grads, state: AdamState) -> Tuple[Any, AdamState]:
        """(updates, new state); updates are added to the params by
        `apply_updates`."""
        keys, g = _leaves(grads)
        mu_keys, mu_old = _leaves(state.mu)
        if mu_keys != keys:
            raise ValueError("gradient tree does not match the Adam slots")
        mu = torch._foreach_mul(g, 1.0 - self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(mu_old, self.b1))
        nu = torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(_leaves(state.nu)[1],
                                                   self.b2))
        count = state.count + 1
        c = count.float()
        mu_hat = torch._foreach_div(mu, 1.0 - self.b1 ** c)
        nu_hat = torch._foreach_div(nu, 1.0 - self.b2 ** c)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(upd, -self.lr)
        new = AdamState(count, unflatten(dict(zip(keys, mu))),
                        unflatten(dict(zip(keys, nu))))
        return unflatten(dict(zip(keys, upd))), new


def scale_updates(updates, scale: torch.Tensor):
    """updates * scale (a tensor scalar): Adam is lr-linear, so this is the
    runtime D-lr knob."""
    keys, u = _leaves(updates)
    return unflatten(dict(zip(keys, torch._foreach_mul(u, scale))))


def apply_updates(params, updates):
    """params + updates, leafwise (optax.apply_updates)."""
    keys, p = _leaves(params)
    return unflatten(dict(zip(keys, torch._foreach_add(p, _leaves(updates)[1]))))


def make_optimizer(tcfg: TrainConfig, role: str = "g") -> Adam:
    """Adam(lr, b1=tcfg.beta1, b2=0.999, eps=1e-8) (TF AdamOptimizer
    defaults). role="d" takes tcfg.d_learning_rate when set."""
    lr = tcfg.learning_rate
    if role == "d" and tcfg.d_learning_rate is not None:
        lr = tcfg.d_learning_rate
    return Adam(lr, b1=tcfg.beta1, b2=0.999, eps=1e-8)


# ---------------------------------------------------------------------------
# autograd over a tree of parameters
# ---------------------------------------------------------------------------

def _differentiable(tree: Dict):
    """(keys, leaves, tree) with fresh grad-requiring leaves over `tree`."""
    flat = flatten(tree)
    leaves = [p.detach().requires_grad_(True) for p in flat.values()]
    return list(flat), leaves, unflatten(dict(zip(flat, leaves)))


def _grads(loss: Tensor, keys, leaves) -> Dict:
    # a leaf that feeds no loss (the video path's image D h3 layers) gets
    # a zero gradient, as jax.grad gives it
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return unflatten({k: torch.zeros_like(p) if g is None else g
                      for k, p, g in zip(keys, leaves, gs)})


def _stack(ms: List[Dict]) -> Dict:
    return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}


# ---------------------------------------------------------------------------
# image DCGAN
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: Dict          # {"generator", "discriminator"}
    state: Dict           # BN running moments, same keys
    opt_g: AdamState
    opt_d: AdamState
    step: Tensor          # int32 scalar

    @classmethod
    def from_tree(cls, tree: Dict) -> "TrainState":
        """From the nested dicts of core/interop.from_jax_flat."""
        return cls(params=tree["params"], state=tree["state"],
                   opt_g=AdamState(**tree["opt_g"]),
                   opt_d=AdamState(**tree["opt_d"]), step=tree["step"])


def init_train_state(gen: torch.Generator, cfg: DCGANConfig,
                     tcfg: TrainConfig, device=None) -> TrainState:
    """Fresh state on `device`; weights drawn on the CPU from `gen`."""
    device = resolve_device(device)
    params, state = dcgan.init(gen, cfg, device)
    opt = make_optimizer(tcfg)
    return TrainState(params=params, state=state,
                      opt_g=opt.init(params["generator"]),
                      opt_d=opt.init(params["discriminator"]),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def _d_grads(ts: TrainState, images: Tensor, z: Tensor, gen,
             cfg: DCGANConfig) -> Tuple[Dict, Dict, Dict]:
    """(D-loss gradients over the D params, metrics, new BN state: G's from
    its train-mode forward, D's chained real -> fake)."""
    params = collectives.gather(ts.params, "params")
    state = collectives.gather(ts.state, "state")
    noisy_images = nn.add_noise(gen, images, cfg.noise_std)
    with torch.no_grad():            # D never needs gradients through G
        fake, gen_bn = dcgan.generator(params["generator"],
                                       state["generator"], z, cfg,
                                       train=True)
    noisy_fake = nn.add_noise(gen, fake, cfg.noise_std)
    keys, leaves, d_params = _differentiable(params["discriminator"])
    with torch.enable_grad():
        logits_real, _, ds1 = dcgan.discriminator(
            d_params, state["discriminator"], noisy_images, cfg,
            train=True)
        logits_fake, _, ds2 = dcgan.discriminator(d_params, ds1, noisy_fake,
                                                  cfg, train=True)
        loss_real = nn.sigmoid_ce(logits_real, torch.ones_like(logits_real))
        loss_fake = nn.sigmoid_ce(logits_fake, torch.zeros_like(logits_fake))
        d_loss = loss_real + loss_fake
        grads = _grads(d_loss, keys, leaves)
    metrics = {"d_loss": d_loss, "d_loss_real": loss_real,
               "d_loss_fake": loss_fake,
               "images_std": nn.get_std(images.reshape(images.shape[0], -1)),
               "g_std": nn.get_std(fake.reshape(fake.shape[0], -1))}
    return (grads, {k: v.detach() for k, v in metrics.items()},
            {"generator": gen_bn, "discriminator": ds2})


def _d_step(ts: TrainState, images: Tensor, z: Tensor, gen,
            cfg: DCGANConfig, opt: Adam) -> Tuple[TrainState, Dict]:
    grads, metrics, bn = _d_grads(ts, images, z, gen, cfg)
    grads = collectives.reduce_gradients(grads, "opt_d")
    updates, opt_d = opt.update(grads, ts.opt_d)
    ts = ts._replace(
        params=dict(ts.params, discriminator=apply_updates(
            ts.params["discriminator"], updates)),
        state=collectives.shard(bn, "state"), opt_d=opt_d)
    return ts, metrics


def _g_grads(ts: TrainState, z: Tensor, gen,
             cfg: DCGANConfig) -> Tuple[Dict, Dict, Dict]:
    """(G-loss gradients over the G params, metrics, new BN state of both
    nets from the G loss's forward)."""
    params = collectives.gather(ts.params, "params")
    state = collectives.gather(ts.state, "state")
    keys, leaves, g_params = _differentiable(params["generator"])
    with torch.enable_grad():
        fake, gen_bn = dcgan.generator(g_params, state["generator"], z,
                                       cfg, train=True)
        noisy_fake = nn.add_noise(gen, fake, cfg.noise_std)
        logits_fake, _, disc_bn = dcgan.discriminator(
            params["discriminator"], state["discriminator"],
            noisy_fake, cfg, train=True)
        g_loss = nn.sigmoid_ce(logits_fake, torch.ones_like(logits_fake))
        grads = _grads(g_loss, keys, leaves)
    return (grads, {"g_loss": g_loss.detach()},
            {"generator": gen_bn, "discriminator": disc_bn})


def _g_step(ts: TrainState, z: Tensor, gen, cfg: DCGANConfig,
            opt: Adam) -> Tuple[TrainState, Dict]:
    grads, metrics, bn = _g_grads(ts, z, gen, cfg)
    grads = collectives.reduce_gradients(grads, "opt_g")
    updates, opt_g = opt.update(grads, ts.opt_g)
    ts = ts._replace(
        params=dict(ts.params, generator=apply_updates(
            ts.params["generator"], updates)),
        state=collectives.shard(bn, "state"), opt_g=opt_g)
    return ts, metrics


def train_step(ts: TrainState, images: Tensor, z: Tensor,
               gen: Optional[torch.Generator], cfg: DCGANConfig,
               tcfg: TrainConfig) -> Tuple[TrainState, Dict]:
    """One batch: `disc_updates` D updates then `gen_updates` G updates.

    images: (B, s, s, c) in [-1, 1]; z: (B, z_dim). gen: the noise
    generator on the tensors' device (None draws no noise). Returns the new
    state and scalar metrics."""
    opt_g, opt_d = make_optimizer(tcfg, "g"), make_optimizer(tcfg, "d")
    metrics = {}
    for _ in range(tcfg.disc_updates):
        ts, m = _d_step(ts, images, z, gen, cfg, opt_d)
        metrics.update(m)
    for _ in range(tcfg.gen_updates):
        ts, m = _g_step(ts, z, gen, cfg, opt_g)
        metrics.update(m)
    return ts._replace(step=ts.step + 1), metrics


def sample_step(ts: TrainState, z: Tensor, cfg: DCGANConfig) -> Tensor:
    """Inference-mode samples (B, s, s, c) in [-1, 1]."""
    return dcgan.sample(ts.params, ts.state, z, cfg)


def train_chunk(ts: TrainState, images_stack: Tensor, z_stack: Tensor, gen,
                cfg: DCGANConfig, tcfg: TrainConfig,
                ) -> Tuple[TrainState, Dict]:
    """K train steps (images_stack (K, B, s, s, c), z_stack (K, B, z));
    metrics stacked over the chunk."""
    ms = []
    for images, z in zip(images_stack, z_stack):
        ts, m = train_step(ts, images, z, gen, cfg, tcfg)
        ms.append(m)
    return ts, _stack(ms)


def train_chunk_ids(ts: TrainState, ids_stack: Tensor, z_stack: Tensor, gen,
                    corpus_data: Tensor, cfg: DCGANConfig, tcfg: TrainConfig,
                    sample_fn: Callable) -> Tuple[TrainState, Dict]:
    """train_chunk with each step's (B, s, s, c) stills gathered on the
    device from a resident corpus (data/device.py DeviceCorpus: pass
    `corpus.data` and `corpus.sample_fn`; K1 on the card). ids_stack:
    (K, B). Only one step's images are alive at a time."""
    ms = []
    for idx, z in zip(ids_stack, z_stack):
        ts, m = train_step(ts, sample_fn(corpus_data, idx), z, gen, cfg,
                           tcfg)
        ms.append(m)
    return ts, _stack(ms)


# ---------------------------------------------------------------------------
# conditional (MNIST) DCGAN (gifgan_tpu/train/gan.py:153-236)
# ---------------------------------------------------------------------------

class CondTrainState(TrainState):
    """TrainState of the label-conditioned nets (the same fields and
    checkpoint keys)."""
    __slots__ = ()


def init_cond_train_state(gen: torch.Generator, cfg: DCGANConfig,
                          y_dim: int, tcfg: TrainConfig,
                          device=None) -> CondTrainState:
    """Fresh state on `device`; weights drawn on the CPU from `gen`."""
    device = resolve_device(device)
    gp, gs = dcgan.init_generator_cond(gen, cfg, y_dim)
    dp, ds = dcgan.init_discriminator_cond(gen, cfg, y_dim)
    params = dcgan.to_device({"generator": gp, "discriminator": dp}, device)
    opt = make_optimizer(tcfg)
    return CondTrainState(
        params=params,
        state=dcgan.to_device({"generator": gs, "discriminator": ds}, device),
        opt_g=opt.init(params["generator"]),
        opt_d=opt.init(params["discriminator"]),
        step=torch.zeros((), dtype=torch.int32, device=device))


def cond_train_step(ts: CondTrainState, images: Tensor, y: Tensor,
                    z: Tensor, gen: Optional[torch.Generator],
                    cfg: DCGANConfig, tcfg: TrainConfig,
                    noise: Optional[List[Tensor]] = None,
                    ) -> Tuple[CondTrainState, Dict]:
    """`disc_updates` D updates then `gen_updates` G updates, images in
    [0, 1] and one-hot y. Instance noise (cfg.noise_std) goes on the real
    images only, drawn from `gen` (None draws none); `noise` passes one
    additive term per D update instead (a test's JAX draws). D's BN state
    chains real -> fake; D takes tcfg.d_learning_rate when set."""
    opt_g, opt_d = make_optimizer(tcfg, "g"), make_optimizer(tcfg, "d")
    metrics = {}
    for u in range(tcfg.disc_updates):
        noisy = (images + noise[u] if noise is not None
                 else nn.add_noise(gen, images, cfg.noise_std))
        with torch.no_grad():            # D never needs gradients through G
            fake, gen_bn = dcgan.generator_cond(
                ts.params["generator"], ts.state["generator"], z, y, cfg,
                train=True)
        keys, leaves, dp = _differentiable(ts.params["discriminator"])
        with torch.enable_grad():
            lr_, ds1 = dcgan.discriminator_cond(
                dp, ts.state["discriminator"], noisy, y, cfg, train=True)
            lf_, ds2 = dcgan.discriminator_cond(dp, ds1, fake, y, cfg,
                                                train=True)
            loss_r = nn.sigmoid_ce(lr_, torch.ones_like(lr_))
            loss_f = nn.sigmoid_ce(lf_, torch.zeros_like(lf_))
            d_loss = loss_r + loss_f
            grads = _grads(d_loss, keys, leaves)
        updates, od = opt_d.update(grads, ts.opt_d)
        ts = ts._replace(
            params=dict(ts.params, discriminator=apply_updates(
                ts.params["discriminator"], updates)),
            state={"generator": gen_bn, "discriminator": ds2}, opt_d=od)
        metrics.update(d_loss=d_loss.detach(), d_loss_real=loss_r.detach(),
                       d_loss_fake=loss_f.detach())
    for _ in range(tcfg.gen_updates):
        keys, leaves, gp = _differentiable(ts.params["generator"])
        with torch.enable_grad():
            fake, gen_bn = dcgan.generator_cond(
                gp, ts.state["generator"], z, y, cfg, train=True)
            logits, disc_bn = dcgan.discriminator_cond(
                ts.params["discriminator"], ts.state["discriminator"], fake,
                y, cfg, train=True)
            g_loss = nn.sigmoid_ce(logits, torch.ones_like(logits))
            grads = _grads(g_loss, keys, leaves)
        updates, og = opt_g.update(grads, ts.opt_g)
        ts = ts._replace(
            params=dict(ts.params, generator=apply_updates(
                ts.params["generator"], updates)),
            state={"generator": gen_bn, "discriminator": disc_bn}, opt_g=og)
        metrics["g_loss"] = g_loss.detach()
    return ts._replace(step=ts.step + 1), metrics


def cond_sample_step(ts: CondTrainState, z: Tensor, y: Tensor,
                     cfg: DCGANConfig) -> Tensor:
    """Inference-mode samples (B, s, s, c) in [0, 1] for labels y."""
    with torch.no_grad():
        x, _ = dcgan.generator_cond(ts.params["generator"],
                                    ts.state["generator"], z, y, cfg,
                                    train=False)
    return x
