"""Image DCGAN (gifgan_tpu/models/dcgan.py): the unconditional nets, and at
the end the label-conditioned (MNIST) pair.

Generator: z -> linear -> (s/16, s/16, 8gf) -> BN+ReLU -> four 5x5/2
deconvs (BN+ReLU on the first three) -> tanh, NHWC. Discriminator: four
5x5/2 convs (lrelu; BN on layers 1-3) -> linear logit, and the post-lrelu
h2 map (s/8, s/8, 4df) as a tap — the input of the video discriminator.

One function per net with a `train` flag; BN running moments are explicit
state. Parameters are dicts of float32 tensors (ops/nn.py layouts). In
inference mode each BN of the unconditional nets folds into the weight
and bias of the layer before it (ops/nn.py bn_after), unless tensor
parallelism splits that layer's weight.

Under tensor parallelism (parallel/tp.py blocks, ops/nn.py forms) the
nets keep every activation between layers whole except the
column-parallel layers' outputs, and gather those where a reshape or the
tap needs every channel: h0_lin's output is sharded over its flat
(s16*s16*8gf) dim, that is over spatial positions, so it is gathered
before the reshape into channels.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core.config import DCGANConfig
from gifgan_tpu_torch.ops import nn

Tensor = torch.Tensor


def to_device(tree, device):
    """Nested dict of tensors -> the same on `device`."""
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def init_generator(gen: torch.Generator, cfg: DCGANConfig) -> Tuple[Dict, Dict]:
    """(params, BN state) on the CPU, drawn from the CPU generator `gen`."""
    if cfg.output_size % 16:
        raise ValueError("unconditional DCGAN needs output_size % 16 == 0")
    s16, gf = cfg.output_size // 16, cfg.gf_dim
    params = {
        "h0_lin": nn.linear_init(gen, cfg.z_dim, gf * 8 * s16 * s16),
        "h1_deconv": nn.deconv2d_init(gen, gf * 8, gf * 4),
        "h2_deconv": nn.deconv2d_init(gen, gf * 4, gf * 2),
        "h3_deconv": nn.deconv2d_init(gen, gf * 2, gf),
        "h4_deconv": nn.deconv2d_init(gen, gf, cfg.c_dim),
    }
    state = {}
    for i, ch in enumerate([gf * 8, gf * 4, gf * 2, gf]):
        params[f"bn{i}"], state[f"bn{i}"] = nn.batch_norm_init(ch)
    return params, state


def generator(params, state, z: Tensor, cfg: DCGANConfig, train: bool,
              ) -> Tuple[Tensor, Dict]:
    """z (B, z_dim) -> image (B, s, s, c) float32 in [-1, 1]; new BN state."""
    dtype = nn.torch_dtype(cfg.compute_dtype)
    s16, gf = cfg.output_size // 16, cfg.gf_dim
    new_state = {}
    lin, bn0 = nn.bn_after(params["h0_lin"], params["bn0"], state["bn0"],
                           train, 1, reps=s16 * s16)
    h = nn.linear(lin, z.to(dtype), dtype=dtype)
    h = nn.gather_channels(h, s16 * s16 * gf * 8)
    h, new_state["bn0"] = bn0(h.reshape(-1, s16, s16, gf * 8))
    h = torch.relu(h)
    for i, name in enumerate(["h1_deconv", "h2_deconv", "h3_deconv"]):
        bn = f"bn{i + 1}"
        layer, norm = nn.bn_after(params[name], params[bn], state[bn],
                                  train, 1)
        h, new_state[bn] = norm(nn.deconv2d(layer, h, dtype=dtype))
        h = torch.relu(h)
    impl = "subpixel" if cfg.packed_c3 else None
    h = nn.deconv2d(params["h4_deconv"], h, dtype=dtype, impl=impl)
    return torch.tanh(h.float()), new_state


def init_discriminator(gen: torch.Generator, cfg: DCGANConfig,
                       ) -> Tuple[Dict, Dict]:
    df, s16 = cfg.df_dim, cfg.output_size // 16
    params = {
        "h0_conv": nn.conv2d_init(gen, cfg.c_dim, df),
        "h1_conv": nn.conv2d_init(gen, df, df * 2),
        "h2_conv": nn.conv2d_init(gen, df * 2, df * 4),
        "h3_conv": nn.conv2d_init(gen, df * 4, df * 8),
        "h3_lin": nn.linear_init(gen, df * 8 * s16 * s16, 1),
    }
    state = {}
    for i, ch in enumerate([df * 2, df * 4, df * 8], start=1):
        params[f"bn{i}"], state[f"bn{i}"] = nn.batch_norm_init(ch)
    return params, state


def discriminator_tap(params, state, x: Tensor, cfg: DCGANConfig,
                      train: bool) -> Tuple[Tensor, Dict]:
    """The discriminator up to its h2 tap: (h2, BN state of bn1 and bn2).

    The video GAN reads only the tap. XLA drops the unused h3 layers from
    the JAX program; eager PyTorch would run them, so the video path calls
    this instead of `discriminator`. The tap comes back whole (gathered
    over the model axis under tensor parallelism)."""
    dtype = nn.torch_dtype(cfg.compute_dtype)
    new_state = {}
    impl0 = "s2d" if cfg.packed_c3 else None
    h = nn.lrelu(nn.conv2d(params["h0_conv"], x.to(dtype), dtype=dtype,
                           impl=impl0))
    layer, bn1 = nn.bn_after(params["h1_conv"], params["bn1"], state["bn1"],
                             train, 0)
    h, new_state["bn1"] = bn1(nn.conv2d(layer, h, dtype=dtype))
    layer, bn2 = nn.bn_after(params["h2_conv"], params["bn2"], state["bn2"],
                             train, 0)
    h, new_state["bn2"] = bn2(nn.conv2d(layer, nn.lrelu(h), dtype=dtype))
    return nn.gather_channels(nn.lrelu(h), cfg.df_dim * 4), new_state


def discriminator(params, state, x: Tensor, cfg: DCGANConfig, train: bool,
                  ) -> Tuple[Tensor, Tensor, Dict]:
    """image (B, s, s, c) -> (logits (B, 1) float32, h2 tap, new BN state)."""
    dtype = nn.torch_dtype(cfg.compute_dtype)
    h2, new_state = discriminator_tap(params, state, x, cfg, train)
    layer, bn3 = nn.bn_after(params["h3_conv"], params["bn3"], state["bn3"],
                             train, 0)
    h, new_state["bn3"] = bn3(nn.conv2d(layer, h2, dtype=dtype))
    h = nn.gather_channels(nn.lrelu(h), cfg.df_dim * 8)
    logits = nn.linear(params["h3_lin"], h.reshape(h.shape[0], -1),
                       dtype=dtype)
    return logits.float(), h2, new_state


def init(gen: torch.Generator, cfg: DCGANConfig, device=None,
         ) -> Tuple[Dict, Dict]:
    """({"generator", "discriminator"} params, same-keyed BN state) on
    `device`. Weights are drawn on the CPU from `gen`, so one seed gives the
    same weights on every device."""
    device = resolve_device(device)
    gp, gs = init_generator(gen, cfg)
    dp, ds = init_discriminator(gen, cfg)
    return (to_device({"generator": gp, "discriminator": dp}, device),
            to_device({"generator": gs, "discriminator": ds}, device))


def sample(params, state, z: Tensor, cfg: DCGANConfig) -> Tensor:
    """Inference-mode sampler: BN uses the running moments."""
    with torch.no_grad():
        x, _ = generator(params["generator"], state["generator"], z, cfg,
                         train=False)
    return x


# ---------------------------------------------------------------------------
# Conditional (y-label) variant, the MNIST configuration
# (gifgan_tpu/models/dcgan.py:160-255): the label is concatenated onto the
# latent and onto the feature maps
# ---------------------------------------------------------------------------

def conv_cond_concat(x: Tensor, y: Tensor) -> Tensor:
    """(B, h, w, c) feature map + (B, y_dim) label as constant channels."""
    b, h, w, _ = x.shape
    yb = y[:, None, None, :].expand(b, h, w, y.shape[-1])
    return torch.cat([x, yb.to(x.dtype)], dim=-1)


def init_generator_cond(gen: torch.Generator, cfg: DCGANConfig, y_dim: int,
                        gfc_dim: int = 1024) -> Tuple[Dict, Dict]:
    """(params, BN state) on the CPU, drawn from the CPU generator `gen`."""
    s4, gf = cfg.output_size // 4, cfg.gf_dim
    params = {
        "h0_lin": nn.linear_init(gen, cfg.z_dim + y_dim, gfc_dim),
        "h1_lin": nn.linear_init(gen, gfc_dim + y_dim, gf * 2 * s4 * s4),
        "h2_deconv": nn.deconv2d_init(gen, gf * 2 + y_dim, gf * 2),
        "h3_deconv": nn.deconv2d_init(gen, gf * 2 + y_dim, cfg.c_dim),
    }
    state = {}
    for name, ch in (("bn0", gfc_dim), ("bn1", gf * 2 * s4 * s4),
                     ("bn2", gf * 2)):
        params[name], state[name] = nn.batch_norm_init(ch)
    return params, state


def generator_cond(params, state, z: Tensor, y: Tensor, cfg: DCGANConfig,
                   train: bool) -> Tuple[Tensor, Dict]:
    """(z, one-hot y) -> image (B, s, s, c) float32 in [0, 1] (sigmoid;
    MNIST is stored in [0, 1]); new BN state. The h1_lin output becomes
    (s/4, s/4, 2gf) in NHWC order, as the JAX package's."""
    dtype = nn.torch_dtype(cfg.compute_dtype)
    s4, gf = cfg.output_size // 4, cfg.gf_dim
    new_state = {}
    zy = torch.cat([z, y], dim=1).to(dtype)
    h, new_state["bn0"] = nn.batch_norm(
        params["bn0"], state["bn0"],
        nn.linear(params["h0_lin"], zy, dtype=dtype), train)
    h = torch.cat([torch.relu(h), y.to(h.dtype)], dim=1)
    h, new_state["bn1"] = nn.batch_norm(
        params["bn1"], state["bn1"],
        nn.linear(params["h1_lin"], h, dtype=dtype), train)
    h = conv_cond_concat(torch.relu(h).reshape(-1, s4, s4, gf * 2), y)
    h, new_state["bn2"] = nn.batch_norm(
        params["bn2"], state["bn2"],
        nn.deconv2d(params["h2_deconv"], h, dtype=dtype), train)
    h = conv_cond_concat(torch.relu(h), y)
    h = nn.deconv2d(params["h3_deconv"], h, dtype=dtype)
    return torch.sigmoid(h.float()), new_state


def init_discriminator_cond(gen: torch.Generator, cfg: DCGANConfig,
                            y_dim: int, dfc_dim: int = 1024
                            ) -> Tuple[Dict, Dict]:
    s4, df = cfg.output_size // 4, cfg.df_dim
    c1 = cfg.c_dim + y_dim
    params = {
        "h0_conv": nn.conv2d_init(gen, cfg.c_dim + y_dim, c1),
        "h1_conv": nn.conv2d_init(gen, c1 + y_dim, df + y_dim),
        "h2_lin": nn.linear_init(gen, s4 * s4 * (df + y_dim) + y_dim,
                                 dfc_dim),
        "h3_lin": nn.linear_init(gen, dfc_dim + y_dim, 1),
    }
    state = {}
    for name, ch in (("bn1", df + y_dim), ("bn2", dfc_dim)):
        params[name], state[name] = nn.batch_norm_init(ch)
    return params, state


def discriminator_cond(params, state, x: Tensor, y: Tensor,
                       cfg: DCGANConfig, train: bool) -> Tuple[Tensor, Dict]:
    """(image (B, s, s, c), one-hot y) -> (logits (B, 1) float32, new BN
    state)."""
    dtype = nn.torch_dtype(cfg.compute_dtype)
    new_state = {}
    h = conv_cond_concat(x.to(dtype), y)
    h = conv_cond_concat(nn.lrelu(nn.conv2d(params["h0_conv"], h,
                                            dtype=dtype)), y)
    h, new_state["bn1"] = nn.batch_norm(
        params["bn1"], state["bn1"],
        nn.conv2d(params["h1_conv"], h, dtype=dtype), train)
    h = nn.lrelu(h).reshape(h.shape[0], -1)
    h = torch.cat([h, y.to(h.dtype)], dim=1)
    h, new_state["bn2"] = nn.batch_norm(
        params["bn2"], state["bn2"],
        nn.linear(params["h2_lin"], h, dtype=dtype), train)
    h = torch.cat([nn.lrelu(h), y.to(h.dtype)], dim=1)
    return nn.linear(params["h3_lin"], h, dtype=dtype).float(), new_state
