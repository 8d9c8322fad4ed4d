"""VID_DCGAN — the nested "recurrent-z" video GAN
(gifgan_tpu/models/vid_dcgan.py).

z-sequence generator: the video latent (B, z_in) is broadcast over T
frames, a frame number in linspace(-1, 1) is appended, time folds into
batch, and a 3x hidden BN+ReLU MLP maps each row to a tanh frame latent
(B*T, z_out). Those drive the frozen image generator at inner batch B*T.

Video discriminator: the image discriminator's h2 tap (B*T, h, w, c) is
reshaped to (B, T, h, w, c) and passed through three 3x3x3/2 conv3ds
(lrelu; BN on the last two) and a linear logit.

Parameters and state are dicts keyed "vid_generator", "vid_discriminator",
"img_generator", "img_discriminator" (the JAX package's VidGANParams
fields, so checkpoint paths match).

In a sequence-parallel step (parallel/sp.py) a rank holds a block of the
time-folded rows, over the (data, seq) composite: the MLP takes its block
of `frame_inputs`, and the video discriminator gathers its clips' frames
over `seq` first (the JAX package's vid_d_sharding wall), so every seq
rank runs it alike on whole clips, its BN over the clips
(parallel/collectives.py per_clip). Under tensor parallelism the MLP's
output and h3's are gathered over `model` where the image generator and
the replicated h4_lin need every channel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core.config import VidGANConfig
from gifgan_tpu_torch.models import dcgan
from gifgan_tpu_torch.ops import nn
from gifgan_tpu_torch.parallel import collectives

Tensor = torch.Tensor


def init_vid_generator(gen: torch.Generator, cfg: VidGANConfig,
                       ) -> Tuple[Dict, Dict]:
    h = cfg.hidden_dim
    params = {
        "lin0": nn.linear_init(gen, cfg.z_input_size + 1, h),
        "lin1": nn.linear_init(gen, h, h),
        "lin2": nn.linear_init(gen, h, h),
        "lin3": nn.linear_init(gen, h, cfg.z_output_size),
    }
    state = {}
    for i in range(3):
        params[f"bn{i}"], state[f"bn{i}"] = nn.batch_norm_init(h)
    return params, state


def frame_inputs(z: Tensor, cfg: VidGANConfig) -> Tensor:
    """z (B, z_in) -> the MLP's rows (B*T, z_in + 1) float32: z repeated
    over T frames, each with its frame number in linspace(-1, 1, T)."""
    b, t = z.shape[0], cfg.vid_length
    z_copied = z.float()[:, None, :].expand(b, t, cfg.z_input_size)
    frames = torch.linspace(-1.0, 1.0, t, dtype=torch.float32,
                            device=z.device)[None, :, None].expand(b, t, 1)
    h = torch.cat([z_copied, frames], dim=-1)
    return h.reshape(b * t, cfg.z_input_size + 1)


def vid_generator(params, state, z: Tensor, cfg: VidGANConfig, train: bool,
                  ) -> Tuple[Tensor, Dict]:
    """z (B, z_in) -> frame latents (B*T, z_out) float32 in [-1, 1]: this
    rank's seq block of the rows in a sequence-parallel step."""
    dtype = nn.torch_dtype(cfg.compute_dtype)
    h = collectives.seq_rows(frame_inputs(z, cfg)).to(dtype)
    new_state = {}
    for i in range(3):
        h = nn.linear(params[f"lin{i}"], h, dtype=dtype)
        h, new_state[f"bn{i}"] = nn.batch_norm(
            params[f"bn{i}"], state[f"bn{i}"], h, train)
        h = torch.relu(h)
    h = nn.linear(params["lin3"], h, dtype=dtype)
    return nn.gather_channels(torch.tanh(h.float()),
                              cfg.z_output_size), new_state


def init_vid_discriminator(gen: torch.Generator, cfg: VidGANConfig,
                           ) -> Tuple[Dict, Dict]:
    f = cfg.d_filters
    act_ch = cfg.image_gan.df_dim * 4          # image-D h2 tap channels
    t, hw = cfg.vid_length, cfg.image_gan.output_size // 8
    for _ in range(3):
        t, hw = (t + 1) // 2, (hw + 1) // 2
    params = {
        "h1_conv": nn.conv3d_init(gen, act_ch, f),
        "h2_conv": nn.conv3d_init(gen, f, f),
        "h3_conv": nn.conv3d_init(gen, f, f),
        "h4_lin": nn.linear_init(gen, t * hw * hw * f, 1),
    }
    state = {}
    for i in (2, 3):
        params[f"bn{i}"], state[f"bn{i}"] = nn.batch_norm_init(f)
    return params, state


def vid_discriminator(params, state, activations: Tensor, cfg: VidGANConfig,
                      train: bool) -> Tuple[Tensor, Dict]:
    """activations (B*T, h, w, c) -> (logits (B, 1) float32, new BN state).
    In a sequence-parallel step the rows are this rank's (data, seq) block
    and the logits its data block's clips."""
    dtype = nn.torch_dtype(cfg.compute_dtype)
    t = cfg.vid_length
    activations = collectives.gather_seq(activations)
    bt, hh, ww, c = activations.shape
    b = bt // t
    vid = activations.reshape(b, t, hh, ww, c).to(dtype)
    new_state = {}
    with collectives.per_clip():
        h = nn.lrelu(nn.conv3d(params["h1_conv"], vid, dtype=dtype))
        h = nn.conv3d(params["h2_conv"], h, dtype=dtype)
        h, new_state["bn2"] = nn.batch_norm(params["bn2"], state["bn2"], h,
                                            train)
        h = nn.lrelu(h)
        h = nn.conv3d(params["h3_conv"], h, dtype=dtype)
        h, new_state["bn3"] = nn.batch_norm(params["bn3"], state["bn3"], h,
                                            train)
        h = nn.gather_channels(nn.lrelu(h), cfg.d_filters)
    logits = nn.linear(params["h4_lin"], h.reshape(b, -1), dtype=dtype)
    return logits.float(), new_state


def init(gen: torch.Generator, cfg: VidGANConfig, device=None,
         ) -> Tuple[Dict, Dict]:
    """(params, state) dicts of the four nets on `device`; weights drawn on
    the CPU from `gen`, so one seed gives the same weights on every device."""
    device = resolve_device(device)
    gp, gs = init_vid_generator(gen, cfg)
    dp, ds = init_vid_discriminator(gen, cfg)
    igp, igs = dcgan.init_generator(gen, cfg.image_gan)
    idp, ids = dcgan.init_discriminator(gen, cfg.image_gan)
    params = {"vid_generator": gp, "vid_discriminator": dp,
              "img_generator": igp, "img_discriminator": idp}
    state = {"vid_generator": gs, "vid_discriminator": ds,
             "img_generator": igs, "img_discriminator": ids}
    return dcgan.to_device(params, device), dcgan.to_device(state, device)


def generate_videos(params, state, z: Tensor, cfg: VidGANConfig, train: bool,
                    ) -> Tuple[Tensor, Tensor, Dict, Dict]:
    """z (B, z_in) -> (frames (B*T, s, s, c), frame latents (B*T, z_out),
    new vid-G state, new img-G state)."""
    g_out, gs = vid_generator(params["vid_generator"], state["vid_generator"],
                              z, cfg, train)
    frames, igs = dcgan.generator(params["img_generator"],
                                  state["img_generator"], g_out,
                                  cfg.image_gan, train)
    return frames, g_out, gs, igs


def first_frame_loss(g_out: Tensor, z: Tensor, cfg: VidGANConfig) -> Tensor:
    """MSE between the generated frame-0 latents (every T-th row of the
    time-folded g_out) and z[:, :z_out]; over the logical batch in a mesh
    step (parallel/collectives.py). Frame 0 is picked by its row's index
    among the clips' rows: a rank of a sequence-parallel step holds a block
    that may start inside a clip, or hold no frame 0."""
    t = cfg.vid_length
    start = collectives.seq_offset(g_out.shape[0])
    first = (-start) % t
    rows = g_out[first::t]
    clip = (start + first) // t
    sq = torch.square(rows - z[clip:clip + rows.shape[0],
                               :cfg.z_output_size])
    if collectives.active() is None:
        return torch.mean(sq)
    clips = g_out.shape[0] * collectives.rows_size() // t
    return collectives.sum_rows(sq.sum()) / (clips * cfg.z_output_size)
