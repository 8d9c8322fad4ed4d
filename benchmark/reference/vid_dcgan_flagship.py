"""Plain reference of the recurrent-z video GAN (VID_DCGAN), as in
github.com/ord-nas/gif-gan models/recurrent_z/z_model.py:22-65,
z_model_lib.py:15-76 and model.py:12-74,226-239.

Float32 with TF32 off; NHWC activations; nothing of the program imported.
Weights come in as one flat dict, "params/<net>/<layer>/<leaf>" and
"state/<net>/<bn>/{mean,var}", with the nets "vid_generator",
"vid_discriminator", "img_generator" and "img_discriminator".

One training step: one D update, then two G updates, each with its own
Adam. Only the two video nets train; the image G and the image D (up to
its h2 tap) are frozen and run in inference mode. The vid-D's batch norm
always uses batch moments; the image nets' use their running moments.
D's loss is the sigmoid cross-entropy of real clips against 1 and fake
clips against 0; G's is that of fake clips against 1 plus
first_frame_loss_scalar times the mean squared distance of each clip's
first frame latent from the first z_output_size entries of its z.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference._plain import (FLOAT32, Adam, Precision,
                                        batch_norm, conv, deconv,
                                        grads_of, keep_first, leaf_norms,
                                        linear, lrelu, sigmoid_ce, tf32)

Tensor = torch.Tensor


def _vid_d_size(cfg: Dict) -> int:
    """Inputs of the vid-D's linear: three stride-2 SAME conv3ds."""
    t, hw = cfg["vid_length"], cfg["image_gan"]["output_size"] // 8
    for _ in range(3):
        t, hw = (t + 1) // 2, (hw + 1) // 2
    return t * hw * hw * cfg["d_filters"]


def param_specs(cfg: Dict) -> Dict[str, tuple]:
    """{flat key: (shape, init)}; init is "trunc" (normal, std 0.02, cut at
    2 std), "normal" (std 0.02), "zeros" or "ones"."""
    img = cfg["image_gan"]
    gf, df, c, s16 = (img["gf_dim"], img["df_dim"], img["c_dim"],
                      img["output_size"] // 16)
    h, f = cfg["hidden_dim"], cfg["d_filters"]
    specs: Dict[str, tuple] = {}

    def lin(key, n_in, n_out):
        specs[f"params/{key}/w"] = ((n_in, n_out), "normal")
        specs[f"params/{key}/b"] = ((n_out,), "zeros")

    def cnv(key, n_out, n_in, k=5, nd=2, init="trunc"):
        specs[f"params/{key}/w"] = ((n_out, n_in) + (k,) * nd, init)
        specs[f"params/{key}/b"] = ((n_out,), "zeros")

    def dcv(key, n_in, n_out):
        specs[f"params/{key}/w"] = ((n_in, n_out, 5, 5), "normal")
        specs[f"params/{key}/b"] = ((n_out,), "zeros")

    def bn(net, name, n):
        specs[f"params/{net}/{name}/scale"] = ((n,), "ones")
        specs[f"params/{net}/{name}/bias"] = ((n,), "zeros")
        specs[f"state/{net}/{name}/mean"] = ((n,), "zeros")
        specs[f"state/{net}/{name}/var"] = ((n,), "ones")

    lin("vid_generator/lin0", cfg["z_input_size"] + 1, h)
    lin("vid_generator/lin1", h, h)
    lin("vid_generator/lin2", h, h)
    lin("vid_generator/lin3", h, cfg["z_output_size"])
    for i in range(3):
        bn("vid_generator", f"bn{i}", h)
    cnv("vid_discriminator/h1_conv", f, df * 4, k=3, nd=3)
    cnv("vid_discriminator/h2_conv", f, f, k=3, nd=3)
    cnv("vid_discriminator/h3_conv", f, f, k=3, nd=3)
    lin("vid_discriminator/h4_lin", _vid_d_size(cfg), 1)
    for i in (2, 3):
        bn("vid_discriminator", f"bn{i}", f)
    lin("img_generator/h0_lin", img["z_dim"], gf * 8 * s16 * s16)
    chans = [gf * 8, gf * 4, gf * 2, gf, c]
    for i in range(4):
        dcv(f"img_generator/h{i + 1}_deconv", chans[i], chans[i + 1])
        bn("img_generator", f"bn{i}", chans[i])
    chans = [c, df, df * 2, df * 4, df * 8]
    for i in range(4):
        cnv(f"img_discriminator/h{i}_conv", chans[i + 1], chans[i])
    lin("img_discriminator/h3_lin", df * 8 * s16 * s16, 1)
    for i in (1, 2, 3):
        bn("img_discriminator", f"bn{i}", chans[i + 1])
    return specs


def _net(w: Dict[str, Tensor], net: str) -> Dict[str, Tensor]:
    """params/<net>/* and state/<net>/* as one dict keyed "<layer>/<leaf>"
    (BN running moments as "<bn>/mean", "<bn>/var")."""
    out = {}
    for part in ("params", "state"):
        pre = f"{part}/{net}/"
        out.update({k[len(pre):]: v for k, v in w.items()
                    if k.startswith(pre)})
    return out


# ---------------------------------------------------------------------------
# the four nets
# ---------------------------------------------------------------------------

def vid_generator(g: Dict[str, Tensor], z: Tensor, cfg: Dict,
                  p: Precision = FLOAT32) -> Tensor:
    """z (B, z_in) -> frame latents (B*T, z_out): z repeated over the T
    frames with the frame number in linspace(-1, 1, T) appended, then a
    3-layer BN+ReLU MLP (batch moments) and a tanh layer."""
    b, t = z.shape[0], cfg["vid_length"]
    when = torch.linspace(-1.0, 1.0, t, device=z.device)
    h = torch.cat([z[:, None, :].expand(b, t, z.shape[1]),
                   when[None, :, None].expand(b, t, 1)], dim=-1)
    h = h.reshape(b * t, -1)
    for i in range(3):
        h = linear(h, g[f"lin{i}/w"], g[f"lin{i}/b"], p)
        h = torch.relu(batch_norm(h, g[f"bn{i}/scale"], g[f"bn{i}/bias"]))
    return torch.tanh(linear(h, g["lin3/w"], g["lin3/b"], p))


def img_generator(g: Dict[str, Tensor], z: Tensor, cfg: Dict,
                  p: Precision = FLOAT32) -> Tensor:
    """Frozen image G, inference mode: z (N, z_dim) -> (N, s, s, c)."""
    img = cfg["image_gan"]
    s16, gf = img["output_size"] // 16, img["gf_dim"]
    h = linear(z, g["h0_lin/w"], g["h0_lin/b"], p).reshape(-1, s16, s16,
                                                           gf * 8)
    for i in range(4):
        h = torch.relu(batch_norm(h, g[f"bn{i}/scale"], g[f"bn{i}/bias"],
                                  g[f"bn{i}/mean"], g[f"bn{i}/var"]))
        h = deconv(h, g[f"h{i + 1}_deconv/w"], g[f"h{i + 1}_deconv/b"], p)
    return torch.tanh(h)


def img_d_tap(d: Dict[str, Tensor], x: Tensor,
              p: Precision = FLOAT32) -> Tensor:
    """Frozen image D up to its h2 tap, inference mode."""
    h = lrelu(conv(x, d["h0_conv/w"], d["h0_conv/b"], p))
    for i in (1, 2):
        h = conv(h, d[f"h{i}_conv/w"], d[f"h{i}_conv/b"], p)
        h = lrelu(batch_norm(h, d[f"bn{i}/scale"], d[f"bn{i}/bias"],
                             d[f"bn{i}/mean"], d[f"bn{i}/var"]))
    return h


def vid_discriminator(d: Dict[str, Tensor], acts: Tensor, cfg: Dict,
                      p: Precision = FLOAT32) -> Tensor:
    """Tap activations (B*T, h, w, c) -> logits (B, 1): three 3x3x3/2
    conv3ds (lrelu; BN with batch moments on the last two), a linear."""
    t = cfg["vid_length"]
    h = acts.reshape(-1, t, *acts.shape[1:])
    h = lrelu(conv(h, d["h1_conv/w"], d["h1_conv/b"], p))
    for i in (2, 3):
        h = conv(h, d[f"h{i}_conv/w"], d[f"h{i}_conv/b"], p)
        h = lrelu(batch_norm(h, d[f"bn{i}/scale"], d[f"bn{i}/bias"]))
    return linear(h.reshape(h.shape[0], -1), d["h4_lin/w"], d["h4_lin/b"],
                  p)


def fake_acts(nets: Dict, z: Tensor, cfg: Dict, p: Precision = FLOAT32):
    """(tap activations of the generated frames, frame latents)."""
    g_out = vid_generator(nets["vid_generator"], z, cfg, p)
    frames = img_generator(nets["img_generator"], g_out, cfg, p)
    return img_d_tap(nets["img_discriminator"], frames, p), g_out


def frames_of(corpus_u8: Tensor, ids: Tensor, cfg: Dict) -> Tensor:
    """The batch's clips from the uint8 corpus (N, T*s*s*c), scaled to
    [-1, 1], time folded into the batch: (B*T, s, s, c)."""
    img = cfg["image_gan"]
    s = img["output_size"]
    rows = corpus_u8[ids.long()].float()
    return (rows / 127.5 - 1.0).reshape(-1, s, s, img["c_dim"])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_readings(weights: Dict[str, Tensor], corpus_u8: Tensor,
                   steps: List[Dict[str, Tensor]], cfg: Dict,
                   precision: str = "float32") -> Dict:
    """Run the steps (each {"ids": (B,), "z": (B, z_in)}) from `weights`.

    Returns {"loss": [d_loss, g_loss of each step (G's last update)],
    "grad": {param key: norm of the first gradient that its net's Adam
    gets (step 1's D update, step 1's first G update)},
    "change": {param key: norm of its change over all the steps}}."""
    p = Precision(precision)
    nets = {n: _net(weights, n) for n in ("vid_generator",
                                          "vid_discriminator",
                                          "img_generator",
                                          "img_discriminator")}
    trained = ("vid_discriminator", "vid_generator")
    first = {n: {k: v.clone() for k, v in nets[n].items()
                 if not k.endswith(("/mean", "/var"))} for n in trained}
    opt = {n: Adam(first[n], cfg["learning_rate"], cfg["beta1"])
           for n in trained}
    t, z_out = cfg["vid_length"], cfg["z_output_size"]
    losses, grad = [], {}
    with tf32(False):
        for step in steps:
            z = step["z"].float()
            with torch.no_grad():
                real = img_d_tap(nets["img_discriminator"],
                                 frames_of(corpus_u8, step["ids"], cfg), p)
                fake, _ = fake_acts(nets, z, cfg, p)
            for _ in range(cfg["disc_updates"]):
                d = {k: v.detach().requires_grad_(True)
                     for k, v in nets["vid_discriminator"].items()}
                d_loss = (sigmoid_ce(vid_discriminator(d, real, cfg, p), 1.0)
                          + sigmoid_ce(vid_discriminator(d, fake, cfg, p),
                                       0.0))
                train = {k: d[k] for k in first["vid_discriminator"]}
                grads = grads_of(d_loss, train)
                keep_first(grad, "vid_discriminator/", grads)
                new = opt["vid_discriminator"].step(train, grads)
                nets["vid_discriminator"] = dict(
                    nets["vid_discriminator"],
                    **{k: v.detach() for k, v in new.items()})
            for _ in range(cfg["gen_updates"]):
                g = {k: v.detach().requires_grad_(True)
                     for k, v in nets["vid_generator"].items()}
                acts, g_out = fake_acts(dict(nets, vid_generator=g), z, cfg,
                                        p)
                realism = sigmoid_ce(vid_discriminator(
                    nets["vid_discriminator"], acts, cfg, p), 1.0)
                ff = torch.mean((g_out[0::t] - z[:, :z_out]) ** 2)
                g_loss = realism + cfg["first_frame_loss_scalar"] * ff
                train = {k: g[k] for k in first["vid_generator"]}
                grads = grads_of(g_loss, train)
                keep_first(grad, "vid_generator/", grads)
                new = opt["vid_generator"].step(train, grads)
                nets["vid_generator"] = dict(
                    nets["vid_generator"],
                    **{k: v.detach() for k, v in new.items()})
            losses += [float(d_loss.detach()), float(g_loss.detach())]
    change = {f"{n}/{k}": v for n in trained for k, v in leaf_norms(
        {k: nets[n][k] - first[n][k] for k in first[n]}).items()}
    return {"loss": losses, "grad": grad, "change": change}
