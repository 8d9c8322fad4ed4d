"""Post-training int8 quantization for serving (gifgan_tpu/ops/quant.py).

The serving forward is pure inference: BatchNorm uses its running moments
and the weights are frozen. The recipe and the names are the JAX
package's:

  1. fold inference-mode BN into the preceding linear or deconv
     (ops/nn.py fold_bn: w' = w * g, b' = (b - mean) * g + beta,
     g = scale * rsqrt(var + eps));
  2. quantize the folded weights to int8 per OUTPUT channel (symmetric,
     scale = max|w'| / 127);
  3. quantize activations per tensor, dynamically (scale from max|x|, a
     0-d tensor that stays on the device) or with a calibrated static
     scale ('as');
  4. contract int8 x int8 -> int32;
  5. dequantize: y = acc * (s_x * s_w[o]) + b', then the nonlinearity in
     float32.

Weights are in the port's layouts (core/interop.py): linear (in, out) and
deconv (in, out, k, k) quantize along axis 1, conv2d OIHW along axis 0.
Activations are NHWC, as at every layer boundary of the port.

The JAX package contracts through XLA (preferred_element_type=int32). Here
every contraction is one int8 matrix product, `int8_matmul`, through
torch._int_mm (the card's int8 tensor cores), over an int8 im2col for the
convolutions. The 5x5 stride-2 deconv takes the sub-pixel form of
ops/nn.py _deconv2d_subpixel (a 3x3 conv to 4*out channels, then
depth-to-space): 9 taps a row instead of the 25 of the lhs-dilated form,
whose im2col would be 4x the input's pixels. Integer sums do not depend on
their order, so each accumulator equals the JAX package's exactly.

Float layers of a mixed-precision tree ({'w', 'b'}: float_last,
float_layers) run in true float32, TF32 off, as the JAX package's do.

Forward only: the int8 products have no gradient. finish_vid_stack trains
through a fake-quant float graph instead.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core import checkpoint as ckpt
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core.config import (DCGANConfig, VidGANConfig,
                                          load_config, save_config)
from gifgan_tpu_torch.core.rng import PRNGSequence, uniform_z
from gifgan_tpu_torch.core.tree import flatten, unflatten
from gifgan_tpu_torch.models.vid_dcgan import frame_inputs
from gifgan_tpu_torch.ops import nn
from gifgan_tpu_torch.ops.nn import fold_bn, tile_bn
from gifgan_tpu_torch.parallel import collectives

Tensor = torch.Tensor

# int8 symmetric range. 127 (not 128) keeps the grid symmetric so that
# negating an input negates its quantization exactly.
QMAX = 127.0

# torch._int_mm on the card checks for more than 16 rows and inner and
# column sizes that are multiples of 8, and cuBLASLt then refused 17 rows
# (CUBLAS_STATUS_NOT_SUPPORTED, H100, torch 2.11), so int8_matmul pads rows
# to a multiple of 8, at least 32, and k and n to multiples of 8
_MIN_ROWS, _ALIGN = 32, 8


# ---------------------------------------------------------------------------
# weight / activation quantization
# ---------------------------------------------------------------------------

def _quantize(x32: Tensor, scale: Tensor) -> Tensor:
    """round(x / scale) on the int8 grid: a division, not a product with
    the reciprocal, and round half to even, as jnp.round."""
    return torch.clamp(torch.round(x32 / scale), -QMAX, QMAX).to(torch.int8)


def quantize_weight(layer: Dict, out_axis: int) -> Dict:
    """{'w', 'b'} float layer -> {'wq' int8, 'ws' f32 per-out-channel, 'b'}."""
    w = layer["w"].float()
    axes = tuple(a for a in range(w.ndim) if a != out_axis)
    scale = torch.clamp_min(torch.amax(torch.abs(w), dim=axes) / QMAX,
                            1e-12)                       # all-zero channels
    shape = [1] * w.ndim
    shape[out_axis] = -1
    return {"wq": _quantize(w, scale.reshape(shape)), "ws": scale,
            "b": layer["b"].float()}


def quantize_act(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Dynamic per-tensor symmetric quantization: (x_q int8, scale f32[]).
    The scale is a 0-d tensor on x's device: no host sync. In a mesh
    step its max covers the whole logical batch
    (parallel/collectives.py)."""
    x32 = x.float()
    scale = torch.clamp_min(
        collectives.batch_max(torch.amax(torch.abs(x32))) / QMAX, 1e-12)
    return _quantize(x32, scale), scale


# Candidate fractions of the max-derived scale swept by MSE calibration
# (calibrate_* mode="mse"). 1.0 = plain max-abs; smaller fractions trade
# clipping of the tail against finer resolution for the bulk.
MSE_FRACTIONS = tuple(round(0.30 + 0.05 * i, 2) for i in range(15))  # .30–1.0


def _mse_sweep(x32: Tensor, s_base: Tensor) -> Tensor:
    """Quantization MSE of x under each candidate scale s_base * f for f in
    MSE_FRACTIONS -> (len(MSE_FRACTIONS),), one fraction at a time so the
    peak memory holds one copy of x."""
    out = []
    for f in torch.tensor(MSE_FRACTIONS, dtype=torch.float32,
                          device=x32.device):
        s = s_base * f
        err = torch.clamp(torch.round(x32 / s), -QMAX, QMAX) * s - x32
        out.append(torch.mean(err * err))
    return torch.stack(out)


def _act(x: Tensor, q: Dict, obs=None, key: str = None
         ) -> Tuple[Tensor, Tensor]:
    """One layer's activation quantization: static when the layer carries a
    calibrated scale ('as'), dynamic otherwise.

    obs: optional dict for calibration; records this layer's max|x| (a 0-d
    tensor) under `key`. On a layer that already carries 'as' (a second
    calibration pass) it records {'max', 'mse'}: the quantization-MSE sweep
    over MSE_FRACTIONS of that scale, which mse-mode calibration refines
    'as' from."""
    if obs is not None:
        x32 = x.float()
        m = torch.amax(torch.abs(x32))
        obs[key] = ({"max": m, "mse": _mse_sweep(x32, q["as"])}
                    if "as" in q else m)
    if "as" in q:
        return _quantize(x.float(), q["as"]), q["as"]
    return quantize_act(x)


def _obs_out(y: Tensor, obs, key) -> Tensor:
    """Record a layer's per-output-channel PRE-ACTIVATION output mean under
    obs['__out_mean__'][key]: the evidence bias_correct_* matches against
    the float reference's means."""
    if obs is not None and key is not None:
        obs.setdefault("__out_mean__", {})[key] = torch.mean(
            y.float(), dim=tuple(range(y.ndim - 1)))
    return y


@contextlib.contextmanager
def _true_float32():
    """TF32 off for the float layers: cuDNN convolutions take TF32 on the
    card by default, and the JAX package's float layers are float32."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def _float_deconv(layer: Dict, x: Tensor) -> Tensor:
    with _true_float32():
        return nn.deconv2d(layer, x.float(), dtype=torch.float32)


def _affine(layer: Dict, x: Tensor) -> Tensor:
    with _true_float32():
        return x.float() @ layer["w"] + layer["b"]


# ---------------------------------------------------------------------------
# the int8 contractions
# ---------------------------------------------------------------------------

def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a: Tensor, b: Tensor) -> Tensor:
    """(m, k) int8 @ (k, n) int8 -> (m, n) int32 through torch._int_mm.

    Pads with zero rows and columns to what _int_mm takes on the card (rows
    a multiple of 8 and at least 32, k and n multiples of 8) and slices the
    result: exact, since the padding adds integer zeros. The same code runs
    on the CPU."""
    m, k = a.shape
    n = b.shape[1]
    mp = max(_ceil_to(m, _ALIGN), _MIN_ROWS)
    kp, np_ = _ceil_to(k, _ALIGN), _ceil_to(n, _ALIGN)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    # b column-major: cuBLASLt's int8 kernels take the "TN" layout; with a
    # row-major b the flagship deconv products ran 3.6-5.9x slower (H100)
    out = torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return out[:m, :n]


def _im2col(xp: Tensor, k: int, stride: int) -> Tensor:
    """Padded NHWC int8 xp -> (B, Ho, Wo, k*k*C), columns in (kh, kw, C)
    order: one copy from a strided view (F.unfold takes floats only). The
    copy moves each pixel's C channels in the widest integer that divides
    them (8 bytes for the generators' channel counts): 3.4-3.9x faster
    than byte by byte at the flagship shapes (H100)."""
    c = xp.shape[-1]
    unit = next(t for t in (torch.int64, torch.int32, torch.int16,
                            torch.int8) if c % t.itemsize == 0)
    cols = xp.contiguous().view(unit).unfold(1, k, stride).unfold(
        2, k, stride)
    b, ho, wo, cu = cols.shape[:4]                    # (B,Ho,Wo,C',kh,kw)
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(
        b, ho, wo, k * k * cu).view(torch.int8)


def _contract(cols: Tensor, wmat: Tensor) -> Tensor:
    """(B, Ho, Wo, K) im2col @ (K, N) -> (B, Ho, Wo, N) int32."""
    acc = int8_matmul(cols.reshape(-1, cols.shape[-1]), wmat)
    return acc.reshape(*cols.shape[:3], wmat.shape[1])


def _linear_acc(xq: Tensor, wq: Tensor) -> Tensor:
    """int32 accumulator of an int8 linear layer, (in, out) weights."""
    return int8_matmul(xq, wq)


def _conv_acc(xq: Tensor, wq: Tensor, stride: int) -> Tensor:
    """int32 accumulator of a TF-SAME conv: NHWC int8 x, OIHW int8 w."""
    k = wq.shape[-1]
    xp = F.pad(xq, [0, 0] + nn._same_pads(xq.shape[1:3], k, stride))
    wmat = wq.permute(2, 3, 1, 0).reshape(-1, wq.shape[0])  # (kh,kw,I) x O
    return _contract(_im2col(xp, k, stride), wmat)


def _subpixel_weight(wq: Tensor) -> Tensor:
    """(in, out, 5, 5) deconv weights -> the (9*in, 4*out) matrix of the
    sub-pixel form (ops/nn.py _deconv2d_subpixel): rows (r, s, in), columns
    (row phase, column phase, out); tap 5 is a zero."""
    in_ch, out_ch = wq.shape[:2]
    wp = F.pad(wq, (0, 1, 0, 1))
    idx = nn._taps(((3, 1, 5), (4, 2, 0)), wq.device)
    kern = wp[:, :, idx[:, :, None, None], idx[None, None, :, :]]
    # (i, o, a, r, b, s) -> ((r, s, i), (a, b, o))
    return kern.permute(3, 5, 0, 2, 4, 1).reshape(9 * in_ch, 4 * out_ch)


def _deconv_cols(xq: Tensor) -> Tensor:
    """The sub-pixel form's im2col of NHWC int8 x (B, m, n, in): its 3x3
    windows at stride 1 over x padded by 1 -> (B, m, n, 9*in)."""
    return _im2col(F.pad(xq, (0, 0, 1, 1, 1, 1)), 3, 1)


def _deconv_acc(xq: Tensor, wq: Tensor) -> Tensor:
    """int32 accumulator of tf.nn.conv2d_transpose SAME, 5x5 stride 2:
    NHWC int8 x (B, m, n, in), (in, out, 5, 5) int8 w -> (B, 2m, 2n, out)."""
    if wq.shape[-2:] != (5, 5):
        raise ValueError(f"the int8 deconv is the 5x5 stride-2 sub-pixel "
                         f"form; got a {tuple(wq.shape[-2:])} kernel")
    bsz, m, n = xq.shape[:3]
    out_ch = wq.shape[1]
    acc = _contract(_deconv_cols(xq), _subpixel_weight(wq))
    acc = acc.reshape(bsz, m, n, 2, 2, out_ch).permute(0, 1, 3, 2, 4, 5)
    return acc.reshape(bsz, 2 * m, 2 * n, out_ch)


# ---------------------------------------------------------------------------
# quantized layers (signatures mirror ops/nn.py)
# ---------------------------------------------------------------------------

def _dequant(acc: Tensor, s_x: Tensor, q: Dict) -> Tensor:
    return acc.float() * (s_x * q["ws"]) + q["b"]


def _is_q(layer: Dict) -> bool:
    """True for an int8 layer ({'wq','ws','b'}), False for a float
    ({'w','b'}) layer in a mixed-precision serving tree."""
    return "wq" in layer


def qlinear(q: Dict, x: Tensor, obs=None, key: str = None) -> Tensor:
    """int8 counterpart of nn.linear ((in, out) weights). Float layers in a
    mixed-precision tree run the plain float32 affine."""
    if not _is_q(q):
        return _obs_out(_affine(q, x), obs, key)
    xq, s_x = _act(x, q, obs, key)
    return _obs_out(_dequant(_linear_acc(xq, q["wq"]), s_x, q), obs, key)


def qconv2d(q: Dict, x: Tensor, stride: int = 2, obs=None,
            key: str = None) -> Tensor:
    """int8 counterpart of nn.conv2d (OIHW weights, TF SAME)."""
    xq, s_x = _act(x, q, obs, key)
    return _obs_out(_dequant(_conv_acc(xq, q["wq"], stride), s_x, q),
                    obs, key)


def qdeconv2d(q: Dict, x: Tensor, stride: int = 2, obs=None,
              key: str = None) -> Tensor:
    """int8 counterpart of nn.deconv2d, 5x5 stride 2 ((in, out, k, k)
    weights). Float layers in a mixed-precision tree run the float32
    deconv."""
    if not _is_q(q):
        return _obs_out(_float_deconv(q, x), obs, key)
    if stride != 2:
        raise ValueError(f"the int8 deconv has stride 2, not {stride}")
    xq, s_x = _act(x, q, obs, key)
    return _obs_out(_dequant(_deconv_acc(xq, q["wq"]), s_x, q), obs, key)


# ---------------------------------------------------------------------------
# model-level: image DCGAN generator (models/dcgan.py, train=False)
# ---------------------------------------------------------------------------

def _as_float_layer(folded: Dict) -> Dict:
    return {"w": folded["w"].float(), "b": folded["b"].float()}


def quantize_image_generator(params: Dict, state: Dict,
                             float_last: bool = False,
                             float_layers: Tuple[str, ...] = ()) -> Dict:
    """Float generator params + BN running state -> int8 serving params.

    bn{i} folds into the layer it normalizes: h0_lin -> bn0 (tiled over the
    s16 x s16 reshape positions), h{1..3}_deconv -> bn{1..3}; h4_deconv has
    no BN. Layers named in `float_layers` (and h4_deconv when float_last)
    stay float32 {'w','b'}, BN still folded, and the q forwards dispatch per
    layer on the tree structure (_is_q)."""
    fl = set(float_layers) | ({"h4_deconv"} if float_last else set())
    reps = params["h0_lin"]["w"].shape[1] // params["bn0"]["scale"].shape[0]

    def mk(name, folded):
        return (_as_float_layer(folded) if name in fl
                else quantize_weight(folded, out_axis=1))

    q = {"h0_lin": mk("h0_lin", fold_bn(params["h0_lin"],
                                        tile_bn(params["bn0"], reps),
                                        tile_bn(state["bn0"], reps), 1)),
         "h4_deconv": mk("h4_deconv", params["h4_deconv"])}
    for i, name in enumerate(["h1_deconv", "h2_deconv", "h3_deconv"]):
        q[name] = mk(name, fold_bn(params[name], params[f"bn{i + 1}"],
                                   state[f"bn{i + 1}"], out_axis=1))
    return q


def image_generator_q(q: Dict, z: Tensor, cfg: DCGANConfig,
                      obs=None) -> Tensor:
    """Quantized mirror of dcgan.generator(..., train=False): z (B, z_dim)
    -> images (B, s, s, c) in [-1, 1]. obs: calibration capture dict."""
    s16 = cfg.output_size // 16
    h = qlinear(q["h0_lin"], z, obs, "h0_lin")
    h = torch.relu(h.reshape(-1, s16, s16, cfg.gf_dim * 8))
    for name in ("h1_deconv", "h2_deconv", "h3_deconv"):
        h = torch.relu(qdeconv2d(q[name], h, obs=obs, key=name))
    return torch.tanh(qdeconv2d(q["h4_deconv"], h, obs=obs, key="h4_deconv"))


# ---------------------------------------------------------------------------
# model-level: VID_DCGAN serving stack (vid-G MLP + nested image G)
# ---------------------------------------------------------------------------

def quantize_vid_stack(params: Dict, state: Dict, float_last: bool = False,
                       float_layers: Tuple[str, ...] = ()) -> Dict:
    """The port's video-GAN params and BN state (models/vid_dcgan.py) ->
    int8 serving tree {'vid', 'img'} of the whole generate_videos forward.

    float_last keeps the image generator's tanh output layer float32;
    float_layers names layers to keep float32 as "vid/lin0" or
    "img/h1_deconv"."""
    fl = set(float_layers)
    vid_fl = {n.split("/", 1)[1] for n in fl if n.startswith("vid/")}
    img_fl = tuple(n.split("/", 1)[1] for n in fl if n.startswith("img/"))
    vg, vs = params["vid_generator"], state["vid_generator"]

    def mk(name, folded):
        return (_as_float_layer(folded) if name in vid_fl
                else quantize_weight(folded, out_axis=1))

    qvid = {"lin3": mk("lin3", vg["lin3"])}
    for i in range(3):
        qvid[f"lin{i}"] = mk(f"lin{i}", fold_bn(vg[f"lin{i}"], vg[f"bn{i}"],
                                                vs[f"bn{i}"], out_axis=1))
    return {"vid": qvid,
            "img": quantize_image_generator(params["img_generator"],
                                            state["img_generator"],
                                            float_last=float_last,
                                            float_layers=img_fl)}


def vid_generator_q(qvid: Dict, z: Tensor, cfg: VidGANConfig,
                    obs=None) -> Tensor:
    """Quantized mirror of vid_dcgan.vid_generator(..., train=False):
    z (B, z_in) -> per-frame latents (B*T, z_out) in [-1, 1]."""
    h = frame_inputs(z, cfg)
    for i in range(3):
        h = torch.relu(qlinear(qvid[f"lin{i}"], h, obs, f"lin{i}"))
    return torch.tanh(qlinear(qvid["lin3"], h, obs, "lin3"))


def generate_videos_q(q: Dict, z: Tensor, cfg: VidGANConfig, obs=None
                      ) -> Tuple[Tensor, Tensor]:
    """Quantized mirror of vid_dcgan.generate_videos (inference): z (B, z_in)
    -> (frames (B*T, s, s, c), per-frame latents (B*T, z_out))."""
    vobs = None if obs is None else obs.setdefault("vid", {})
    iobs = None if obs is None else obs.setdefault("img", {})
    g_out = vid_generator_q(q["vid"], z, cfg, obs=vobs)
    frames = image_generator_q(q["img"], g_out, cfg.image_gan, obs=iobs)
    return frames, g_out


def image_generator_folded(params: Dict, state: Dict, z: Tensor,
                           cfg: DCGANConfig) -> Tensor:
    """float32 forward with BN pre-folded (no int8): the target that
    separates quantization error from folding error."""
    s16 = cfg.output_size // 16
    reps = params["h0_lin"]["w"].shape[1] // params["bn0"]["scale"].shape[0]
    h = _affine(fold_bn(params["h0_lin"], tile_bn(params["bn0"], reps),
                        tile_bn(state["bn0"], reps), 1), z)
    h = torch.relu(h.reshape(-1, s16, s16, cfg.gf_dim * 8))
    for i, name in enumerate(["h1_deconv", "h2_deconv", "h3_deconv"]):
        folded = fold_bn(params[name], params[f"bn{i + 1}"],
                         state[f"bn{i + 1}"], 1)
        h = torch.relu(_float_deconv(folded, h))
    return torch.tanh(_float_deconv(params["h4_deconv"], h))


# ---------------------------------------------------------------------------
# static activation calibration
# ---------------------------------------------------------------------------

def _device(tree) -> torch.device:
    return next(iter(flatten(tree).values())).device


def _to_host(tree) -> Dict:
    """A capture tree of float32 device tensors -> the same of numpy arrays,
    in one device-to-host copy."""
    flat = flatten(tree)
    if not flat:
        return {}
    host = torch.cat([v.reshape(-1) for v in flat.values()]).cpu().numpy()
    out, i = {}, 0
    for key, v in flat.items():
        out[key] = host[i:i + v.numel()].reshape(tuple(v.shape))
        i += v.numel()
    return unflatten(out)


def _observe(forward, q: Dict, z, cfg) -> Dict:
    """One calibration forward of `forward` (generate_videos_q or
    image_generator_q) with a capture dict, pulled to the host at once."""
    obs: Dict = {}
    with torch.no_grad():
        forward(q, torch.as_tensor(z, device=_device(q)), cfg, obs=obs)
    return _to_host(obs)


def _with_scales(q: Dict, obs: Dict, margin: float) -> Dict:
    """Copy of a quantized layer tree with static activation scales 'as'
    installed from the observed per-layer max|x|: a Python float, then
    float32, as in the JAX package."""
    out = {}
    for name, layer in q.items():
        out[name] = layer
        if _is_q(layer):
            out[name] = dict(layer)
            if name in obs:
                m = float(obs[name])
                out[name]["as"] = torch.tensor(
                    np.float32(max(m * margin, 1e-10) / QMAX),
                    device=layer["ws"].device)
    return out


def _fold_maxima(maxima: Dict, observed: Dict) -> None:
    """Merge one batch's observed max|x| tree (nested one level) into the
    running host-side maxima. Skips '__out_mean__' (bias correction's
    channel) and, on a second-pass capture ({'max','mse'} per layer), folds
    max|x| and SUMS the MSE sweep."""
    for k, v in observed.items():
        if k == "__out_mean__":
            continue
        if isinstance(v, dict) and "mse" in v:
            slot = maxima.setdefault(k, {"max": 0.0, "mse": 0.0})
            slot["max"] = max(slot["max"], float(v["max"]))
            slot["mse"] = slot["mse"] + np.asarray(v["mse"], np.float64)
        elif isinstance(v, dict):
            _fold_maxima(maxima.setdefault(k, {}), v)
        else:
            maxima[k] = max(maxima.get(k, 0.0), float(v))


def _refine_scales_mse(q: Dict, swept: Dict) -> Dict:
    """Copy of a calibrated layer tree with each static 'as' replaced by
    as * argmin-MSE fraction (float32 product)."""
    out = {}
    for name, layer in q.items():
        out[name] = layer
        if "as" in layer and isinstance(swept.get(name), dict):
            best = MSE_FRACTIONS[int(np.argmin(swept[name]["mse"]))]
            out[name] = dict(layer)
            out[name]["as"] = layer["as"] * torch.tensor(
                best, dtype=torch.float32, device=layer["as"].device)
    return out


def _sweep(forward, q: Dict, z_batches, cfg) -> Dict:
    maxima: Dict = {}
    for z in z_batches:
        _fold_maxima(maxima, _observe(forward, q, z, cfg))
    return maxima


def calibrate_vid_stack(q: Dict, z_batches, cfg: VidGANConfig,
                        margin: float = 1.05, mode: str = "max") -> Dict:
    """Static activation calibration of the whole serving stack: run the
    quantized forward over the calibration z batches recording each layer's
    max|x|, and bake per-layer static scales (x margin of headroom). Inputs
    beyond the calibrated range clip. Returns a new q tree.

    mode="mse": after the max pass, a second pass measures each layer's
    quantization MSE at MSE_FRACTIONS of the max-derived scale and keeps
    the argmin (margin is ignored; the sweep subsumes it)."""
    m1 = margin if mode == "max" else 1.0
    maxima = _sweep(generate_videos_q, q, z_batches, cfg)
    out = {g: _with_scales(q[g], maxima.get(g, {}), m1) for g in ("vid",
                                                                  "img")}
    if mode == "mse":
        swept = _sweep(generate_videos_q, out, z_batches, cfg)
        out = {g: _refine_scales_mse(out[g], swept.get(g, {}))
               for g in ("vid", "img")}
    return out


def calibrate_image_generator(q: Dict, z_batches, cfg: DCGANConfig,
                              margin: float = 1.05, mode: str = "max"
                              ) -> Dict:
    """calibrate_vid_stack for a standalone image generator tree."""
    out = _with_scales(q, _sweep(image_generator_q, q, z_batches, cfg),
                       margin if mode == "max" else 1.0)
    if mode == "mse":
        out = _refine_scales_mse(out, _sweep(image_generator_q, out,
                                             z_batches, cfg))
    return out


# ---------------------------------------------------------------------------
# per-layer bias correction
# ---------------------------------------------------------------------------

_VID_LAYER_ORDER = (("vid", "lin0"), ("vid", "lin1"), ("vid", "lin2"),
                    ("vid", "lin3"), ("img", "h0_lin"), ("img", "h1_deconv"),
                    ("img", "h2_deconv"), ("img", "h3_deconv"),
                    ("img", "h4_deconv"))
_ALL_FLOAT = tuple(f"{g}/{n}" for g, n in _VID_LAYER_ORDER)


def _mean_fold(acc: Dict, obs: Dict) -> None:
    """Accumulate '__out_mean__' captures (nested one level) into running
    float64 per-layer sums (the caller divides by the batch count)."""
    for grp in ("vid", "img"):
        for k, v in obs.get(grp, {}).get("__out_mean__", {}).items():
            acc[(grp, k)] = acc.get((grp, k), 0.0) + np.asarray(v,
                                                                np.float64)


def bias_correct_vid_stack(q: Dict, params: Dict, state: Dict, z_batches,
                           cfg: VidGANConfig) -> Dict:
    """Per-layer empirical bias correction: make each quantized layer's
    per-channel PRE-ACTIVATION output mean over the calibration batches
    match the float (BN-folded) reference's, by folding the difference into
    its bias. Layers are corrected in forward order, recomputing the
    quantized stack's means after each correction. Returns a new q tree;
    weights, scales and the integer contractions are untouched."""
    qf = quantize_vid_stack(params, state, float_layers=_ALL_FLOAT)

    def mean_pass(qq):
        acc: Dict = {}
        for z in z_batches:
            _mean_fold(acc, _observe(generate_videos_q, qq, z, cfg))
        return {k: v / len(z_batches) for k, v in acc.items()}

    ref = mean_pass(qf)
    out = {g: {k: dict(v) for k, v in q[g].items()} for g in q}
    for grp, name in _VID_LAYER_ORDER:
        layer = out[grp][name]
        if not _is_q(layer):
            continue                      # float layers already match
        delta = ref[(grp, name)] - mean_pass(out)[(grp, name)]
        layer["b"] = layer["b"] + torch.as_tensor(
            delta.astype(np.float32), device=layer["b"].device)
    return out


# ---------------------------------------------------------------------------
# fake-quant / STE finishing
# ---------------------------------------------------------------------------

def _ste_round(x: Tensor) -> Tensor:
    """round() with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def _clip_grid(x: Tensor) -> Tensor:
    """clip to [-QMAX, QMAX] as jnp.clip (maximum, then minimum): a value
    exactly on a bound passes half its gradient, where torch.clamp passes
    all of it. A channel's largest weight lands there."""
    return torch.minimum(x.new_full((), QMAX),
                         torch.maximum(x.new_full((), -QMAX), x))


def _fq_weight(w: Tensor) -> Tensor:
    """Fake-quantized weight, out axis 1 (every layer of the stack, linear
    (in, out) and deconv (in, out, k, k)): the forward sees exactly the
    int8 grid of quantize_weight, the gradient passes through the round."""
    axes = tuple(a for a in range(w.ndim) if a != 1)
    scale = torch.clamp_min(torch.amax(torch.abs(w), dim=axes) / QMAX,
                            1e-12).detach()
    s = scale.reshape([1, -1] + [1] * (w.ndim - 2))
    return _clip_grid(_ste_round(w / s)) * s


def _fq_act(x: Tensor, a_scale) -> Tensor:
    """Fake-quantized activation on the static scale, or the dynamic max
    when a_scale is None; STE through the round."""
    if a_scale is None:
        a_scale = torch.clamp_min(torch.amax(torch.abs(x)) / QMAX,
                                  1e-12).detach()
    return _clip_grid(_ste_round(x / a_scale)) * a_scale


def _fq_affine(layer: Dict, x: Tensor, a_scale, name: str) -> Tensor:
    w = _fq_weight(layer["w"])
    xq = _fq_act(x, a_scale)
    if name.endswith("_deconv"):
        return nn.deconv2d({"w": w, "b": layer["b"]}, xq,
                           dtype=torch.float32)
    return xq @ w + layer["b"]


def _fq_generate_videos(wf: Dict, scales: Dict, z: Tensor,
                        cfg: VidGANConfig) -> Tensor:
    """generate_videos_q's graph with fake-quant float layers: the
    finishing forward. wf: all-float folded tree ({'vid','img'} of
    {'w','b'}); scales: same structure of static act scales (or None).

    As in the JAX package, every layer is fake-quantized, the float layers
    of a mixed tree too (their finished weights are then dropped)."""
    h = frame_inputs(z, cfg)
    for i in range(3):
        h = torch.relu(_fq_affine(wf["vid"][f"lin{i}"], h,
                                  scales["vid"].get(f"lin{i}"), f"lin{i}"))
    g_out = torch.tanh(_fq_affine(wf["vid"]["lin3"], h,
                                  scales["vid"].get("lin3"), "lin3"))
    icf = cfg.image_gan
    s16 = icf.output_size // 16
    h = _fq_affine(wf["img"]["h0_lin"], g_out, scales["img"].get("h0_lin"),
                   "h0_lin")
    h = torch.relu(h.reshape(-1, s16, s16, icf.gf_dim * 8))
    for name in ("h1_deconv", "h2_deconv", "h3_deconv"):
        h = torch.relu(_fq_affine(wf["img"][name], h,
                                  scales["img"].get(name), name))
    return torch.tanh(_fq_affine(wf["img"]["h4_deconv"], h,
                                 scales["img"].get("h4_deconv"),
                                 "h4_deconv"))


def _finish_loss(wf: Dict, scales: Dict, ref: Tensor, z: Tensor,
                 cfg: VidGANConfig) -> Tensor:
    """Pixel MSE of the fake-quant forward against the float reference."""
    return torch.mean((_fq_generate_videos(wf, scales, z, cfg) - ref) ** 2)


# the seed of finish_vid_stack's z stream (the JAX package's default)
FINISH_SEED = 23


def finish_vid_stack(q: Dict, params: Dict, state: Dict, cfg: VidGANConfig,
                     steps: int = 500, batch: int = 64,
                     lr: float = 1e-5) -> Dict:
    """Short fake-quant/STE finishing of the serving stack: starting from
    the float FOLDED weights, minimize the pixel L2 between the fake-quant
    forward (the exact int8 grid, STE gradients) and the float folded
    reference over uniform z, with Adam(lr) (optax's); then re-quantize.

    z comes from the port's streams (core/rng.py, seed FINISH_SEED), not
    threefry. q's static activation scales stay fixed and are carried into the
    returned tree; q's float layers are left as they are. The float
    layers run in float32, TF32 off."""
    from gifgan_tpu_torch.train.gan import (Adam, _differentiable, _grads,
                                            apply_updates)

    qf = quantize_vid_stack(params, state, float_layers=_ALL_FLOAT)
    wf = {g: {n: {"w": qf[g][n]["w"], "b": qf[g][n]["b"]} for n in qf[g]}
          for g in qf}
    scales = {g: {n: q[g][n].get("as") for n in q[g]} for g in q}
    opt = Adam(lr)
    opt_state = opt.init(wf)
    stream = PRNGSequence(FINISH_SEED, _device(q))
    with _true_float32():
        for _ in range(steps):
            z = uniform_z(next(stream), (batch, cfg.z_input_size))
            with torch.no_grad():
                ref = generate_videos_q(qf, z, cfg)[0]
            keys, leaves, wft = _differentiable(wf)
            with torch.enable_grad():
                grads = _grads(_finish_loss(wft, scales, ref, z, cfg), keys,
                               leaves)
            updates, opt_state = opt.update(grads, opt_state)
            wf = apply_updates(wf, updates)

    # re-quantize the finished weights; keep q's float layers and scales
    out = {g: {n: dict(layer) for n, layer in q[g].items()} for g in q}
    for grp, name in _VID_LAYER_ORDER:
        layer = out[grp][name]
        if _is_q(layer):
            layer.update(quantize_weight(wf[grp][name], out_axis=1))
    return out


# ---------------------------------------------------------------------------
# deployment artifact: the int8 serving tree as a standalone checkpoint
# ---------------------------------------------------------------------------

def save_artifact(out_dir: str, q: Dict, cfg: VidGANConfig) -> str:
    """Write a quantized serving artifact in the JAX package's format: the
    q tree as checkpoint step 0 (JAX layouts, core/interop.py) plus
    params.json carrying the model config."""
    path = ckpt.save(out_dir, 0, interop.to_jax_flat(q))
    save_config({"model": cfg}, os.path.join(out_dir, "params.json"))
    return path


def load_artifact(out_dir: str, device=None) -> Tuple[Dict, VidGANConfig]:
    """(q tree on `device`, cfg) from a save_artifact dir written by either
    package. The q tree is pure dicts, so it rebuilds from the flat keys
    alone: no float model is needed."""
    device = resolve_device(device)
    q = interop.from_jax_flat(ckpt.load_flat(out_dir), device)
    return q, load_config(os.path.join(out_dir, "params.json"))["model"]
