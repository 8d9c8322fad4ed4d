"""Export generator weights to JSON for in-browser inference
(gifgan_tpu/serve/web_export.py).

Rebuild of the reference's convnet.js weight export (utils.py:69-130
`to_json`, consumed by models/recurrent_z/web/js/app.js): the image
generator's parameters serialized layer-by-layer so a browser-side forward
pass can run draw-your-own-z demos without a server round trip.

Schema (documented, versioned — independent of any one JS framework):
{
  "format": "gifgan_tpu.generator/1",
  "z_dim", "output_size", "c_dim", "gf_dim",
  "layers": [
    {"name": "h0_lin", "type": "linear", "w": [[...]], "b": [...]},
    {"name": "bn0", "type": "batch_norm", "scale": [...], "bias": [...],
     "mean": [...], "var": [...]},
    {"name": "h1_deconv", "type": "deconv2d", "stride": 2,
     "w_shape": [5,5,out,in], "w": [...flat...], "b": [...]},
    ...
  ]
}

The document carries the JAX package's layouts (TF's `[h, w, out, in]`
deconv weights, which static/generator.js reads), whatever package wrote
it: the port's `(in, out, h, w)` tensors cross through core/interop.py
both ways, so a file that either package exports loads in the same
draw.html and into the other package. The golden z of
`export_browser_demo` is drawn from core/rng.py (a torch.Generator), not
from a threefry key, and its image is rendered in float32 (the JAX
package renders it in the run's compute dtype).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict

import numpy as np
import torch

from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core.rng import uniform_z
from gifgan_tpu_torch.serve import STATIC_DIR

FORMAT = "gifgan_tpu.generator/1"
_ORDER = ["h0_lin", "bn0", "h1_deconv", "bn1", "h2_deconv", "bn2",
          "h3_deconv", "bn3", "h4_deconv"]
_META = ("z_dim", "output_size", "c_dim", "gf_dim")


def generator_to_json(params: Dict, state: Dict, cfg) -> str:
    """The generator's params and BN state (port tensors, any device) as a
    v1 document, in the JAX package's layouts and number formatting."""
    flat = interop.to_jax_flat({"params": params, "state": state})

    def a(kind, name, leaf):
        return flat[f"{kind}/{name}/{leaf}"]

    layers = []
    for name in _ORDER:
        if name.startswith("bn"):
            layers.append({
                "name": name, "type": "batch_norm",
                "scale": a("params", name, "scale").tolist(),
                "bias": a("params", name, "bias").tolist(),
                "mean": a("state", name, "mean").tolist(),
                "var": a("state", name, "var").tolist(),
                "eps": 1e-5,
            })
        elif name.endswith("_lin"):
            layers.append({
                "name": name, "type": "linear",
                "w": a("params", name, "w").tolist(),
                "b": a("params", name, "b").tolist(),
            })
        else:
            w = a("params", name, "w")
            layers.append({
                "name": name, "type": "deconv2d", "stride": 2,
                "w_shape": list(w.shape),
                "w": w.ravel().tolist(),
                "b": a("params", name, "b").tolist(),
            })
    return json.dumps({
        "format": FORMAT,
        "z_dim": cfg.z_dim,
        "output_size": cfg.output_size,
        "c_dim": cfg.c_dim,
        "gf_dim": cfg.gf_dim,
        "layers": layers,
    })


def generator_from_json(text: str, device=None):
    """Inverse of generator_to_json — returns (params, state, meta), port
    tensors on `device` (None: the card) usable by
    gifgan_tpu_torch.models.dcgan.generator."""
    doc = json.loads(text)
    if doc.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} document: format "
                         f"{doc.get('format')!r}")
    flat = {}
    for layer in doc["layers"]:
        name, typ = layer["name"], layer["type"]
        if typ == "batch_norm":
            for kind, leaf in (("params", "scale"), ("params", "bias"),
                               ("state", "mean"), ("state", "var")):
                flat[f"{kind}/{name}/{leaf}"] = np.asarray(layer[leaf],
                                                           np.float32)
        elif typ == "linear":
            flat[f"params/{name}/w"] = np.asarray(layer["w"], np.float32)
            flat[f"params/{name}/b"] = np.asarray(layer["b"], np.float32)
        else:
            flat[f"params/{name}/w"] = np.asarray(
                layer["w"], np.float32).reshape(layer["w_shape"])
            flat[f"params/{name}/b"] = np.asarray(layer["b"], np.float32)
    tree = interop.from_jax_flat(flat, device)
    meta = {k: doc[k] for k in _META}
    return tree["params"], tree["state"], meta


def export_browser_demo(params, state, cfg, out_dir: str, key=None) -> str:
    """Write a self-contained browser demo dir: weights.json (v1 schema),
    golden.json (a server-rendered z/image pair for the page's ?selftest=1
    pixel-parity check), plus generator.js + draw.html copied from this
    package's static/. The golden image is the generator on the params'
    device in float32 with TF32 off, whatever cfg.compute_dtype says, as
    generator.js computes in float32; its z comes from `key`, a
    torch.Generator (None: the CPU generator of seed 0). Returns
    out_dir."""
    from gifgan_tpu_torch.models import dcgan
    from gifgan_tpu_torch.ops.quant import _true_float32

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "weights.json"), "w") as f:
        f.write(generator_to_json(params, state, cfg))
    key = key if key is not None else torch.Generator().manual_seed(0)
    device = params["h0_lin"]["w"].device
    z = uniform_z(key, (1, cfg.z_dim)).to(device)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.no_grad(), _true_float32():
        img, _ = dcgan.generator(params, state, z, f32, train=False)
    u8 = np.clip(np.round(255.0 * (img[0].float().cpu().numpy() + 1.0)
                          / 2.0), 0, 255).astype(int)
    with open(os.path.join(out_dir, "golden.json"), "w") as f:
        json.dump({"z": z[0].cpu().numpy().tolist(),
                   "image_u8": u8.ravel().tolist(),
                   "shape": list(u8.shape)}, f)
    for name in ("generator.js", "draw.html"):
        shutil.copy(os.path.join(STATIC_DIR, name),
                    os.path.join(out_dir, name))
    return out_dir


def generator_forward_reference(doc: Dict, z) -> np.ndarray:
    """Numpy transcription of static/generator.js — its executable spec.

    Mirrors the JS op-for-op (linear -> bn0 -> relu -> 3x[scatter-deconv ->
    bn -> relu] -> deconv -> tanh, NHWC row-major, inference-mode BN, the
    scatter formulation of conv2d_transpose SAME stride 2). Tested against
    models/dcgan.generator to <=1 u8; browsers run the same algorithm via
    draw.html?selftest=1 against the exported golden.json.
    """
    layers = {l["name"]: l for l in doc["layers"]}
    s16 = doc["output_size"] // 16

    def linear(zv, l):
        return np.asarray(zv, np.float32) @ np.asarray(l["w"], np.float32) \
            + np.asarray(l["b"], np.float32)

    def bn(t, l):
        inv = np.asarray(l["scale"], np.float32) / np.sqrt(
            np.asarray(l["var"], np.float32) + l.get("eps", 1e-5))
        return (t - np.asarray(l["mean"], np.float32)) * inv \
            + np.asarray(l["bias"], np.float32)

    def deconv(t, l):
        k, _, oc, ic = l["w_shape"]
        stride = l.get("stride", 2)
        w = np.asarray(l["w"], np.float32).reshape(k, k, oc, ic)
        h_in, w_in = t.shape[:2]
        out_h, out_w = h_in * stride, w_in * stride
        top = k - 1 - max(k - stride, 0) // 2
        out = np.zeros((out_h, out_w, oc), np.float32) \
            + np.asarray(l["b"], np.float32)
        for i in range(h_in):
            for j in range(w_in):
                for a in range(k):
                    y = stride * i + top - a
                    if not (0 <= y < out_h):
                        continue
                    for b in range(k):
                        x = stride * j + top - b
                        if not (0 <= x < out_w):
                            continue
                        out[y, x] += w[k - 1 - a, k - 1 - b] @ t[i, j]
        return out

    t = linear(z, layers["h0_lin"]).reshape(s16, s16, doc["gf_dim"] * 8)
    t = np.maximum(bn(t, layers["bn0"]), 0.0)
    for i in range(1, 4):
        t = deconv(t, layers[f"h{i}_deconv"])
        t = np.maximum(bn(t, layers[f"bn{i}"]), 0.0)
    t = deconv(t, layers["h4_deconv"])
    return np.tanh(t)
