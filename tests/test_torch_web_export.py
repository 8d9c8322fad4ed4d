"""The port's browser export (gifgan_tpu_torch/serve/web_export.py)
against the JAX package's (gifgan_tpu/serve/web_export.py), float32 on
the CPU, from the same weights: the JAX init of one key scaled by 3 (so
the golden image is not near-constant), converted through core/interop.py
from_jax_flat.

The JSON carries the JAX layouts whichever package writes it, so the two
documents are equal, and either loads into the other package. The
generators run on one z within 1e-5 (float32 accumulation order through
the deconvs and BN); images compared as uint8 within 1 grey level (a
float32 value on a rounding edge).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gifgan_tpu.core.checkpoint import _flatten_with_paths
from gifgan_tpu.core.config import DCGANConfig as JDCGANConfig
from gifgan_tpu.models import dcgan as jdcgan
from gifgan_tpu.serve import web_export as jweb
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core.config import DCGANConfig
from gifgan_tpu_torch.core.rng import uniform_z
from gifgan_tpu_torch.models import dcgan as tdcgan
from gifgan_tpu_torch.serve import web_export as tweb

_CFG = dict(output_size=32, c_dim=3, z_dim=16, gf_dim=8, df_dim=8)
JCFG, TCFG = JDCGANConfig(**_CFG), DCGANConfig(**_CFG)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread per worker process (tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gen():
    """(JAX generator params, state, port params, state, jitted JAX
    generator) of the boosted init."""
    params, state = jax.jit(jdcgan.init_generator, static_argnums=1)(
        jax.random.PRNGKey(7), JCFG)
    params = jax.tree_util.tree_map(lambda x: x * 3.0, params)
    t = interop.from_jax_flat(
        _flatten_with_paths({"params": params, "state": state}), "cpu")
    fwd = jax.jit(lambda p, s, z: jdcgan.generator(p, s, z, JCFG,
                                                   train=False)[0])
    return params, state, t["params"], t["state"], fwd


def _z(n=2, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 16)).astype(
        np.float32)


def _port_images(p, s, z):
    with torch.no_grad():
        return tdcgan.generator(p, s, torch.from_numpy(z), TCFG,
                                train=False)[0].numpy()


def _u8(img):
    return np.clip(np.round(255.0 * (np.asarray(img) + 1.0) / 2.0), 0,
                   255).astype(int)


def test_json_equals_the_jax_document(gen):
    jp, js, tp, ts, _ = gen
    want = jweb.generator_to_json(jp, js, JCFG)
    got = tweb.generator_to_json(tp, ts, TCFG)
    assert json.loads(got) == json.loads(want)
    assert got == want
    doc = json.loads(got)
    assert doc["format"] == "gifgan_tpu.generator/1"
    assert doc["layers"][2]["w_shape"] == [5, 5, 32, 64]   # TF [h, w, o, i]


def test_documents_load_across_packages(gen):
    """A document of either package loads into the other: the generators
    agree within 1e-5 on one z, and the port's round trip is exact."""
    jp, js, tp, ts, fwd = gen
    z = _z()
    want = np.asarray(fwd(jp, js, jnp.asarray(z)))
    p2, s2, meta = tweb.generator_from_json(
        jweb.generator_to_json(jp, js, JCFG), device="cpu")
    assert meta == {"z_dim": 16, "output_size": 32, "c_dim": 3, "gf_dim": 8}
    np.testing.assert_allclose(_port_images(p2, s2, z), want, rtol=0,
                               atol=1e-5)
    for a, b in zip(interop.to_jax_flat({"p": p2, "s": s2}).values(),
                    interop.to_jax_flat({"p": tp, "s": ts}).values()):
        np.testing.assert_array_equal(a, b)
    jp2, js2, jmeta = jweb.generator_from_json(
        tweb.generator_to_json(tp, ts, TCFG))
    assert jmeta == meta
    np.testing.assert_allclose(np.asarray(fwd(jp2, js2, jnp.asarray(z))),
                               _port_images(tp, ts, z), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="generator/1"):
        tweb.generator_from_json(json.dumps({"format": "other/9",
                                             "layers": []}), device="cpu")


def test_forward_reference_within_one_level_of_the_port(gen):
    """generator_forward_reference, the numpy transcription of
    static/generator.js, against the port's generator on 2 z."""
    _, _, tp, ts, _ = gen
    doc = json.loads(tweb.generator_to_json(tp, ts, TCFG))
    for z in _z(2, 3):
        ref = tweb.generator_forward_reference(doc, z)
        img = _port_images(tp, ts, z[None])[0]
        assert np.abs(_u8(ref) - _u8(img)).max() <= 1


def test_export_browser_demo_matches_the_jax_export(gen, tmp_path):
    """The same file set as the JAX export, the same weights.json, page
    and script; golden.json's z is the port's draw (core/rng.py, seed 0 on
    the CPU) and its image equals the JAX generator on that z within one
    grey level."""
    jp, js, tp, ts, fwd = gen
    out = tweb.export_browser_demo(tp, ts, TCFG, str(tmp_path / "t"))
    jout = jweb.export_browser_demo(jp, js, JCFG, str(tmp_path / "j"))
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(jout)) == [
        "draw.html", "generator.js", "golden.json", "weights.json"]
    for n in ("draw.html", "generator.js", "weights.json"):
        with open(os.path.join(out, n), "rb") as a, \
                open(os.path.join(jout, n), "rb") as b:
            assert a.read() == b.read(), n
    with open(os.path.join(out, "golden.json")) as f:
        golden = json.load(f)
    z = np.asarray(golden["z"], np.float32)
    np.testing.assert_array_equal(
        z, uniform_z(torch.Generator().manual_seed(0), (1, 16))[0].numpy())
    want = _u8(np.asarray(fwd(jp, js, jnp.asarray(z[None])))[0])
    assert golden["shape"] == [32, 32, 3]
    assert np.abs(np.asarray(golden["image_u8"]) - want.ravel()).max() <= 1
    ref = tweb.generator_forward_reference(
        json.load(open(os.path.join(out, "weights.json"))), z)
    assert np.abs(_u8(ref).ravel() - np.asarray(golden["image_u8"])).max() \
        <= 1
