"""The port's webcam service (gifgan_tpu_torch/serve/webcam.py) against the
JAX package's (gifgan_tpu/serve/webcam.py), float32 on the CPU.

`WebcamBackend.animate` inverts a face with invert/optimize.py
invert_images. The two packages draw the starting latents differently (a
threefry key there, a torch generator here), so the parity test passes
the JAX draw in through `animate(z0=)`. The weights are the JAX init of
one key scaled by 3, as in tests/test_torch_invert.py (at random init the
generator is near-degenerate and dL/dz is at rounding level); the final
loss and the reconstruction agree within 1e-4, the inversion tolerance of
that file. The service cases run 2 steps at batch 2.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import cv2
import jax
import numpy as np
import pytest
import torch

from gifgan_tpu import invert as jinvert
from gifgan_tpu.core.checkpoint import _flatten_with_paths
from gifgan_tpu.core.config import DCGANConfig as JDCGANConfig
from gifgan_tpu.models import dcgan as jdcgan
from gifgan_tpu.serve import webcam as jwebcam
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core.config import DCGANConfig
from gifgan_tpu_torch.ops.image import encode_png
from gifgan_tpu_torch.serve import webcam as twebcam

_CFG = dict(output_size=32, c_dim=3, z_dim=8, gf_dim=8, df_dim=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread per worker process (tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gan():
    """(JAX params, state, port params, state) of the boosted image GAN."""
    params, state = jax.jit(jdcgan.init, static_argnums=1)(
        jax.random.PRNGKey(0), JDCGANConfig(**_CFG))
    boost = lambda t: jax.tree_util.tree_map(lambda x: x * 3.0, t)  # noqa
    params = jdcgan.DCGANParams(boost(params.generator),
                                boost(params.discriminator))
    t = interop.from_jax_flat(
        _flatten_with_paths({"params": params, "state": state}), "cpu")
    return params, state, t["params"], t["state"]


def _face(seed=1):
    return np.random.default_rng(seed).integers(0, 256, (32, 32, 3),
                                                dtype=np.uint8)


def _capture(module, monkeypatch, target):
    """Wrap `module.invert_images` to keep its (losses, last frames)."""
    seen = {}
    inner = module.invert_images

    def spy(*a, **kw):
        z, losses, frames = inner(*a, **kw)
        seen["losses"], seen["recon"] = np.asarray(losses), np.asarray(
            frames[-1])
        return z, losses, frames

    monkeypatch.setattr(target, "invert_images", spy)
    return seen


def test_animate_equals_the_jax_backend(gan, tmp_path, monkeypatch):
    """20 steps at batch 4 over the default capture sections, with two
    expression paths: the loss history and the reconstruction within 1e-4
    of the JAX backend's from the JAX z0, the reconstruction PNG within
    one grey level, and the same artifacts (progress and path mp4s of the
    same frame counts)."""
    jp, js, tp, ts = gan
    pdir = tmp_path / "paths"
    pdir.mkdir()
    path_zs = np.random.default_rng(0).uniform(-0.2, 0.2, (4, 8))
    np.save(str(pdir / "smile.npy"), path_zs)
    (pdir / "frown.txt").write_text(repr([row for row in path_zs[::-1]]))
    paths = twebcam.load_latent_paths(str(pdir), 8)
    assert set(paths) == {"smile", "frown"}

    want_seen = _capture(jinvert, monkeypatch, jinvert)
    got_seen = _capture(twebcam, monkeypatch, twebcam)
    jb = jwebcam.WebcamBackend(jp, js, JDCGANConfig(**_CFG),
                               str(tmp_path / "j"), paths=paths, steps=20,
                               batch_size=4)
    tb = twebcam.WebcamBackend(tp, ts, DCGANConfig(**_CFG),
                               str(tmp_path / "t"), paths=paths, steps=20,
                               batch_size=4, device="cpu")
    face = _face()
    want = jb.animate(face)
    z0 = np.array(jax.random.uniform(jax.random.PRNGKey(0), (4, 8),
                                     minval=-1.0, maxval=1.0))
    got = tb.animate(face, z0=z0)

    losses = want_seen["losses"]
    assert losses[-1] < losses[0]                # the inversion moved
    np.testing.assert_allclose(got_seen["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got_seen["recon"], want_seen["recon"],
                               rtol=0, atol=1e-4)
    rec = [cv2.imread(r["reconstruction"], cv2.IMREAD_COLOR).astype(int)
           for r in (got, want)]
    assert rec[0].shape == (32, 32, 3)
    assert np.abs(rec[0] - rec[1]).max() <= 1
    assert set(got["paths"]) == set(want["paths"]) == {"smile", "frown"}
    for g, w in [(got["progress_video"], want["progress_video"])] + [
            (got["paths"][n], want["paths"][n]) for n in paths]:
        counts = []
        for p in (g, w):
            cap = cv2.VideoCapture(p)
            n = 0
            while cap.read()[0]:
                n += 1
            cap.release()
            counts.append(n)
        assert counts[0] == counts[1] > 0, (g, counts)
    assert sorted(os.listdir(tmp_path / "t" / "req_0")) == sorted(
        os.listdir(tmp_path / "j" / "req_0"))


@pytest.fixture(scope="module")
def backend(gan, tmp_path_factory):
    _, _, tp, ts = gan
    return twebcam.WebcamBackend(
        tp, ts, DCGANConfig(**_CFG), str(tmp_path_factory.mktemp("svc")),
        paths={"nod": np.zeros((3, 8), np.float32)}, steps=2, batch_size=2,
        device="cpu")


@pytest.fixture(scope="module")
def tls_pair(tmp_path_factory):
    """Self-signed localhost cert via the system openssl (SAN required)."""
    import shutil
    import subprocess

    if not shutil.which("openssl"):
        pytest.skip("no openssl binary")
    d = tmp_path_factory.mktemp("tls")
    cert, keyf = str(d / "cert.pem"), str(d / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-days", "1", "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1",
         "-keyout", keyf, "-out", cert],
        check=True, capture_output=True)
    return cert, keyf


def test_animate_over_http_with_token(backend, tmp_path):
    """/health stays open; /animate without the token is 401; with it,
    animate_via_service gets the artifacts and copies them out."""
    server = twebcam.serve(backend, port=0, background=True,
                           auth_token="tok")
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
        req = urllib.request.Request(base + "/animate",
                                     data=encode_png(_face(2)),
                                     headers={"Content-Type": "image/png"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 401
        result = twebcam.animate_via_service(base, _face(2),
                                             out_dir=str(tmp_path / "copy"),
                                             auth_token="tok")
        assert result["response"] == "success"
        assert np.isfinite(result["final_loss"])
        assert sorted(os.listdir(tmp_path / "copy")) == [
            "path_nod.mp4", "progress.mp4", "reconstruction.png"]
    finally:
        server.shutdown()


def test_animate_over_tls(backend, tls_pair):
    """HTTPS end to end through animate_via_service with the self-signed
    cert pinned; a plain-HTTP probe of the TLS port fails."""
    import ssl

    cert, keyf = tls_pair
    server = twebcam.serve(backend, port=0, background=True,
                           auth_token="tok", tls_cert=cert, tls_key=keyf)
    port = server.server_address[1]
    try:
        ctx = ssl.create_default_context(cafile=cert)
        with urllib.request.urlopen(f"https://127.0.0.1:{port}/health",
                                    timeout=10, context=ctx) as r:
            assert json.loads(r.read())["status"] == "ok"
        result = twebcam.animate_via_service(
            f"https://127.0.0.1:{port}", _face(3), auth_token="tok",
            tls_ca=cert)
        assert result["response"] == "success"
        with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                   timeout=10)
    finally:
        server.shutdown()


def test_upload_decode_grayscale_and_resize(backend):
    """Uploads are decoded by cv2: a grayscale PNG gives three equal
    channels (the JAX service's imageio `[..., :3]` keeps it 2-D), an
    RGBA one drops alpha, and an off-size upload is resized as
    capture_face resizes; bytes cv2 cannot read raise ValueError."""
    gray = np.random.default_rng(4).integers(0, 256, (32, 32),
                                             dtype=np.uint8)
    img = twebcam.decode_upload(encode_png(gray), 32)
    assert img.shape == (32, 32, 3)
    for c in range(3):
        np.testing.assert_array_equal(img[..., c], gray)
    rgba = np.random.default_rng(5).integers(0, 256, (32, 32, 4),
                                             dtype=np.uint8)
    np.testing.assert_array_equal(
        twebcam.decode_upload(encode_png(rgba), 32), rgba[..., :3])
    big = np.random.default_rng(6).integers(0, 256, (48, 40, 3),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(
        twebcam.decode_upload(encode_png(big), 32),
        twebcam._resize_u8(big, 32))
    with pytest.raises(ValueError, match="decode"):
        twebcam.decode_upload(b"notapng", 32)
    # the gray upload animates over HTTP
    server = twebcam.serve(backend, port=0, background=True)
    try:
        r = twebcam.animate_via_service(
            f"http://127.0.0.1:{server.server_address[1]}", gray)
        assert r["response"] == "success"
    finally:
        server.shutdown()


def test_two_concurrent_animate_requests(backend):
    """Two /animate requests at once both succeed, each in its own request
    directory: the lock only numbers the requests."""
    server = twebcam.serve(backend, port=0, background=True)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    results, errors = [], []

    def worker(seed):
        try:
            results.append(twebcam.animate_via_service(url, _face(seed)))
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=worker, args=(s,))
                   for s in (7, 8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "request hung"
    finally:
        server.shutdown()
    assert not errors, errors
    dirs = {os.path.dirname(r["reconstruction"]) for r in results}
    assert len(results) == 2 and len(dirs) == 2
    assert all(os.path.exists(r["progress_video"]) for r in results)


def test_warmup_leaves_no_artifact_and_no_request_id(backend):
    before = sorted(os.listdir(backend.out_dir))
    req = backend._req
    backend.warmup()
    assert backend._req == req
    assert sorted(os.listdir(backend.out_dir)) == before
