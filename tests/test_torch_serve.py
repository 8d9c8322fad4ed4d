"""The port's explorer, survey and webcam client tools
(gifgan_tpu_torch/serve/explorer.py, survey.py, webcam.py capture and path
helpers, http_common.py), counterparts of tests/test_serve.py, and the
port against the JAX package on the same inputs.

The explorer runs on test_serve.py's `fake_sampler` (no model): the same
action sequence through both packages' ExplorerCore, each with a numpy rng
of one seed, gives equal JSON responses once the saved video's path is set
aside, and PNGs that decode to equal pixels. `capture_face` resizes with
ops/image.py resize_bilinear where the JAX one calls jax.image.resize:
within one grey level (float32 sums in another order, then truncated to
uint8). All servers bind 127.0.0.1 on a free port; the TLS cases skip
without an `openssl` binary, as tests/test_serve.py's do.
"""

import http.client
import json
import os
import threading
import urllib.error
import urllib.parse
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from gifgan_tpu.serve import explorer as jexplorer
from gifgan_tpu.serve import webcam as jwebcam
from gifgan_tpu_torch.serve import STATIC_DIR
from gifgan_tpu_torch.serve import explorer as texplorer
from gifgan_tpu_torch.serve import webcam as twebcam
from gifgan_tpu_torch.serve.http_common import MAX_FORM_BODY, MAX_IMAGE_BODY
from gifgan_tpu_torch.track.boxes import Detection

Z = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread per worker process (tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fake_sampler(z):
    """Deterministic 'generator': paints the first z component as intensity
    (tests/test_serve.py)."""
    z = np.asarray(z)
    img = np.tanh(z[:, 0])[:, None, None, None]
    return np.tile(img, (1, 16, 16, 3)).astype(np.float32)


def _core(module, media, seed=0):
    return module.ExplorerCore(fake_sampler, Z, str(media), num_directions=3,
                               num_steps=2, face_rows=2, face_cols=2,
                               batch_size=4,
                               rng=np.random.default_rng(seed))


@pytest.fixture
def core(tmp_path):
    return _core(texplorer, tmp_path / "media")


def _serving(server):
    return f"127.0.0.1:{server.server_address[1]}"


def _get(url, **kw):
    with urllib.request.urlopen(url, timeout=30, **kw) as r:
        return json.loads(r.read())


def test_explorer_flow(core):
    r = core.init_face(step_size=0.5)
    assert r["response"] == "success"
    assert len(core.video_zs) == 1
    assert os.path.exists(os.path.join(core.media_dir, "img_0.png"))

    core.init_directions(step_size=0.5)
    assert core.direction_zs.shape == (3, 2, Z)
    assert len(core.direction_paths) == 3
    core.add_image(row=1, col=1, step_size=0.5)
    # add_individually False after init_directions -> adds cols 0..1
    assert len(core.video_zs) == 3

    r = core.perp_faces(similarity=0.4)
    assert r["response"] == "success"
    delta = core.video_zs[-1] - core.video_zs[0]
    offs = core.direction_zs - core.video_zs[0]
    np.testing.assert_allclose(np.tensordot(offs, delta, axes=([2], [0])),
                               0.0, atol=1e-6)
    core.delete_image(index=0, step_size=0.5)
    assert len(core.video_zs) == 2
    core.clear_faces()
    assert core.video_zs == []
    # perpendicular faces need two faces in the timeline
    assert core.perp_faces(similarity=0.5)["response"] == "error"


def test_explorer_load_description_and_save(core):
    zs = np.random.default_rng(0).uniform(-1, 1, (3, Z))
    r = core.load_video_description(repr(zs))
    assert r["response"] == "success" and len(core.video_zs) == 3
    # relative load: deltas from path[0] applied to the last z
    core.load_video_description(repr(zs), relative=True)
    assert len(core.video_zs) == 6
    np.testing.assert_allclose(core.video_zs[3], core.video_zs[2], atol=1e-6)
    path = core.save(frame_rate=4.0)
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 6


def _actions(c):
    """One session of every route that draws from the rng or writes media,
    in the order a user might click them."""
    zs = np.random.default_rng(5).uniform(-1, 1, (3, Z))
    return [
        c.init_face(0.5), c.init_directions(0.5), c.add_image(1, 1, 0.5),
        c.get_similar(0, 1, 0.5, 0.3), c.update_step_size(0.8),
        c.random_faces(), c.get_similar(1, 0, 0.5, 0.4),
        c.add_image(1, 0, 0.5), c.perp_faces(0.4), c.add_image(0, 1, 0.5),
        c.reorder_image(0, 2, 0.5), c.reorder_image(7, 0, 0.5),
        c.delete_image(1, 0.5), c.load_video_description(repr(zs)),
        c.load_video_description(repr(zs), relative=True),
        c.clear_directions(), c.init_directions(0.3),
    ]


def test_explorer_actions_equal_the_jax_core(tmp_path):
    """The same action sequence and rng seed through both packages' cores:
    equal JSON responses, media files of the same names decoding to equal
    pixels, and saved videos of equal frames."""
    want_core = _core(jexplorer, tmp_path / "j")
    got_core = _core(texplorer, tmp_path / "t")
    want, got = _actions(want_core), _actions(got_core)
    for i, (g, w) in enumerate(zip(got, want)):
        assert json.dumps(g) == json.dumps(w), i
    assert got[11]["response"] == "error"            # reorder out of range
    saved = [c.save(4.0) for c in (got_core, want_core)]
    g, w = got_core._response(), want_core._response()
    assert g["msg"].pop("video_save_path") == saved[0]
    assert w["msg"].pop("video_save_path") == saved[1]
    assert g == w
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert len([n for n in names if n.endswith(".png")]) > 40
    for n in names:
        a, b = (str(tmp_path / d / n) for d in ("t", "j"))
        if n.endswith(".png"):
            np.testing.assert_array_equal(cv2.imread(a, cv2.IMREAD_UNCHANGED),
                                          cv2.imread(b, cv2.IMREAD_UNCHANGED),
                                          err_msg=n)
        else:
            caps = [cv2.VideoCapture(p) for p in (a, b)]
            frames = 0
            while True:
                (ok_a, fa), (ok_b, fb) = (c.read() for c in caps)
                assert ok_a == ok_b
                if not ok_a:
                    break
                np.testing.assert_array_equal(fa, fb)
                frames += 1
            assert frames == len(got_core.video_zs)


def test_explorer_http_server_auth_and_static_frontend(core):
    """Routes over HTTP, media serving, a missing parameter (400), the
    static front end at /, and the bearer token: no token or a wrong one
    401, the header and ?token= both authorize."""
    server = texplorer.serve(core, port=0, background=True,
                             static_dir=STATIC_DIR, auth_token="s3cret")
    base = "http://" + _serving(server)
    auth = {"Authorization": "Bearer s3cret"}

    def call(route):
        return _get(urllib.request.Request(base + route, headers=auth))

    try:
        assert call("/init_face?step_size=0.5")["response"] == "success"
        r = call("/random_faces")
        assert len(r["msg"]["direction_paths"]) == 2
        assert call("/test_success")["response"] == "success"
        assert call("/test/3")["n"] == 3
        with urllib.request.urlopen(urllib.request.Request(
                base + "/media/img_0.png", headers=auth), timeout=30) as m:
            assert m.read()[:8] == b"\x89PNG\r\n\x1a\n"
        with pytest.raises(urllib.error.HTTPError) as e:
            call("/add_image")
        assert e.value.code == 400
        with urllib.request.urlopen(base + "/?token=s3cret",
                                    timeout=30) as r:
            body = r.read()
        assert b"latent explorer" in body and b"init_face" in body
        assert _get(base + "/test_success?token=s3cret")["response"] == \
            "success"
        for url in (base + "/test_success",
                    base + "/test_success?token=wrong"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(url, timeout=30)
            assert e.value.code == 401
    finally:
        server.shutdown()
    with open(os.path.join(STATIC_DIR, "index.html"), "rb") as f:
        ours = f.read()
    with open(os.path.join(os.path.dirname(jexplorer.__file__), "static",
                           "index.html"), "rb") as f:
        assert ours == f.read()


def test_explorer_frontend_interaction_sequence(core):
    """The HTTP sequence the front end issues for add -> reorder -> delete
    -> save (tests/test_serve.py's drive), and every route and control
    the page wires."""
    server = texplorer.serve(core, port=0, background=True)
    base = "http://" + _serving(server)

    def post(route, **params):
        data = urllib.parse.urlencode(params).encode()
        with urllib.request.urlopen(base + route, data=data,
                                    timeout=30) as r:
            return json.loads(r.read())

    try:
        r = post("/random_faces")
        cols = len(r["msg"]["direction_paths"][0])
        for c in range(3):
            r = post("/add_image", row=0, col=c % cols, step_size=0.5)
        zs0, paths0 = r["msg"]["video_zs"], list(r["msg"]["video_paths"])
        assert len(paths0) == 3
        r = post("/reorder_image", src=0, dst=2, step_size=0.5)
        assert r["msg"]["video_paths"] == [paths0[1], paths0[2], paths0[0]]
        assert r["msg"]["video_zs"] != zs0
        assert post("/reorder_image", src=9, dst=0,
                    step_size=0.5)["response"] == "error"
        r = post("/delete_image", index=1, step_size=0.5)
        assert len(r["msg"]["video_paths"]) == 2
        assert post("/update_step_size",
                    step_size=0.9)["response"] == "success"
        r = post("/save", frame_rate=4)
        assert r["msg"]["video_save_path"].endswith(".mp4")
        assert os.path.exists(r["msg"]["video_save_path"])
    finally:
        server.shutdown()
    with open(os.path.join(STATIC_DIR, "index.html")) as f:
        page = f.read()
    for route in ("random_faces", "perp_faces", "clear_faces",
                  "init_directions", "clear_directions", "add_image",
                  "get_similar", "delete_image", "reorder_image",
                  "update_step_size", "load_video_description",
                  "load_relative_video_description", "save", "seek-slider",
                  "step-slider", "sim-slider", "play", "stop", "fps",
                  "draggable", "ondrop"):
        assert route in page, route


def test_explorer_concurrent_requests(core):
    """Parallel clients on the sampler routes all succeed: the core lock
    serializes them (tests/test_serve.py)."""
    server = texplorer.serve(core, port=0, background=True)
    base = "http://" + _serving(server)
    errors = []

    def worker(i):
        try:
            for j in range(8):
                route = ("/random_faces" if (i + j) % 2
                         else "/init_face?step_size=0.5")
                out = _get(base + route)
                assert out["response"] == "success", out
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append((i, repr(e)))

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "worker hung"
    finally:
        server.shutdown()
    assert not errors, errors


@pytest.fixture(scope="module")
def tls_pair(tmp_path_factory):
    """Self-signed localhost cert via the system openssl (SAN required:
    Python's client validation ignores a bare CN)."""
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


def test_explorer_tls(core, tls_pair):
    import ssl

    cert, keyf = tls_pair
    server = texplorer.serve(core, port=0, background=True, tls_cert=cert,
                             tls_key=keyf)
    try:
        ctx = ssl.create_default_context(cafile=cert)
        assert _get(f"https://{_serving(server)}/test_success",
                    context=ctx)["response"] == "success"
        with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
            urllib.request.urlopen(f"http://{_serving(server)}/test_success",
                                   timeout=10)
    finally:
        server.shutdown()


def _claim_big_body(port, path, n_bytes):
    """Open a request that DECLARES an n-byte body without sending it; the
    server must answer from the header alone (413) instead of reading."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.putrequest("POST", path)
    conn.putheader("Content-Type", "application/octet-stream")
    conn.putheader("Content-Length", str(n_bytes))
    conn.endheaders()
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def _webcam_backend(tmp_path):
    from gifgan_tpu_torch.core.config import DCGANConfig
    from gifgan_tpu_torch.models import dcgan

    cfg = DCGANConfig(output_size=32, c_dim=3, z_dim=Z, gf_dim=8, df_dim=8)
    params, state = dcgan.init(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    return twebcam.WebcamBackend(params, state, cfg, str(tmp_path / "out"),
                                 steps=2, batch_size=2, device="cpu")


@pytest.mark.parametrize("service", ["webcam", "explorer", "survey"])
def test_oversized_body_rejected_unread(service, tmp_path):
    """A POST declaring a body over the service's cap gets 413 from the
    header alone; the payload is never sent. At the cap, the webcam reads
    the body and a payload cv2 cannot decode is a 500."""
    from gifgan_tpu_torch.serve import survey as tsurvey

    if service == "webcam":
        server = twebcam.serve(_webcam_backend(tmp_path), port=0,
                               background=True)
        path, cap = "/animate", MAX_IMAGE_BODY
    elif service == "explorer":
        server = texplorer.serve(_core(texplorer, tmp_path / "m"), port=0,
                                 background=True)
        path, cap = "/update_step_size", MAX_FORM_BODY
    else:
        (tmp_path / "sv").mkdir()
        server = tsurvey.serve(tsurvey.SurveyServer(str(tmp_path / "sv")),
                               port=0, background=True)
        path, cap = "/response", MAX_FORM_BODY
    port = server.server_address[1]
    try:
        status, body = _claim_big_body(port, path, cap + 1)
        assert status == 413 and "exceeds" in body["msg"], body
        if service == "webcam":
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            conn.request("POST", "/animate", body=b"notapng")
            resp = conn.getresponse()
            assert resp.status == 500
            assert "cannot decode" in json.loads(resp.read())["msg"]
            conn.close()
    finally:
        server.shutdown()


def test_survey_server_end_to_end(tmp_path):
    from gifgan_tpu_torch.data.synthetic import synthetic_clips
    from gifgan_tpu_torch.eval.survey import export_survey_samples
    from gifgan_tpu_torch.serve.survey import SurveyServer, serve

    export_survey_samples(
        {"nested": lambda n: synthetic_clips(n, 3, 16, seed=1)},
        str(tmp_path), samples_per_variant=2)
    survey = SurveyServer(str(tmp_path))
    server = serve(survey, port=0, background=True)
    base = "http://" + _serving(server)
    try:
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            assert b"How realistic" in r.read()
        manifest = _get(base + "/manifest.json")
        gif_path = manifest["variants"]["nested"][0]
        with urllib.request.urlopen(f"{base}/{gif_path}", timeout=10) as r:
            assert r.read()[:4] == b"GIF8"
        for rating in (4, 2):
            req = urllib.request.Request(
                base + "/response",
                data=json.dumps({"gif": gif_path, "variant": "nested",
                                 "rating": rating, "worker": "w1"}).encode(),
                headers={"Content-Type": "application/json"})
            assert _get(req)["response"] == "success"
        res = _get(base + "/results")
        assert res["variants"]["nested"] == {"n": 2, "mean_rating": 3.0}
        assert "ab" not in res
        req = urllib.request.Request(
            base + "/response",
            data=json.dumps({"gif": "x", "variant": "v",
                             "rating": 9}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/../../etc/passwd.gif",
                                   timeout=10)
        assert e.value.code in (403, 404)
    finally:
        server.shutdown()


def test_survey_ab_pairs_end_to_end_equals_the_jax_server(tmp_path):
    """A/B mode (pairs.json), the pair UI, un-swapped win rates and the
    worker allowlist; /results equals the JAX SurveyServer's on the same
    responses file."""
    from gifgan_tpu.serve.survey import SurveyServer as JSurveyServer
    from gifgan_tpu_torch.data.synthetic import synthetic_clips
    from gifgan_tpu_torch.eval.survey import (export_survey_samples,
                                              make_pair_manifest)
    from gifgan_tpu_torch.serve.survey import SurveyServer, serve

    export_survey_samples(
        {"nested": lambda n: synthetic_clips(n, 3, 16, seed=1),
         "real": lambda n: synthetic_clips(n, 3, 16, seed=2)},
        str(tmp_path), samples_per_variant=4)
    make_pair_manifest(str(tmp_path), "nested", "real", seed=3)
    survey = SurveyServer(str(tmp_path), allowed_workers={"w1", "w2"})
    server = serve(survey, port=0, background=True)
    base = "http://" + _serving(server)

    def post(payload):
        req = urllib.request.Request(
            base + "/response", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        return _get(req)

    try:
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            assert b"more realistic" in r.read()
        served = _get(base + "/pairs.json")
        assert served["variant_a"] == "nested"
        for p in served["pairs"]:
            assert post({"pair": p["id"], "worker": "w1", "choice":
                         "A" if p["swap"] == 0 else "B"})["response"] == \
                "success"
        post({"pair": served["pairs"][0]["id"], "choice": "A",
              "worker": "w2"})
        post({"gif": "nested_samples/0.gif", "variant": "nested",
              "rating": 5, "worker": "w1"})
        res = _get(base + "/results")
        n = len(served["pairs"])
        w2_chose_nested = served["pairs"][0]["swap"] == 0
        ab = res["ab"]
        assert ab["n_responses"] == n + 1
        assert ab["wins"]["nested"] == n + int(w2_chose_nested)
        assert ab["wins"]["real"] == 1 - int(w2_chose_nested)
        assert ab["workers"]["w1"]["n"] == n
        assert res["variants"]["nested"] == {"n": 1, "mean_rating": 5.0}
        assert res == JSurveyServer(str(tmp_path)).results()
        for payload, code in (
                ({"pair": 0, "choice": "A", "worker": "intruder"}, 403),
                ({"pair": 999, "choice": "A", "worker": "w1"}, 400),
                ({"pair": 0, "choice": "C", "worker": "w1"}, 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                post(payload)
            assert e.value.code == code, payload
    finally:
        server.shutdown()


def _face_frame():
    rng = np.random.default_rng(2)
    f = rng.integers(0, 60, (100, 120, 3), dtype=np.uint8)
    f[30:70, 40:80] = rng.integers(120, 250, (40, 40, 3), dtype=np.uint8)
    return f


@pytest.mark.parametrize("target", [16, 64], ids=["downscale", "upscale"])
def test_capture_face_equals_the_jax_capture(target):
    """The first accepted frame with a detection, aspect-expanded and
    resized (a 41x41 crop down to 16 and up to 64): within one grey level
    of the JAX package's, with the same box; no accepted frame -> None."""
    f = _face_frame()

    def det(frame, i):
        return [Detection(40, 30, 80, 70, i), Detection(0, 0, 9, 9, i)]

    frames = [(f, False), (f, True)]
    face, box = twebcam.capture_face(iter(frames), det, target_size=target)
    want, jbox = jwebcam.capture_face(iter(frames), det, target_size=target)
    assert face.shape == want.shape == (target, target, 3)
    assert face.dtype == np.uint8
    assert (box.x1, box.y1, box.x2, box.y2, box.frame_number) == \
        (jbox.x1, jbox.y1, jbox.x2, jbox.y2, jbox.frame_number) == \
        (40, 30, 80, 70, 1)
    assert np.abs(face.astype(int) - want.astype(int)).max() <= 1
    assert face.mean() > 100
    assert twebcam.capture_face(iter([(f, False)]), det,
                                target_size=target) == (None, None)


class _FakeCv2:
    """Scriptable cv2 stand-in for the live capture/carousel loops
    (tests/test_serve.py)."""

    def __init__(self, frames, keys):
        self._frames = list(frames)
        self._keys = list(keys)
        self.shown = []

    class _Cap:
        def __init__(self, frames):
            self.frames = list(frames)

        def isOpened(self):
            return True

        def read(self):
            if not self.frames:
                return False, None
            return True, self.frames.pop(0)

        def release(self):
            pass

    def VideoCapture(self, _src):
        return self._Cap(self._frames)

    def rectangle(self, img, *a, **k):
        return img

    def imshow(self, window, img):
        self.shown.append(np.asarray(img).shape)

    def imread(self, path):
        return np.zeros((8, 8, 3), np.uint8)

    def waitKey(self, _ms):
        return self._keys.pop(0) if self._keys else 255

    def destroyWindow(self, _w):
        pass


def test_capture_face_live_with_fake_camera():
    frame = np.zeros((64, 96, 3), np.uint8)
    frame[20:52, 30:62] = 180
    fake = _FakeCv2([frame[..., ::-1].copy()] * 6, [255, 255, 13])

    def detector(f, i):
        return [Detection(30, 20, 61, 51, i)]

    face, box = twebcam.capture_face_live(detector, cv2_mod=fake,
                                          target_size=32)
    assert face is not None and face.shape == (32, 32, 3)
    assert box.frame_number == 2 and face.mean() > 150
    assert len(fake.shown) == 3      # live preview frames, Enter on the 3rd
    # q aborts: no face
    fake = _FakeCv2([frame[..., ::-1].copy()] * 6, [ord("q")])
    assert twebcam.capture_face_live(detector, cv2_mod=fake,
                                     target_size=32) == (None, None)


def test_result_carousel_cycles_and_exits(tmp_path):
    from gifgan_tpu_torch.ops.image import write_png

    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    for p in (a, b):
        write_png(p, np.zeros((8, 8, 3), np.uint8))
    fake = _FakeCv2([], [ord("d"), ord("d"), ord("q")])
    assert twebcam.result_carousel([a, b], cv2_mod=fake) == [a, b]
    assert twebcam.result_carousel([], cv2_mod=fake) == []


def test_expression_path_library_roundtrip(tmp_path):
    """8 named paths in the reference manual_paths .txt protocol plus an
    .npy: load_latent_paths gives the JAX package's arrays."""
    from gifgan_tpu_torch.demo import make_expression_paths, write_paths

    paths = make_expression_paths(z_dim=16, frames=8, seed=3)
    assert len(paths) == 8
    write_paths(str(tmp_path), paths)
    np.save(str(tmp_path / "extra.npy"),
            np.random.default_rng(0).uniform(-0.2, 0.2, (4, 16)))
    (tmp_path / "notes.md").write_text("not a path")
    back = twebcam.load_latent_paths(str(tmp_path), z_dim=16)
    want = jwebcam.load_latent_paths(str(tmp_path), z_dim=16)
    assert set(back) == set(want) == set(paths) | {"extra"}
    for name in paths:
        np.testing.assert_allclose(back[name], paths[name], atol=1e-5)
    for name in want:
        assert back[name].dtype == np.float32
        np.testing.assert_array_equal(back[name], want[name])
