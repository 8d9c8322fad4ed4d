"""Interactive latent-space explorer (gifgan_tpu/serve/explorer.py): API
core + stdlib HTTP server.

Rebuild of the reference's bottle web app (models/recurrent_z/explorer.py +
explorer_static/index.html): a timeline of latent vectors ("video_zs") plus a
grid of candidate next-faces, manipulated through HTTP routes:

  init_face, init_directions, clear_directions, update_step_size,
  random_faces, clear_faces, perp_faces, add_image, get_similar,
  delete_image, load_video_description, load_relative_video_description,
  save, plus /test_success /test_error /test_last /test/<n> latency routes
  (explorer.py:95-396).

`ExplorerCore` is application logic over an injected `sampler_fn` (z batch
-> images in [-1, 1]); `dcgan_sampler` builds that function from an image
GAN on the card (float, or int8 through ops/quant.py). `serve()` wraps the
core in a stdlib ThreadingHTTPServer. Inference batches pad to a fixed
batch size (reference run_inference, explorer.py:418-428).

Media: the face PNGs are written by ops/image.py write_png (the card's
machine has no imageio); `save` writes an mp4 (data/video.py encode_mp4,
mp4v through cv2), since the front end shows the path it returns.
Requests run one at a time under the core's lock: ExplorerCore's state is
shared, and the int8 sampler flips the process-wide TF32 switches.
"""

from __future__ import annotations

import ast
import json
import os
import re
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.data.video import encode_mp4
from gifgan_tpu_torch.ops.image import denorm_u8, write_png
from gifgan_tpu_torch.serve.http_common import (MAX_FORM_BODY, body_length,
                                                make_server)


def parse_z_text(text: str) -> np.ndarray:
    """Parse a pasted z description — JSON, or the textified-numpy protocol
    (repr'd arrays) — WITHOUT eval (the reference eval()s request params,
    explorer.py:341; that is remote code execution on a served port)."""
    text = text.strip()
    try:
        return np.asarray(json.loads(text), np.float32)
    except (json.JSONDecodeError, ValueError):
        pass
    # strip numpy repr wrappers: array(...), dtype=..., whitespace
    cleaned = re.sub(r"dtype=[A-Za-z0-9_.]+", "", text)
    cleaned = cleaned.replace("array(", "(").replace("\n", " ")
    cleaned = re.sub(r",\s*\)", ")", cleaned)
    return np.asarray(ast.literal_eval(cleaned), np.float32)


def dcgan_sampler(params, state, cfg, batch_size: int = 64,
                  int8: bool = False, int8_calib: int = 0,
                  int8_float_last: bool = False, device=None
                  ) -> Callable[[np.ndarray], np.ndarray]:
    """The explorer's sampler (gifgan_tpu/cli.py cmd_explorer): z (B,
    z_dim) numpy -> images (B, s, s, c) float32 numpy in [-1, 1], from the
    image GAN's generator on `device` (None: the card, resolved here, so
    a missing card stops the caller before it serves). int8: the
    quantized generator (ops/quant.py), with static activation scales
    from `int8_calib` batches of numpy-seeded z (seeds 0..n-1, as the JAX
    command draws them). Each call runs under its own no_grad: a request
    thread does not inherit the main thread's grad mode."""
    from gifgan_tpu_torch.models import dcgan

    device = resolve_device(device)
    params = dcgan.to_device(params, device)
    state = dcgan.to_device(state, device)
    if int8:
        from gifgan_tpu_torch.ops import quant

        q = quant.quantize_image_generator(
            params["generator"], state["generator"],
            float_last=int8_float_last)
        if int8_calib:
            zs = [np.random.default_rng(i).uniform(
                      -1, 1, (batch_size, cfg.z_dim)).astype(np.float32)
                  for i in range(int8_calib)]
            q = quant.calibrate_image_generator(q, zs, cfg)

        def forward(z):
            return quant.image_generator_q(q, z, cfg)
    else:
        def forward(z):
            return dcgan.sample(params, state, z, cfg)

    def sampler(z):
        with torch.no_grad():
            out = forward(torch.as_tensor(np.asarray(z, np.float32),
                                          device=device))
        return out.float().cpu().numpy()

    return sampler


class ExplorerCore:
    def __init__(self, sampler_fn: Callable[[np.ndarray], np.ndarray],
                 z_dim: int, media_dir: str,
                 num_directions: int = 6, num_steps: int = 6,
                 face_rows: int = 6, face_cols: int = 6,
                 batch_size: int = 64, image_scale: int = 2,
                 rng: Optional[np.random.Generator] = None):
        self.sampler_fn = sampler_fn
        self.z_dim = z_dim
        self.media_dir = media_dir
        os.makedirs(media_dir, exist_ok=True)
        self.num_directions = num_directions
        self.num_steps = num_steps
        self.face_rows = face_rows
        self.face_cols = face_cols
        self.batch_size = batch_size
        self.image_scale = image_scale
        self.rng = rng or np.random.default_rng(0)

        self.video_zs: List[np.ndarray] = []
        self.video_paths: List[str] = []
        self.directions: Optional[np.ndarray] = None
        self.direction_zs: Optional[np.ndarray] = None
        self.direction_paths: List[List[str]] = []
        self.add_individually = False
        self._counter = 0
        self._vid_counter = 0
        self.last_response: Optional[Dict] = None
        self.video_save_path: Optional[str] = None

    # -- inference ----------------------------------------------------------
    def run_inference(self, zs) -> np.ndarray:
        """Fixed-size padded batching (explorer.py:418-428)."""
        zs = np.asarray(zs, np.float32).reshape(-1, self.z_dim)
        out = []
        for i in range(0, len(zs), self.batch_size):
            chunk = zs[i:i + self.batch_size]
            pad = self.batch_size - len(chunk)
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad, self.z_dim), np.float32)])
            imgs = np.asarray(self.sampler_fn(chunk))
            out.append(imgs[:self.batch_size - pad] if pad else imgs)
        return np.concatenate(out)

    def _write_img(self, im: np.ndarray) -> str:
        name = f"img_{self._counter}.png"
        self._counter += 1
        write_png(os.path.join(self.media_dir, name), denorm_u8(im))
        return f"media/{name}"

    # -- state updates ------------------------------------------------------
    def _update_direction_paths(self):
        rows, cols, _ = self.direction_zs.shape
        imgs = self.run_inference(self.direction_zs.reshape(-1, self.z_dim))
        paths = np.array([self._write_img(im) for im in imgs])
        self.direction_paths = paths.reshape(rows, cols).tolist()

    def _update_direction_imgs(self, step_size: float):
        if self.directions is None or not self.video_zs:
            return
        last_z = self.video_zs[-1]
        zs = np.tile(last_z, (self.num_directions, self.num_steps, 1))
        steps = (np.arange(self.num_steps) + 1)[None, :, None]
        zs = zs + self.directions[:, None, :] * step_size * steps
        self.direction_zs = zs
        self.add_individually = False
        self._update_direction_paths()

    def _response(self) -> Dict:
        # full-precision, untruncated textified arrays (plain repr elides
        # with '...' past 1000 elements, breaking the save/load round trip)
        def textify(a):
            if a is None:
                return repr(None)
            return "array(" + np.array2string(
                np.asarray(a), threshold=np.inf, max_line_width=int(1e9),
                separator=", ") + ")"

        msg = {
            "video_zs": textify(np.array(self.video_zs)),
            "video_paths": list(self.video_paths),
            "directions": textify(self.directions),
            "direction_paths": self.direction_paths,
            "video_save_path": self.video_save_path,
        }
        self.last_response = {"response": "success", "msg": msg}
        return self.last_response

    def _error(self, message: str) -> Dict:
        self.last_response = {"response": "error", "msg": message}
        return self.last_response

    # -- routes -------------------------------------------------------------
    def init_face(self, step_size: float) -> Dict:
        self.video_zs = [self.rng.uniform(-1, 1, self.z_dim)]
        imgs = self.run_inference(self.video_zs)
        self.video_paths = [self._write_img(imgs[0])]
        self._update_direction_imgs(step_size)
        return self._response()

    def init_directions(self, step_size: float) -> Dict:
        d = self.rng.uniform(-1, 1, (self.num_directions, self.z_dim))
        self.directions = d / np.linalg.norm(d, axis=1, keepdims=True)
        self._update_direction_imgs(step_size)
        return self._response()

    def clear_directions(self) -> Dict:
        self.directions = None
        self.direction_zs = None
        self.direction_paths = []
        return self._response()

    def update_step_size(self, step_size: float) -> Dict:
        self._update_direction_imgs(step_size)
        return self._response()

    def random_faces(self) -> Dict:
        self.directions = None
        self.direction_zs = self.rng.uniform(
            -1, 1, (self.face_rows, self.face_cols, self.z_dim))
        self.add_individually = True
        self._update_direction_paths()
        return self._response()

    def clear_faces(self) -> Dict:
        self.video_zs = []
        self.video_paths = []
        return self._response()

    def perp_faces(self, similarity: float) -> Dict:
        """Random faces constrained perpendicular to the timeline's motion
        delta (explorer.py:227-255): solve one coordinate of each random seed
        so <z - first, delta> = 0, normalize, scale by similarity."""
        if len(self.video_zs) < 2:
            return self._error(
                "Need at least two faces in timeline to get perpendicular faces")
        first, last = self.video_zs[0], self.video_zs[-1]
        delta = last - first
        mi = int(np.argmax(np.abs(delta)))
        seeds = self.rng.uniform(
            -1, 1, (self.face_rows, self.face_cols, self.z_dim - 1))
        others = np.concatenate([delta[:mi], delta[mi + 1:]])
        inferred = -(seeds @ others)[..., None] / delta[mi]
        perp = np.concatenate([seeds[:, :, :mi], inferred, seeds[:, :, mi:]],
                              axis=2)
        perp = perp / np.linalg.norm(perp, axis=2, keepdims=True) * similarity
        self.direction_zs = first + perp
        self.add_individually = True
        self._update_direction_paths()
        return self._response()

    def add_image(self, row: int, col: int, step_size: float) -> Dict:
        cols = [col] if self.add_individually else range(col + 1)
        for c in cols:
            self.video_zs.append(self.direction_zs[row, c, :])
            self.video_paths.append(self.direction_paths[row][c])
        self._update_direction_imgs(step_size)
        return self._response()

    def get_similar(self, row: int, col: int, step_size: float,
                    similarity: float) -> Dict:
        if self.add_individually:
            initial = self.direction_zs[row, col, :]
            deltas = self.rng.uniform(
                -1, 1, (self.face_rows, self.face_cols, self.z_dim))
            deltas = deltas / np.linalg.norm(deltas, axis=2, keepdims=True)
            deltas *= similarity
            deltas[0, 0, :] = 0.0  # top-left stays the seed face
            self.direction_zs = initial + deltas
            self._update_direction_paths()
        else:
            initial = self.directions[row, :]
            deltas = self.rng.uniform(-1, 1,
                                      (self.num_directions, self.z_dim))
            deltas = deltas / np.linalg.norm(deltas, axis=1, keepdims=True)
            deltas *= similarity
            deltas[0, :] = 0.0
            d = initial + deltas
            self.directions = d / np.linalg.norm(d, axis=1, keepdims=True)
            self._update_direction_imgs(step_size)
        return self._response()

    def reorder_image(self, src: int, dst: int, step_size: float) -> Dict:
        """Move timeline frame src -> dst (frontend drag/reorder; extension
        over the reference UI, which only supported click-to-delete)."""
        n = len(self.video_zs)
        if not (0 <= src < n and 0 <= dst < n):
            return self._error(f"reorder out of range: {src}->{dst} of {n}")
        z = self.video_zs.pop(src)
        p = self.video_paths.pop(src)
        self.video_zs.insert(dst, z)
        self.video_paths.insert(dst, p)
        if src == n - 1 or dst == n - 1:
            self._update_direction_imgs(step_size)
        return self._response()

    def delete_image(self, index: int, step_size: float) -> Dict:
        if 0 <= index < len(self.video_zs):
            was_last = index == len(self.video_zs) - 1
            self.video_zs.pop(index)
            self.video_paths.pop(index)
            if was_last:
                self._update_direction_imgs(step_size)
        return self._response()

    def load_video_description(self, zs, relative: bool = False) -> Dict:
        """Paste a saved z array (repr'd text or array). relative: apply as
        deltas from the current last frame (explorer.py:325-360)."""
        if isinstance(zs, str):
            zs = parse_z_text(zs)
        zs = np.asarray(zs, np.float32).reshape(-1, self.z_dim)
        if relative:
            if not self.video_zs:
                return self._error("relative load needs an existing face")
            base = self.video_zs[-1]
            zs = base + (zs - zs[0])
        imgs = self.run_inference(zs)
        for z, im in zip(zs, imgs):
            self.video_zs.append(z)
            self.video_paths.append(self._write_img(im))
        return self._response()

    def save(self, frame_rate: float = 8.0) -> str:
        """Render the timeline to an mp4 at image_scale x (explorer.py:71-85,
        388-396)."""
        u8 = denorm_u8(self.run_inference(self.video_zs))
        if self.image_scale != 1:
            u8 = np.repeat(np.repeat(u8, self.image_scale, axis=1),
                           self.image_scale, axis=2)
        path = os.path.join(self.media_dir, f"vid_{self._vid_counter}.mp4")
        self._vid_counter += 1
        encode_mp4(path, u8, fps=frame_rate)
        self.video_save_path = path
        return path


# ---------------------------------------------------------------------------
# stdlib HTTP adapter
# ---------------------------------------------------------------------------

def make_handler(core: ExplorerCore, static_dir: Optional[str] = None,
                 auth_token: Optional[str] = None):
    """auth_token: when set, every request must carry it as an
    `Authorization: Bearer <token>` header or `?token=` query parameter
    (constant-time compare); mismatches get 401. The reference explorer
    (explorer.py:95-396) had no auth at all — this is the minimum for
    exposing a GPU/TPU-backed sampler beyond localhost. ?token= exists for
    browser convenience only: URLs embedding secrets leak via history,
    referrers, and intermediary logs (the webcam service is header-only) —
    prefer the header, rotate the token if a ?token= URL was ever shared."""
    import hmac
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    core_lock = threading.RLock()  # ExplorerCore state is not thread-safe

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _authorized(self) -> bool:
            if auth_token is None:
                return True
            hdr = self.headers.get("Authorization") or ""
            if hdr.startswith("Bearer "):
                cand = hdr[len("Bearer "):]
            else:
                q = parse_qs(urlparse(self.path).query)
                cand = (q.get("token") or [""])[0]
            return hmac.compare_digest(cand, auth_token)

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _file(self, path, ctype):
            try:
                with open(path, "rb") as f:
                    body = f.read()
            except OSError:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _dispatch(self):
            if not self._authorized():
                return self._json({"response": "error",
                                   "msg": "unauthorized"}, 401)
            with core_lock:
                return self._dispatch_locked()

        def _dispatch_locked(self):
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            if self.command == "POST":
                n = body_length(self, MAX_FORM_BODY)
                if n is None:
                    return
                if n:
                    q.update({k: v[0] for k, v in
                              parse_qs(self.rfile.read(n).decode()).items()})
            route = u.path.rstrip("/") or "/"
            f = float
            try:
                if route == "/test_success":
                    return self._json(core._response())
                if route == "/test_error":
                    return self._json(core._error("test error"))
                if route == "/test_last":
                    return self._json(core.last_response or {})
                m = re.fullmatch(r"/test/(\d+)", route)
                if m:  # latency check: echo n random faces without state
                    n = int(m.group(1))
                    zs = core.rng.uniform(-1, 1, (n, core.z_dim))
                    core.run_inference(zs)
                    return self._json({"response": "success", "n": n})
                if route == "/init_face":
                    return self._json(core.init_face(f(q["step_size"])))
                if route == "/init_directions":
                    return self._json(core.init_directions(f(q["step_size"])))
                if route == "/clear_directions":
                    return self._json(core.clear_directions())
                if route == "/update_step_size":
                    return self._json(core.update_step_size(f(q["step_size"])))
                if route == "/random_faces":
                    return self._json(core.random_faces())
                if route == "/clear_faces":
                    return self._json(core.clear_faces())
                if route == "/perp_faces":
                    return self._json(core.perp_faces(f(q["similarity"])))
                if route == "/add_image":
                    return self._json(core.add_image(
                        int(q["row"]), int(q["col"]), f(q["step_size"])))
                if route == "/get_similar":
                    return self._json(core.get_similar(
                        int(q["row"]), int(q["col"]), f(q["step_size"]),
                        f(q["similarity"])))
                if route == "/reorder_image":
                    return self._json(core.reorder_image(
                        int(q["src"]), int(q["dst"]), f(q["step_size"])))
                if route == "/delete_image":
                    return self._json(core.delete_image(
                        int(q["index"]), f(q["step_size"])))
                if route == "/load_video_description":
                    return self._json(core.load_video_description(
                        q["description"], relative=False))
                if route == "/load_relative_video_description":
                    return self._json(core.load_video_description(
                        q["description"], relative=True))
                if route == "/save":
                    path = core.save(f(q.get("frame_rate", 8.0)))
                    resp = core._response()
                    resp["path"] = path
                    return self._json(resp)
                if route.startswith("/media/"):
                    return self._file(os.path.join(core.media_dir,
                                                   os.path.basename(route)),
                                      "image/png")
                if route == "/" and static_dir:
                    return self._file(os.path.join(static_dir, "index.html"),
                                      "text/html")
                self._json(core._error(f"unknown route {route}"), code=404)
            except KeyError as e:
                self._json(core._error(f"missing param {e}"), code=400)
            except Exception as e:  # surface errors as JSON like the reference
                self._json(core._error(f"{type(e).__name__}: {e}"), code=500)

        do_GET = _dispatch
        do_POST = _dispatch

    return Handler


def serve(core: ExplorerCore, host: str = "127.0.0.1", port: int = 8080,
          static_dir: Optional[str] = None, background: bool = False,
          auth_token: Optional[str] = None,
          tls_cert: Optional[str] = None, tls_key: Optional[str] = None):
    return make_server(
        host, port, make_handler(core, static_dir, auth_token=auth_token),
        background=background, tls_cert=tls_cert, tls_key=tls_key)
