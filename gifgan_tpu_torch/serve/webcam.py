"""Webcam face-animation demo as an HTTP service (gifgan_tpu/serve/webcam.py).

The reference ships the captured face to a GPU box over scp, runs the
inversion script over ssh, and copies results back
(demo/webcam_client.py:229-247 + demo/run_webcam_demo). Here that machine
boundary is a plain HTTP service in front of the inversion on the card:

  POST /animate  (PNG body)  ->  JSON { reconstruction, progress_video,
                                        paths: {name: mp4 path} }

Server pipeline per request (run_webcam_demo:16-43 semantics): resize the
face to model resolution, optimize z for `steps` Adam steps against
pixel-L1 (1.0) + D-activation-L1 (0.3) losses (invert/optimize.py
invert_images), write the reconstruction PNG, a progress video over the
capture-section schedule [(0,1),(50,5),(100,30)], and one animation per
expression path applied as deltas from the recovered z.

The videos stay mp4 (data/video.py encode_mp4, mp4v through cv2, which
raises where cv2 has no mp4 writer): the webcam client reads these names.
PNGs are written by ops/image.py write_png and uploads decoded by cv2
(IMREAD_COLOR, then BGR to RGB), as the card's machine has no imageio; a
grayscale upload gives three equal channels. An upload off the model size
is resized by ops/image.py resize_bilinear (jax.image.resize "linear").

The backend resolves its device when it is built, so a missing card stops
the service before it listens. `animate` takes the request lock only to
number the request: concurrent inversions share the card, as in the
reference.

Client-side face capture (webcam_client.py:36-127) — Haar box + the same
aspect-expansion math as the track pipeline — is `capture_face`, taking any
frame source so tests can inject frames instead of a camera.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core.config import InvertConfig
from gifgan_tpu_torch.data.video import encode_mp4
from gifgan_tpu_torch.invert import apply_latent_path, invert_images
from gifgan_tpu_torch.models import dcgan
from gifgan_tpu_torch.ops.image import (denorm_u8, encode_png,
                                        inverse_transform, merge_grid,
                                        resize_bilinear, to_uint8, write_png)
from gifgan_tpu_torch.serve.explorer import parse_z_text
from gifgan_tpu_torch.serve.http_common import (MAX_IMAGE_BODY, body_length,
                                                make_server)
from gifgan_tpu_torch.track.boxes import expand_bounding_boxes

DEFAULT_SECTIONS = [(0, 1), (50, 5), (100, 30)]


def _resize_u8(image: np.ndarray, size: int) -> np.ndarray:
    """(h, w, c) uint8 -> (size, size, c) uint8: resize_bilinear, then
    clipped and truncated to uint8 as the reference casts."""
    out = resize_bilinear(torch.as_tensor(image), size, size).numpy()
    return np.clip(out, 0, 255).astype(np.uint8)


class WebcamBackend:
    """Owns the frozen DCGAN on `device` (None: the card) and serves
    inversion+animation requests."""

    def __init__(self, params, state, cfg, out_dir: str,
                 paths: Optional[Dict[str, np.ndarray]] = None,
                 steps: int = 1200, pixel_l1: float = 1.0,
                 activation_l1: float = 0.3, learning_rate: float = 0.05,
                 lr_decay_every: int = 1000, batch_size: int = 16,
                 fps: float = 10.0, device=None):
        self.device = resolve_device(device)
        self.params = dcgan.to_device(params, self.device)
        self.state = dcgan.to_device(state, self.device)
        self.cfg = cfg
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.paths = paths or {}
        self.icfg = InvertConfig(
            steps=steps, learning_rate=learning_rate,
            lr_decay_every=lr_decay_every, pixel_l1=pixel_l1,
            activation_l1=activation_l1, batch_size=batch_size)
        self.fps = fps
        self._req = 0
        self._lock = threading.Lock()

    def warmup(self) -> None:
        """Run a full animate on a dummy frame into a throwaway directory
        before serving (the first call on the card loads cuDNN and picks
        its algorithms), so no junk artifacts land in out_dir and no
        request id is consumed."""
        import shutil
        import tempfile

        orig_dir, orig_req = self.out_dir, self._req
        tmp = tempfile.mkdtemp(prefix="gifgan_webcam_warmup_")
        try:
            self.out_dir = tmp
            self.animate(np.zeros(
                (self.cfg.output_size, self.cfg.output_size, 3), np.uint8))
        finally:
            self.out_dir, self._req = orig_dir, orig_req
            shutil.rmtree(tmp, ignore_errors=True)

    def animate(self, face_u8: np.ndarray, sections=None, *,
                z0=None) -> Dict:
        """face_u8: (s, s, 3) uint8 RGB at model resolution. Returns paths of
        written artifacts. z0: the inversion's starting latents (batch_size,
        z_dim); None draws them from seed 0 (invert/optimize.py
        initial_z)."""
        with self._lock:
            req = self._req
            self._req += 1
        req_dir = os.path.join(self.out_dir, f"req_{req}")
        os.makedirs(req_dir, exist_ok=True)

        target = face_u8.astype(np.float32) / 127.5 - 1.0
        targets = np.tile(target, (self.icfg.batch_size, 1, 1, 1))
        z, losses, frames = invert_images(
            self.params, self.state, targets, self.cfg, self.icfg,
            progress_sections=sections or DEFAULT_SECTIONS,
            device=self.device, z0=z0)

        if frames:
            recon = frames[-1][0]
        else:
            recon = dcgan.sample(self.params, self.state, z, self.cfg)[0]
        recon_path = os.path.join(req_dir, "reconstruction.png")
        write_png(recon_path, denorm_u8(recon))

        progress_path = None
        if frames:
            rows = int(np.sqrt(self.icfg.batch_size))
            grid_frames = np.stack([
                to_uint8(inverse_transform(merge_grid(
                    torch.from_numpy(f), rows,
                    self.icfg.batch_size // rows))).numpy()
                for f in frames])
            progress_path = os.path.join(req_dir, "progress.mp4")
            encode_mp4(progress_path, grid_frames, fps=self.fps)

        path_files = {}
        for name, path_zs in self.paths.items():
            vid = apply_latent_path(self.params, self.state, z[:1], path_zs,
                                    self.cfg, device=self.device)[:, 0]
            out = os.path.join(req_dir, f"path_{name}.mp4")
            encode_mp4(out, denorm_u8(vid), fps=self.fps)
            path_files[name] = out

        return {
            "reconstruction": recon_path,
            "progress_video": progress_path,
            "paths": path_files,
            "final_loss": float(losses[-1]) if len(losses) else None,
        }


def load_latent_paths(path_dir: str, z_dim: int) -> Dict[str, np.ndarray]:
    """Load expression paths: .npy arrays or repr'd-array .txt files
    (reference manual_paths/*.txt protocol, …optimizer.py:104-118)."""
    out = {}
    for name in sorted(os.listdir(path_dir)):
        full = os.path.join(path_dir, name)
        stem, ext = os.path.splitext(name)
        if ext == ".npy":
            arr = np.load(full)
        elif ext == ".txt":
            with open(full) as f:
                arr = parse_z_text(f.read())
        else:
            continue
        out[stem] = np.asarray(arr, np.float32).reshape(-1, z_dim)
    return out


def capture_face(frame_source, detector, expand_factor: float = 1.0,
                 target_size: int = 64, max_frames: int = 10000):
    """Client-side capture loop logic (webcam_client.py:36-127), camera-free:
    `frame_source` yields (frame_rgb, accept: bool); the first accepted frame
    with a detection is aspect-expanded (same math as the track pipeline) and
    resized to the model resolution. Returns (face_u8, box) or (None, None)."""
    for i, (frame, accept) in enumerate(frame_source):
        if i >= max_frames:
            break
        dets = detector(frame, i)
        if not dets or not accept:
            continue
        d = max(dets, key=lambda d: d.width * d.height)
        expanded, _ = expand_bounding_boxes(
            [[d]], (frame.shape[1], frame.shape[0]),
            target_size, target_size, scaling_factor=expand_factor)
        if not expanded:
            continue
        e = expanded[0][0]
        crop = frame[e.y1:e.y2 + 1, e.x1:e.x2 + 1]
        return _resize_u8(crop, target_size), e
    return None, None


def decode_upload(data: bytes, size: int) -> np.ndarray:
    """A PNG (or any image cv2 reads) -> (size, size, 3) uint8 RGB: cv2
    IMREAD_COLOR (alpha dropped, gray repeated to three channels), resized
    where it is another size. Raises ValueError on bytes cv2 cannot
    decode."""
    import cv2

    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError(f"cannot decode a {len(data)}-byte upload as an "
                         "image")
    img = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    if img.shape[:2] != (size, size):
        img = _resize_u8(img, size)
    return img


def serve(backend: WebcamBackend, host: str = "127.0.0.1", port: int = 8081,
          background: bool = False, auth_token: str = None,
          tls_cert: str = None, tls_key: str = None):
    """POST /animate with a PNG body; GET /health. When auth_token is set,
    /animate requires an `Authorization: Bearer <token>` header
    (constant-time compare); /health stays open as a liveness probe.
    Bodies over http_common.MAX_IMAGE_BODY are refused with 413 unread;
    tls_cert/tls_key enable in-process TLS (see http_common)."""
    import hmac
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _authorized(self) -> bool:
            if auth_token is None:
                return True
            hdr = self.headers.get("Authorization") or ""
            cand = hdr[len("Bearer "):] if hdr.startswith("Bearer ") else ""
            return hmac.compare_digest(cand, auth_token)

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                return self._json({"status": "ok"})
            self._json({"response": "error", "msg": "POST /animate"}, 404)

        def do_POST(self):
            if self.path != "/animate":
                return self._json({"response": "error"}, 404)
            if not self._authorized():
                return self._json({"response": "error",
                                   "msg": "unauthorized"}, 401)
            n = body_length(self, MAX_IMAGE_BODY)
            if n is None:
                return
            data = self.rfile.read(n)
            try:
                img = decode_upload(data, backend.cfg.output_size)
                result = backend.animate(img)
                self._json({"response": "success", **result})
            except Exception as e:
                self._json({"response": "error",
                            "msg": f"{type(e).__name__}: {e}"}, 500)

    return make_server(host, port, Handler, background=background,
                       tls_cert=tls_cert, tls_key=tls_key)


def animate_via_service(url: str, face_u8: np.ndarray,
                        out_dir: Optional[str] = None,
                        timeout: float = 600.0,
                        auth_token: Optional[str] = None,
                        tls_ca: Optional[str] = None) -> Dict:
    """Client half of the demo: POST a face image to a running webcam
    service and (optionally) copy the artifacts locally — the HTTP
    replacement for the reference's scp/ssh round trip
    (webcam_client.py:229-247). tls_ca: CA bundle (or the server's own
    self-signed cert) to trust for an https:// url."""
    import shutil
    import ssl
    from urllib.request import Request, urlopen

    headers = {"Content-Type": "image/png"}
    if auth_token is not None:
        headers["Authorization"] = f"Bearer {auth_token}"
    req = Request(url.rstrip("/") + "/animate", data=encode_png(face_u8),
                  headers=headers)
    ctx = ssl.create_default_context(cafile=tls_ca) if tls_ca else None
    with urlopen(req, timeout=timeout, context=ctx) as r:
        result = json.loads(r.read())
    if result.get("response") != "success":
        raise RuntimeError(f"service error: {result.get('msg')}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for key in ("reconstruction", "progress_video"):
            if result.get(key):
                shutil.copy(result[key], out_dir)
        for name, p in (result.get("paths") or {}).items():
            shutil.copy(p, out_dir)
    return result


def capture_face_live(detector, camera_index: int = 0, target_size: int = 64,
                      expand_factor: float = 1.0, cv2_mod=None,
                      window: str = "gifgan webcam", max_frames: int = 100000):
    """Live camera capture with the reference client's interaction loop
    (webcam_client.py:36-127): draw the largest detected face box on each
    frame, ENTER accepts the current detection, q/ESC aborts. Returns
    (face_u8, box) or (None, None).

    cv2_mod is injectable so the loop is testable headless (tests drive a
    fake camera + scripted keys); the real path uses cv2.VideoCapture."""
    if cv2_mod is None:
        import cv2 as cv2_mod  # pragma: no cover - needs a camera
    cap = cv2_mod.VideoCapture(camera_index)
    if not cap.isOpened():
        raise RuntimeError(f"camera {camera_index} unavailable")

    pending = {"frame": None, "accept": False, "quit": False}
    last_dets = {}  # frame index -> detections (avoid re-detecting in
                    # capture_face; the Haar pass dominates per-frame cost)

    def frames():
        i = 0
        while i < max_frames and not pending["quit"]:
            ok, bgr = cap.read()
            if not ok:
                return
            frame = bgr[..., ::-1].copy()  # BGR -> RGB
            dets = detector(frame, i)
            last_dets.clear()
            last_dets[i] = dets
            shown = bgr.copy()
            if dets:
                d = max(dets, key=lambda d: d.width * d.height)
                cv2_mod.rectangle(shown, (d.x1, d.y1), (d.x2, d.y2),
                                  (0, 255, 0), 2)
            cv2_mod.imshow(window, shown)
            key = cv2_mod.waitKey(30) & 0xFF
            if key in (13, 10):          # Enter: accept this frame
                yield frame, True
            elif key in (27, ord("q")):  # abort
                pending["quit"] = True
                yield frame, False
            else:
                yield frame, False
            i += 1

    def cached_detector(frame, i):
        return last_dets.get(i, detector(frame, i))

    try:
        face, box = capture_face(frames(), cached_detector,
                                 expand_factor=expand_factor,
                                 target_size=target_size)
    finally:
        cap.release()
        try:
            cv2_mod.destroyWindow(window)
        except Exception:
            pass
    return face, box


def result_carousel(result_paths, cv2_mod=None,
                    window: str = "gifgan results", max_events: int = 100000):
    """Keyboard carousel over inversion results (webcam_client.py:129-205):
    left/right (a/d or arrow codes) cycle items, q/ESC exits. Images show
    statically; videos loop frame-by-frame while the item is selected.
    Returns the list of items actually displayed (for tests)."""
    if cv2_mod is None:
        import cv2 as cv2_mod  # pragma: no cover - needs a display
    items = list(result_paths)
    if not items:
        return []
    shown = []
    idx = 0
    events = 0
    while events < max_events:
        path = items[idx]
        if path not in shown:
            shown.append(path)
        if path.endswith((".png", ".jpg", ".jpeg")):
            img = cv2_mod.imread(path)
            if img is not None:
                cv2_mod.imshow(window, img)
            key = cv2_mod.waitKey(50) & 0xFF
            events += 1
        else:  # video: loop one frame per key poll
            cap = cv2_mod.VideoCapture(path)
            key = None
            consecutive_failures = 0
            while events < max_events:
                ok, frame = cap.read()
                if not ok:
                    consecutive_failures += 1
                    if consecutive_failures >= 2:  # undecodable: skip item
                        key = cv2_mod.waitKey(40) & 0xFF
                        events += 1
                        break
                    cap.release()
                    cap = cv2_mod.VideoCapture(path)  # loop
                    continue
                consecutive_failures = 0
                cv2_mod.imshow(window, frame)
                key = cv2_mod.waitKey(40) & 0xFF
                events += 1
                if key != 255:
                    break
            cap.release()
        if key in (27, ord("q")):
            break
        if key in (ord("d"), 83):
            idx = (idx + 1) % len(items)
        elif key in (ord("a"), 81):
            idx = (idx - 1) % len(items)
    try:
        cv2_mod.destroyWindow(window)
    except Exception:
        pass
    return shown
