"""Prefetching device feed + worker-pool video decode (the port of
gifgan_tpu/data/loader.py).

A background thread prepares the next batches while the card computes.
`clip_batches_from_files` is the multi-core stage: N decode workers (the
native GIF codec and cv2 both release the GIL inside their decode loops)
fill batches ahead of the consumer. The split between host and card: the
workers return uint8 clips at their source size and never touch CUDA; the
consumer copies a batch to the card and resizes + normalizes it there with
one `resize_normalize` call (K2) per group of same-sized clips.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from gifgan_tpu_torch import resolve_device

_DONE = object()


def _prefetch_worker(batch_iter, q, device_put, stop, err_box):
    """Free function on purpose: a bound-method target would make the worker
    thread hold a strong reference to the loader, so an abandoned loader
    (early `break` in a train loop, a test taking one batch) could never be
    garbage-collected and its worker would block on q.put forever. Every
    put is stop-aware and bounded so close()/__del__ can always release the
    thread."""
    try:
        for batch in batch_iter:
            if stop.is_set():
                return
            if device_put is not None:
                batch = device_put(batch)
            while not stop.is_set():
                try:
                    q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if stop.is_set():
                return
    except BaseException as e:  # surfaced on next()
        err_box.append(e)
    finally:
        while not stop.is_set():
            try:
                q.put(_DONE, timeout=0.1)
                break
            except queue.Full:
                continue


class PrefetchLoader:
    """Wraps a batch-producing iterator; prefetches up to `depth` batches on
    a worker thread and (optionally) places them with `device_put`. Call
    `close()` (or just drop the object — `__del__` covers abandonment) when
    breaking out before exhaustion, so the worker thread is released."""

    def __init__(self, batch_iter: Iterator, depth: int = 2,
                 device_put: Optional[Callable] = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err_box: list = []
        self._thread = threading.Thread(
            target=_prefetch_worker,
            args=(batch_iter, self._q, device_put, self._stop,
                  self._err_box),
            daemon=True)
        self._thread.start()

    def close(self):
        """Stop the worker without draining the source iterator. Safe to
        call multiple times, from __del__, or after normal exhaustion."""
        self._stop.set()
        try:
            while True:  # unblock a worker stuck in q.put
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _DONE:
            if self._err_box:
                raise self._err_box[0]
            raise StopIteration
        return item


def decode_clip_source(path: str, length: int) -> np.ndarray:
    """(length, H, W, 3) uint8 at the file's own size, from a .gif (native
    codec) or any cv2-decodable video; short clips pad by repeating the last
    frame. Host work only: this is what the decode workers run."""
    if path.endswith(".gif"):
        from gifgan_tpu_torch.data import native_gif

        frames = native_gif.decode_gif(path, max_frames=length)
        if frames.shape[0] < length:
            pad = np.repeat(frames[-1:], length - frames.shape[0], axis=0)
            frames = np.concatenate([frames, pad])
        return frames[:length]
    from gifgan_tpu_torch.data.video import decode_clip

    return decode_clip(path, length, None, strict=False)


def default_clip_decode(path: str, length: int, size: int,
                        device=None) -> np.ndarray:
    """(length, size, size, 3) uint8: decode_clip_source, resized on `device`
    where the file has another size (data/video.py resize_u8)."""
    from gifgan_tpu_torch.data.video import resize_u8

    frames = decode_clip_source(path, length)
    if frames.shape[1] != size or frames.shape[2] != size:
        frames = resize_u8(frames, size, device)
    return frames


def _to_device_batch(clips: List[np.ndarray], size: int, normalize: bool,
                     device: torch.device) -> torch.Tensor:
    """uint8 clips (T, H, W, 3) of any sizes -> (B, T, size, size, 3)
    float32 on `device`, one resize_normalize call per group of same-sized
    clips (identity taps where a clip is already (size, size))."""
    from gifgan_tpu_torch.kernels.resize import resize_normalize

    t = clips[0].shape[0]
    groups = {}
    for i, clip in enumerate(clips):
        groups.setdefault(clip.shape, []).append(i)
    out = None
    for shape, members in groups.items():
        x = torch.from_numpy(np.stack([clips[i] for i in members])).to(device)
        y = resize_normalize(x.reshape(-1, *shape[1:]), size, size,
                             normalize=normalize)
        y = y.reshape(len(members), t, size, size, 3)
        if len(groups) == 1:
            return y
        if out is None:
            out = torch.empty((len(clips), *y.shape[1:]),
                              dtype=torch.float32, device=device)
        out[members] = y
    return out


def clip_batches_from_files(paths: Sequence[str], batch_size: int,
                            length: int, size: int, epochs: int = 1,
                            shuffle: bool = True, seed: int = 0,
                            workers: int = 4,
                            decode_fn: Optional[Callable] = None,
                            fold_time: bool = True,
                            normalize: bool = True,
                            on_error: Optional[Callable] = None,
                            device=None) -> Iterator[torch.Tensor]:
    """Worker-pool decoded clip batches from video files on disk.

    Yields float32 tensors on `device`: (B*T, s, s, 3) in [-1, 1]
    (fold_time=True, the vid-GAN layout) or (B, T, s, s, 3); in [0, 255]
    when normalize=False. decode_fn(path) returns a (length, H, W, 3) uint8
    clip of any size and must not touch CUDA (default: decode_clip_source).
    Decode runs on `workers` threads with a bounded in-flight window
    (2x workers) ahead of the consumer; failed decodes are skipped
    (on_error(path, exc) observes them) and the batch backfills from
    subsequent files. A trailing partial batch is dropped."""
    device = resolve_device(device)
    decode_fn = decode_fn or (lambda p: decode_clip_source(p, length))
    rng = np.random.default_rng(seed)
    paths = list(paths)
    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        for _ in range(epochs):
            order = rng.permutation(len(paths)) if shuffle \
                else np.arange(len(paths))
            pending = []           # in-flight (path, future), submit-ordered
            idx = 0
            batch = []

            def submit_upto(k):
                nonlocal idx
                while idx < len(order) and len(pending) < k:
                    p = paths[order[idx]]
                    pending.append((p, pool.submit(decode_fn, p)))
                    idx += 1

            submit_upto(2 * max(1, workers))
            while pending:
                p, fut = pending.pop(0)
                try:
                    batch.append(np.asarray(fut.result()))
                except Exception as e:  # skip + backfill
                    if on_error is not None:
                        on_error(p, e)
                submit_upto(2 * max(1, workers) + 1)
                if len(batch) == batch_size:
                    out = _to_device_batch(batch, size, normalize, device)
                    batch = []
                    if fold_time:
                        out = out.reshape(-1, *out.shape[2:])
                    yield out


def batches_from_array(data: np.ndarray, batch_size: int, epochs: int = 1,
                       shuffle: bool = True, seed: int = 0,
                       drop_remainder: bool = True) -> Iterator[np.ndarray]:
    """Simple epoch x batch iterator over an in-memory array."""
    rng = np.random.default_rng(seed)
    n = data.shape[0]
    for _ in range(epochs):
        idx = rng.permutation(n) if shuffle else np.arange(n)
        end = (n // batch_size) * batch_size if drop_remainder else n
        for i in range(0, end, batch_size):
            yield data[idx[i:i + batch_size]]
