"""ctypes binding of the shared native GIF codec (native/gifcodec.cpp).

The C++ in the repository's native/ directory is shared with the JAX
package, not ported. Like gifgan_tpu/data/native_gif.py this builds it
with `make -C native` at first use. Serving and the track pipeline encode
with it; the clip feed and read_gif decode with it. There is no fallback
to another imaging library: without the codec the functions raise.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgifgan_native.so")

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                               capture_output=True)
            except (OSError, subprocess.CalledProcessError):
                return None
        lib = ctypes.CDLL(_LIB_PATH)
        if not hasattr(lib, "gifgan_decode"):
            raise RuntimeError(
                f"{_LIB_PATH} has no gifgan_decode: it is a stale build; "
                f"rebuild it with `make -C {_NATIVE_DIR} clean all`")
        lib.gifgan_decode.restype = ctypes.c_int
        lib.gifgan_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.gifgan_encode.restype = ctypes.c_int
        lib.gifgan_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.gifgan_free.restype = None
        lib.gifgan_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_gif_bytes(data: bytes, max_frames: int = 0) -> np.ndarray:
    """GIF bytes -> (n, h, w, 3) uint8 RGB via the native decoder;
    max_frames = 0 decodes every frame."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native gif codec unavailable (make -C native "
                           "failed)")
    out = ctypes.POINTER(ctypes.c_uint8)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    n = ctypes.c_int()
    rc = lib.gifgan_decode(data, len(data), ctypes.byref(out),
                           ctypes.byref(w), ctypes.byref(h), ctypes.byref(n),
                           max_frames)
    if rc != 0:
        raise ValueError(f"gif decode failed (rc={rc})")
    try:
        count = n.value * h.value * w.value * 3
        arr = np.ctypeslib.as_array(out, shape=(count,)).copy()
    finally:
        lib.gifgan_free(out)
    return arr.reshape(n.value, h.value, w.value, 3)


def decode_gif(path: str, max_frames: int = 0) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_gif_bytes(f.read(), max_frames)


def encode_gif_bytes(frames: np.ndarray, fps: float = 8.0) -> bytes:
    """(n, h, w, 3) uint8 RGB -> animated GIF bytes."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native gif codec unavailable (make -C native "
                           "failed)")
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError("frames must be (n, h, w, 3) uint8")
    n, h, w = frames.shape[:3]
    delay_cs = max(1, int(round(100.0 / fps)))
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    rc = lib.gifgan_encode(frames.tobytes(), n, w, h, delay_cs,
                           ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        raise ValueError(f"gif encode failed (rc={rc})")
    try:
        data = bytes(np.ctypeslib.as_array(out, shape=(out_len.value,)))
    finally:
        lib.gifgan_free(out)
    return data


def encode_gif(path: str, frames: np.ndarray, fps: float = 8.0,
               atomic: bool = True) -> None:
    data = encode_gif_bytes(frames, fps)
    tmp = path + ".tmp.gif" if atomic else path
    with open(tmp, "wb") as f:
        f.write(data)
    if atomic:
        os.replace(tmp, path)
