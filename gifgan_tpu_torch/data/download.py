"""Dataset downloaders: the port's copy of gifgan_tpu/data/download.py
(host code, no tensor in it; kept here so the port imports nothing of the
JAX package).

Same datasets (celebA zip, LSUN categories, MNIST idx files) with the HTTP
layer injected (`fetch_fn(url) -> bytes`) so the logic is testable
offline and swappable in production. Files land under
`<data_dir>/<dataset>/` like the reference's ./data layout (:27-128).
"""

from __future__ import annotations

import gzip
import os
import zipfile
from typing import Callable, Dict, List, Optional

MNIST_BASE = "https://storage.googleapis.com/cvdf-datasets/mnist/"
MNIST_FILES = [
    "train-images-idx3-ubyte.gz",
    "train-labels-idx1-ubyte.gz",
    "t10k-images-idx3-ubyte.gz",
    "t10k-labels-idx1-ubyte.gz",
]
LSUN_URL = ("http://dl.yf.io/lsun/scenes/{category}_"
            "{set_name}_lmdb.zip")
LSUN_CATEGORIES = ["bedroom", "bridge", "church_outdoor", "classroom",
                   "conference_room", "dining_room", "kitchen",
                   "living_room", "restaurant", "tower"]


def _default_fetch(url: str) -> bytes:
    from urllib.request import urlopen

    with urlopen(url, timeout=120) as r:
        return r.read()


def download_mnist(data_dir: str, fetch_fn: Optional[Callable] = None,
                   ) -> List[str]:
    """Fetch + gunzip the 4 idx files (reference download.py:110-128)."""
    fetch_fn = fetch_fn or _default_fetch
    out_dir = os.path.join(data_dir, "mnist")
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name in MNIST_FILES:
        target = os.path.join(out_dir, name[:-3])
        if os.path.exists(target):      # idempotent resume
            continue
        raw = fetch_fn(MNIST_BASE + name)
        with open(target, "wb") as f:
            f.write(gzip.decompress(raw))
        written.append(target)
    return written


def download_celeb_a(data_dir: str, url: str,
                     fetch_fn: Optional[Callable] = None) -> str:
    """Fetch + unzip the celebA archive (reference download.py:61-73). The
    hosting URL rotates; pass the current one."""
    fetch_fn = fetch_fn or _default_fetch
    out_dir = os.path.join(data_dir, "celebA")
    if os.path.isdir(out_dir) and os.listdir(out_dir):
        return out_dir
    os.makedirs(data_dir, exist_ok=True)
    zpath = os.path.join(data_dir, "celebA.zip")
    with open(zpath, "wb") as f:
        f.write(fetch_fn(url))
    with zipfile.ZipFile(zpath) as z:
        z.extractall(data_dir)
    os.remove(zpath)
    return out_dir


def download_lsun(data_dir: str, categories: Optional[List[str]] = None,
                  set_name: str = "train",
                  fetch_fn: Optional[Callable] = None) -> List[str]:
    """Fetch LSUN category archives (reference download.py:80-108)."""
    fetch_fn = fetch_fn or _default_fetch
    out_dir = os.path.join(data_dir, "lsun")
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for cat in categories or LSUN_CATEGORIES:
        target = os.path.join(out_dir, f"{cat}_{set_name}_lmdb.zip")
        if os.path.exists(target):
            continue
        with open(target, "wb") as f:
            f.write(fetch_fn(LSUN_URL.format(category=cat,
                                             set_name=set_name)))
        written.append(target)
    return written
