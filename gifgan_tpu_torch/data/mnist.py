"""MNIST loading (gifgan_tpu/data/mnist.py), numpy only: the same arrays as
the JAX package's.

load_mnist reads the raw idx-ubyte files of a local directory (train and
test concatenated, 70k), shuffles X and y with the same seed (547), one-hot
labels, images scaled to [0, 1]. synthetic_digits is the deterministic
offline stand-in for tests and smoke runs. Nothing is downloaded.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def load_mnist(data_dir: str, y_dim: int = 10,
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X (70000, 28, 28, 1) float in [0,1], y one-hot (70000, 10))."""

    def read_images(path, n):
        with open(path, "rb") as f:
            buf = np.frombuffer(f.read(), np.uint8)
        return buf[16:].reshape(n, 28, 28, 1).astype(np.float64)

    def read_labels(path, n):
        with open(path, "rb") as f:
            buf = np.frombuffer(f.read(), np.uint8)
        return buf[8:].reshape(n).astype(np.float64)

    trX = read_images(os.path.join(data_dir, "train-images-idx3-ubyte"), 60000)
    trY = read_labels(os.path.join(data_dir, "train-labels-idx1-ubyte"), 60000)
    teX = read_images(os.path.join(data_dir, "t10k-images-idx3-ubyte"), 10000)
    teY = read_labels(os.path.join(data_dir, "t10k-labels-idx1-ubyte"), 10000)

    X = np.concatenate([trX, teX], axis=0)
    y = np.concatenate([trY, teY], axis=0).astype(int)

    seed = 547
    rng = np.random.RandomState(seed)
    rng.shuffle(X)
    rng = np.random.RandomState(seed)
    rng.shuffle(y)

    y_vec = np.zeros((len(y), y_dim), np.float64)
    y_vec[np.arange(len(y)), y] = 1.0
    return (X / 255.0).astype(np.float32), y_vec.astype(np.float32)


def synthetic_digits(n: int, size: int = 28, y_dim: int = 10,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic digit-ish blobs: each class is a distinct stroke pattern
    with noise — enough for training-smoke and shape tests offline."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n, size, size, 1), np.float32)
    labels = rng.integers(0, y_dim, n)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i, lab in enumerate(labels):
        ang = 2 * np.pi * lab / y_dim
        cx, cy = 0.5 + 0.2 * np.cos(ang), 0.5 + 0.2 * np.sin(ang)
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 0.02))
        ring = np.exp(-((np.sqrt((xx - 0.5) ** 2 + (yy - 0.5) ** 2)
                         - 0.1 - 0.02 * lab) ** 2) / 0.001)
        img = np.clip(blob + 0.5 * ring +
                      0.05 * rng.standard_normal((size, size)), 0, 1)
        X[i, :, :, 0] = img
    y_vec = np.zeros((n, y_dim), np.float32)
    y_vec[np.arange(n), labels] = 1.0
    return X, y_vec
