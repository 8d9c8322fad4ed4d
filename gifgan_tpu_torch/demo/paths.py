"""Expression-path library for the webcam/animation demos: numpy only, a
copy of gifgan_tpu/demo/paths.py with its names and results.

The reference ships 8 hand-authored latent paths (demo/manual_paths/*.txt:
smile, frown, surprise x2, shake_head, glasses, ...), each a repr'd list of
z(100) vectors applied as DELTAS from the path's first frame
(discriminator_activation_optimizer.py:287-293). Those were curated against
one specific trained checkpoint, so they don't transfer; this module
generates the same artifact PROCEDURALLY: named temporal envelopes applied
along latent directions.

Directions can be
  * seeded random unit vectors (demo default — works with any checkpoint),
  * the latent explorer's directions (gifgan_tpu/serve/explorer.py
    init_directions),
  * or data-driven: deltas of z-trajectories extracted from real clips by
    invert/z_finder.py (the reference's own workflow for finding expression
    directions, run_webcam_demo:46-48).

Every path starts at the zero vector, so delta application reproduces the
reference's `path - path[0]` semantics exactly.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

# name -> (direction index/indices, envelope function, scale)
# envelopes are defined on t in [0, 1]


def _bump(t):          # rise and return (smile/frown-style)
    return np.sin(np.pi * t)


def _double_pulse(t):  # two quick pulses (surprise)
    return np.abs(np.sin(2 * np.pi * t)) * (t < 1.0)


def _oscillate(t):     # two full periods (shake_head / nod)
    return np.sin(4 * np.pi * t)


def _step_hold(t):     # ramp up and stay (glasses on)
    return np.clip(3 * t, 0, 1)


def _spike(t):         # fast attack, slow decay (wink)
    return np.exp(-2 * t) * np.sin(np.pi / 2 * np.minimum(3 * t, 1.0))


EXPRESSIONS = {
    "smile": ((0,), _bump, 1.0),
    "frown": ((0,), lambda t: -_bump(t), 1.0),
    "surprise": ((1,), _double_pulse, 1.0),
    "surprise2": ((1, 2), _bump, 1.4),
    "shake_head": ((3,), _oscillate, 0.8),
    "nod": ((4,), _oscillate, 0.8),
    "glasses": ((5,), _step_hold, 1.2),
    "wink": ((6,), _spike, 1.0),
}


def make_expression_paths(z_dim: int, frames: int = 16,
                          magnitude: float = 0.8,
                          directions: Optional[np.ndarray] = None,
                          seed: int = 0) -> Dict[str, np.ndarray]:
    """{name: (frames, z_dim) float32 path starting at 0}. `directions`
    (N >= 7, z_dim) overrides the seeded random unit directions."""
    rng = np.random.default_rng(seed)
    if directions is None:
        d = rng.uniform(-1, 1, (8, z_dim))
        directions = d / np.linalg.norm(d, axis=1, keepdims=True)
    directions = np.asarray(directions, np.float32)
    t = np.linspace(0.0, 1.0, frames)
    out = {}
    for name, (dims, env, scale) in EXPRESSIONS.items():
        vec = directions[list(dims)].mean(axis=0)
        vec = vec / (np.linalg.norm(vec) + 1e-9)
        path = env(t)[:, None] * vec[None, :] * (magnitude * scale)
        path = path - path[0]          # start exactly at zero
        out[name] = path.astype(np.float32)
    return out


def write_paths(out_dir: str, paths: Dict[str, np.ndarray]) -> None:
    """Write paths in the reference manual_paths .txt protocol (repr'd
    array; parsed back by serve/explorer.py parse_z_text)."""
    os.makedirs(out_dir, exist_ok=True)
    for name, path in paths.items():
        text = "array(" + np.array2string(
            np.asarray(path), threshold=np.inf, max_line_width=int(1e9),
            separator=", ") + ")"
        with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
            f.write(text)
