"""The latent explorer's z-text parser (gifgan_tpu/serve/explorer.py
parse_z_text), which `invert --input-paths` reads path files with. The
explorer's web app itself is not ported yet."""

from __future__ import annotations

import ast
import json
import re

import numpy as np


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
