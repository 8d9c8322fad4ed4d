"""The measured window of a closed-loop cell: one call after another for
`seconds`, each followed by a fetch of the one scalar it returns, as a
training loop does. The host clock spans every call and fetch."""

from __future__ import annotations

import math
import time
from typing import Dict


def measure(cell, seconds: float) -> Dict:
    """{"window_s", "steps", "items", "failed", "dispatch_s"}: the window's
    length, its calls, the items they handled (cell.items_per_call
    each), the calls whose scalar was not finite, and each call's time
    before its fetch."""
    dispatch, failed, steps = [], 0, 0
    start = time.perf_counter()
    while True:
        a = time.perf_counter()
        out = cell.call()
        dispatch.append(time.perf_counter() - a)
        failed += not math.isfinite(float(out))
        steps += 1
        now = time.perf_counter()
        if now - start >= seconds:
            break
    return {"window_s": now - start, "steps": steps,
            "items": steps * cell.items_per_call, "failed": failed,
            "dispatch_s": dispatch}
