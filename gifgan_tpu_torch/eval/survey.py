"""Human-survey sample export: the port of gifgan_tpu/eval/survey.py (host
numpy; the GIFs go through the port's native encoder, data/video.py
write_gif).

Rebuild of the reference's MTurk evaluation pipeline (firebase/public/mturk/:
three 250-GIF sample sets — "rnn" recurrent_image, "nested" recurrent_z, and
a "stride" control built by cutting sample-grid images into fake videos,
models/recurrent_z/image_stitch.py:29-44). Produces the same artifact layout
as a static directory tree ready for any hosting (firebase or otherwise),
plus a manifest.json the survey frontend can load.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np


def export_survey_samples(sample_fns: Dict[str, Callable[[int], np.ndarray]],
                          out_dir: str, samples_per_variant: int = 250,
                          fps: float = 8.0, seed: int = 0) -> Dict:
    """sample_fns: variant name -> fn(n) returning (n, T, H, W, C) uint8
    videos. Writes out_dir/<variant>_samples/<i>.gif + manifest.json."""
    from gifgan_tpu_torch.data.video import write_gif

    os.makedirs(out_dir, exist_ok=True)
    manifest = {"variants": {}, "samples_per_variant": samples_per_variant}
    for variant, fn in sorted(sample_fns.items()):
        vdir = os.path.join(out_dir, f"{variant}_samples")
        os.makedirs(vdir, exist_ok=True)
        clips = np.asarray(fn(samples_per_variant))
        files = []
        for i, clip in enumerate(clips):
            name = f"{i}.gif"
            write_gif(os.path.join(vdir, name), clip, fps=fps)
            files.append(f"{variant}_samples/{name}")
        manifest["variants"][variant] = files
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


def make_pair_manifest(sample_dir: str, variant_a: str, variant_b: str,
                       n: Optional[int] = None, seed: int = 0,
                       url_prefix: str = "") -> Dict:
    """Randomized A/B pair manifest — the reference's actual human-eval
    protocol (data_collection/mturk/randomize_csv.py:44-53): each pair
    draws a swap bit; swap=0 shows variant_a in the left (A) slot, swap=1
    shows variant_b there. Workers then answer "which is more realistic"
    over the DISPLAYED slots and the swap bit recovers which underlying
    variant won (analyze_results.sql aggregates Answer_choice='optionA').

    Reads sample_dir/manifest.json (export_survey_samples layout), pairs
    the i-th file of each variant (the reference pairs line i of both file
    lists), writes sample_dir/pairs.json for the built-in survey server's
    A/B mode plus sample_dir/pairs.csv (`image_A_url,image_B_url,swap`
    with url_prefix prepended — the exact randomize_csv.py output shape)
    for an external MTurk HIT template. Returns the pairs dict."""
    with open(os.path.join(sample_dir, "manifest.json")) as f:
        manifest = json.load(f)
    variants = manifest["variants"]
    for v in (variant_a, variant_b):
        if v not in variants:
            raise ValueError(f"variant {v!r} not in manifest "
                             f"({sorted(variants)})")
    files_a, files_b = variants[variant_a], variants[variant_b]
    limit = min(len(files_a), len(files_b))
    if n is None:
        n = limit
    if n > limit:
        raise ValueError(f"n={n} > {limit} available pairs")
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n):
        swap = int(rng.integers(0, 2))
        a, b = files_a[i], files_b[i]
        shown_a, shown_b = (b, a) if swap else (a, b)
        pairs.append({"id": i, "shown_a": shown_a, "shown_b": shown_b,
                      "swap": swap})
    out = {"variant_a": variant_a, "variant_b": variant_b, "seed": seed,
           "pairs": pairs}
    with open(os.path.join(sample_dir, "pairs.json"), "w") as f:
        json.dump(out, f)
    with open(os.path.join(sample_dir, "pairs.csv"), "w") as f:
        f.write("image_A_url,image_B_url,swap\n")
        for p in pairs:
            f.write(f"{url_prefix}{p['shown_a']},"
                    f"{url_prefix}{p['shown_b']},{p['swap']}\n")
    return out


def aggregate_pair_responses(pairs: Dict, responses) -> Dict:
    """Preference win-rates from A/B responses, un-swapped to the underlying
    variants (reference analyze_results.sql semantics: overall
    percentage-prefer-displayed-A, per-worker splits, best pairs).

    responses: iterable of {"pair": id, "choice": "A"|"B", "worker": ...}.
    """
    by_id = {p["id"]: p for p in pairs["pairs"]}
    va, vb = pairs["variant_a"], pairs["variant_b"]
    wins = {va: 0, vb: 0}
    shown_a_chosen = 0
    per_worker: Dict = {}
    per_pair: Dict = {}
    total = 0
    for r in responses:
        p = by_id.get(r.get("pair"))
        choice = r.get("choice")
        if p is None or choice not in ("A", "B"):
            continue
        total += 1
        if choice == "A":
            shown_a_chosen += 1
        # un-swap: displayed slot A holds variant_b when swap=1
        chose_first_listed = (choice == "A") == (p["swap"] == 0)
        wins[va if chose_first_listed else vb] += 1
        w = str(r.get("worker", "?"))
        pw = per_worker.setdefault(w, {"n": 0, "shown_a": 0})
        pw["n"] += 1
        pw["shown_a"] += choice == "A"
        pp = per_pair.setdefault(p["id"], {"n": 0, va: 0, vb: 0})
        pp["n"] += 1
        pp[va if chose_first_listed else vb] += 1
    workers = {
        w: {"n": d["n"], "pct_prefer_shown_a": d["shown_a"] / d["n"]}
        for w, d in sorted(per_worker.items())
    }
    best_for_a = sorted(
        ({"pair": i, **d,
          "pct_" + va: d[va] / d["n"]} for i, d in per_pair.items()),
        key=lambda d: -d["pct_" + va])[:10]
    return {
        "variant_a": va, "variant_b": vb, "n_responses": total,
        "wins": wins,
        "win_rate_a": wins[va] / total if total else None,
        "pct_prefer_shown_a": shown_a_chosen / total if total else None,
        "workers": workers,
        "best_pairs_for_a": best_for_a,
    }


def stride_control_videos(grid_images: np.ndarray, tile: int,
                          frames_per_video: int, num_videos: int,
                          seed: int = 0) -> np.ndarray:
    """The "stride" control set: cut sample-grid pngs into random tiles and
    string them into fake videos (reference image_stitch.py:29-44) — a
    temporal-incoherence baseline for the survey."""
    rng = np.random.default_rng(seed)
    n, gh, gw = grid_images.shape[:3]
    rows, cols = gh // tile, gw // tile
    out = np.empty((num_videos, frames_per_video, tile, tile,
                    grid_images.shape[-1]), grid_images.dtype)
    for v in range(num_videos):
        for t in range(frames_per_video):
            g = rng.integers(0, n)
            r = rng.integers(0, rows)
            c = rng.integers(0, cols)
            out[v, t] = grid_images[g, r * tile:(r + 1) * tile,
                                    c * tile:(c + 1) * tile]
    return out
