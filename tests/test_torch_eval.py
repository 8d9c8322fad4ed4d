"""The port's evaluation tools against the JAX package's on the same seeded
inputs: FAD (gifgan_tpu_torch/eval/fad.py), the face-track rate
(eval/track_rate.py), the survey export and pair manifests
(eval/survey.py) and the plateau stop that reads both metrics
(train/early_stop.py).

Tolerances: the h2 features from one converted state within 1e-5 of the
largest feature (float32 convolutions summed in another order); the
Gaussian fit and the Fréchet formula are the same float64 numpy, so equal;
FAD within 1e-3 relative or 1e-6 absolute, on more samples than feature
dimensions (the covariance's square root amplifies noise in near-zero
eigenvalues). The track rate's counts and report text, the survey files and
the early-stop events are equal.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gifgan_tpu.core.checkpoint import _flatten_with_paths
from gifgan_tpu.core.config import DCGANConfig as JDCGANConfig
from gifgan_tpu.eval import fad as jfad
from gifgan_tpu.models import dcgan as jdcgan
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core.config import DCGANConfig, TrackConfig
from gifgan_tpu_torch.eval import fad as tfad
from gifgan_tpu_torch.track import synthetic_cascade as SC

IMG = dict(output_size=32, c_dim=3, z_dim=12, gf_dim=8, df_dim=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    in each keeps this file's many small tensor ops from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dcgan_state():
    """One JAX init of a small image GAN and its port conversion, with
    running BN moments near the moments of the init's activations (the
    init's unit variances would flatten every feature to its bias)."""
    params, state = jax.jit(jdcgan.init, static_argnums=1)(
        jax.random.PRNGKey(0), JDCGANConfig(**IMG))
    rng = np.random.default_rng(7)

    def moments(path, a):
        lo, hi = ((1e-4, 4e-4) if "var" in jax.tree_util.keystr(path)
                  else (-1e-3, 1e-3))
        return rng.uniform(lo, hi, np.shape(a)).astype(np.float32)

    state = jax.tree_util.tree_map_with_path(moments, state)
    tree = interop.from_jax_flat(_flatten_with_paths(
        {"params": params, "state": state}), "cpu")
    return params, state, tree


def _images(n, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(shift, 0.5, (n, 32, 32, 3)), -1,
                   1).astype(np.float32)


def test_h2_features_within_1e_5(dcgan_state):
    params, state, tree = dcgan_state
    x = _images(16, 0)
    want = np.asarray(jfad.h2_features(params.discriminator,
                                       state.discriminator, x,
                                       JDCGANConfig(**IMG)))
    got = tfad.h2_features(tree["params"]["discriminator"],
                           tree["state"]["discriminator"], torch.as_tensor(x),
                           DCGANConfig(**IMG)).numpy()
    assert got.shape == want.shape == (16, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_gaussian_fit_and_frechet_distance_equal():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(50, 6)).astype(np.float32)
    b = rng.normal(0.3, 1.2, size=(40, 6))
    for got, want in zip(tfad.gaussian_fit(a), jfad.gaussian_fit(a)):
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    args = tfad.gaussian_fit(a) + tfad.gaussian_fit(b)
    assert tfad.frechet_distance(*args) == jfad.frechet_distance(*args) > 0
    same = tfad.gaussian_fit(a) * 2
    assert tfad.frechet_distance(*same) == jfad.frechet_distance(*same)
    assert tfad.frechet_distance(*same) < 1e-9


def test_fad_within_1e_3(dcgan_state):
    params, state, tree = dcgan_state
    real, fake = _images(96, 2), _images(80, 3, shift=0.2)
    jcfg, tcfg = JDCGANConfig(**IMG), DCGANConfig(**IMG)
    tparams = tree["params"]["discriminator"]
    tstate = tree["state"]["discriminator"]
    want = jfad.fad(params.discriminator, state.discriminator, real, fake,
                    jcfg, batch=32)
    got = tfad.fad(tparams, tstate, real, fake, tcfg, batch=32, device="cpu")
    assert want > 1e-3
    assert abs(got - want) <= max(1e-3 * want, 1e-6)
    assert tfad.fad(tparams, tstate, real, real, tcfg, batch=40,
                    device="cpu") < 1e-6


def _glyph_clip(seed, n=10, h=64, w=72, side=44):
    """A glyph drifting 1 px a frame over black: the seeded cascade tracks
    it."""
    rng = np.random.default_rng(seed)
    x0, y0 = (int(v) for v in rng.integers(2, 8, 2))
    glyph = np.rint(SC.glyph_image(side)).astype(np.uint8)
    clip = np.zeros((n, h, w, 3), np.uint8)
    for t in range(n):
        clip[t, y0 + t // 3:y0 + t // 3 + side, x0 + t:x0 + t + side] = \
            glyph[..., None]
    return clip


def test_face_track_rate_and_report_equal(tmp_path):
    from gifgan_tpu.core.config import TrackConfig as JTrackConfig
    from gifgan_tpu.eval import track_rate as jtr
    from gifgan_tpu.track import haar as JH
    from gifgan_tpu_torch.eval import track_rate as ttr
    from gifgan_tpu_torch.track import haar as TH

    xml = SC.write_cascade(str(tmp_path / "c.xml"), seed=0,
                           stages=SC.SMALL_STAGES, n_pos=300, n_neg=1500)
    rng = np.random.default_rng(4)
    clips = [_glyph_clip(0), _glyph_clip(1),
             rng.integers(0, 255, (8, 64, 72, 3)).astype(np.uint8),
             np.zeros((3, 5), np.uint8)]             # tracking raises
    cfg = {**{f: getattr(ttr.EVAL_TRACK_CONFIG, f)
              for f in ("min_frame_count", "min_total_detections",
                        "max_skip", "target_size")}, "flow_backend": "jax"}
    got = ttr.face_track_rate(clips, TH.HaarDetector(xml, min_neighbors=2),
                              TrackConfig(**cfg), device="cpu")
    want = jtr.face_track_rate(clips, JH.HaarDetector(xml, min_neighbors=2),
                               JTrackConfig(**cfg))
    for k in ("rate", "tracked", "total"):
        assert got[k] == want[k], k
    assert got["tracked"] == 2 and got["total"] == 4
    assert got["stats"].counters == want["stats"].counters
    assert got["stats"].cnt_files_errored == 1
    assert (ttr.EVAL_TRACK_CONFIG.min_frame_count,
            ttr.EVAL_TRACK_CONFIG.max_skip) == (6, 2)

    text = ttr.track_rate_report({"glyph": got, "b": got},
                                 out_dir=str(tmp_path / "t"))
    assert text == jtr.track_rate_report({"glyph": want, "b": want},
                                         out_dir=str(tmp_path / "j"))
    assert "glyph: 2/4 (50.0%)" in text
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    for name in ("summary.txt", os.path.join("glyph_results", "stats.txt")):
        assert (tmp_path / "t" / name).read_text() == \
            (tmp_path / "j" / name).read_text()


def test_survey_tools_equal(tmp_path):
    from gifgan_tpu.data import video as jvideo
    from gifgan_tpu.eval import survey as jsv
    from gifgan_tpu_torch.data import video as tvideo
    from gifgan_tpu_torch.eval import survey as tsv

    rng = np.random.default_rng(5)
    vids = {v: rng.integers(0, 256, (6, 4, 16, 16, 3), dtype=np.uint8)
            for v in ("rnn", "nested")}
    fns = {v: (lambda n, v=v: vids[v][:n]) for v in vids}
    mt = tsv.export_survey_samples(fns, str(tmp_path / "t"),
                                   samples_per_variant=5, fps=6.0)
    mj = jsv.export_survey_samples(fns, str(tmp_path / "j"),
                                   samples_per_variant=5, fps=6.0)
    assert mt == mj and len(mt["variants"]["rnn"]) == 5
    for f in mt["variants"]["nested"]:
        np.testing.assert_array_equal(
            tvideo.read_gif(str(tmp_path / "t" / f)),
            jvideo.read_gif(str(tmp_path / "j" / f)))
    for side in ("t", "j"):
        assert json.loads((tmp_path / side / "manifest.json").read_text()) \
            == mt

    for kw in (dict(), dict(n=3, seed=4, url_prefix="https://h/")):
        pt = tsv.make_pair_manifest(str(tmp_path / "t"), "rnn", "nested",
                                    **kw)
        pj = jsv.make_pair_manifest(str(tmp_path / "j"), "rnn", "nested",
                                    **kw)
        assert pt == pj
        for name in ("pairs.json", "pairs.csv"):
            assert (tmp_path / "t" / name).read_text() == \
                (tmp_path / "j" / name).read_text()
    with pytest.raises(ValueError, match="not in manifest"):
        tsv.make_pair_manifest(str(tmp_path / "t"), "rnn", "stride")
    with pytest.raises(ValueError, match="available pairs"):
        tsv.make_pair_manifest(str(tmp_path / "t"), "rnn", "nested", n=9)

    responses = [{"pair": int(rng.integers(0, 3)),
                  "choice": "AB"[int(rng.integers(0, 2))],
                  "worker": f"w{int(rng.integers(0, 3))}"}
                 for _ in range(40)] + [{"pair": 99, "choice": "A"},
                                        {"pair": 0, "choice": "C"}]
    assert tsv.aggregate_pair_responses(pt, responses) == \
        jsv.aggregate_pair_responses(pj, responses)

    grids = rng.integers(0, 256, (3, 48, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        tsv.stride_control_videos(grids, 16, 5, 4, seed=2),
        jsv.stride_control_videos(grids, 16, 5, 4, seed=2))


_TRACES = {
    "improving": ((2, 1, 0.0), [(r / 32, 5.0 - r / 10)
                                for r in range(10, 30)]),
    "plateau": ((3, 2, 0.0), [(0.5, 3.0), (0.7, 3.0), (0.7, 3.0),
                              (0.7, 3.0), (0.7, 3.0)]),
    "erosion": ((3, 2, 0.0), [(r, None) for r in
                              (0.6, 0.8, 0.9, 0.84, 0.72, 0.66, 0.75)]),
    "fad_ties": ((2, 1, 0.0), [(1.0, 3.5), (1.0, 3.0), (1.0, 2.7),
                               (1.0, 2.9), (1.0, 2.9)]),
    "tie_delta": ((2, 1, 0.5), [(1.0, 3.0), (1.0, 2.8), (1.0, 2.6)]),
    "warmup": ((1, 5, 0.0), [(0.5, None)] * 6),
    "fad_only": ((2, 1, 0.0), [(None, 5.0), (None, 4.0), (None, 4.2),
                               (None, 4.1)]),
    "signalless": ((1, 1, 0.0), [(None, None)] * 4 + [(0.5, None)] * 3),
}


@pytest.mark.parametrize("name", sorted(_TRACES))
def test_early_stop_events_and_replay_equal(name, tmp_path):
    """The traces of tests/test_early_stop.py through both policies: the
    same events and state, and a replay of the log equal to the live
    state."""
    from gifgan_tpu.train import early_stop as jes
    from gifgan_tpu_torch.train import early_stop as tes

    (patience, warmup, delta), trace = _TRACES[name]
    run = {}
    for side, mod in (("t", tes), ("j", jes)):
        policy = mod.QualityEarlyStop(mod.EarlyStopConfig(
            patience=patience, warmup_evals=warmup, fad_tie_delta=delta))
        events = [policy.observe(r, f, chunk=i + 1, step=(i + 1) * 100)
                  for i, (r, f) in enumerate(trace)]
        run[side] = (events, {k: v for k, v in vars(policy).items()
                              if k != "config"})
    assert run["t"] == run["j"]

    log = tmp_path / "endurance.jsonl"
    with open(log, "w") as f:
        for i, (r, fad) in enumerate(trace):
            f.write(json.dumps({"kind": "chunk", "chunk": i + 1}) + "\n")
            f.write(json.dumps({"kind": "eval", "chunk": i + 1,
                                "step": (i + 1) * 100, "rate": r,
                                "fad": fad}) + "\n")
        f.write('{"kind": "eval", "chunk": 99, "ra')     # torn mid-write
    for mod in (tes, jes):
        policy = mod.QualityEarlyStop(mod.EarlyStopConfig(
            patience=patience, warmup_evals=warmup, fad_tie_delta=delta))
        events = mod.replay_eval_log(str(log), policy)
        assert events == [e for e in run["t"][0] if e is not None]
        assert {k: v for k, v in vars(policy).items()
                if k != "config"} == run["t"][1]
    part = tes.QualityEarlyStop(tes.EarlyStopConfig(patience=patience))
    assert tes.replay_eval_log(str(log), part, upto_chunk=2) == \
        jes.replay_eval_log(str(log), jes.QualityEarlyStop(
            jes.EarlyStopConfig(patience=patience)), upto_chunk=2)
    assert tes.replay_eval_log("/nonexistent/log.jsonl", part) == []
