"""The port's track modules (gifgan_tpu_torch/track/*, kernels/crop_resize.py)
against the JAX package on the same seeded numpy inputs, and the slice as a
whole: process_video and run_directory with an injected detector, and
run_directory and the `track` command with a cascade file (a seeded one,
track/synthetic_cascade.py) and the device detector on the CPU.

Tolerances: box geometry and the stats counters are integer-exact; the
similarity fit 1e-12 (float64, same formula); crop_resize_bilinear rtol 1e-5
/ atol 1e-3 grey levels (float32 lerps in the same order); process_video
box corners within 1 px and crops within 2 grey levels where the boxes agree
(the flow backends agree to a few 1e-3 px, tests/test_torch_flow.py, and
the crop truncates to uint8).
"""

import json
import os

import numpy as np
import pytest
import torch

from gifgan_tpu_torch.core.config import TrackConfig
from gifgan_tpu_torch.kernels.crop_resize import crop_resize_bilinear
from gifgan_tpu_torch.track import boxes as TB
from gifgan_tpu_torch.track import pipeline as tpipe
from gifgan_tpu_torch.track import stabilize as TS
from gifgan_tpu_torch.track.stats import TrackStats, combine_stats_files


def _random_detections(B, rng, n_frames=40, frame=(200, 160)):
    """Per-frame detection lists of two drifting faces with gaps and some
    clutter, as `B.Detection`s (B is either package's boxes module)."""
    per_frame = []
    for f in range(n_frames):
        dets = []
        if f % 3 != 1:
            x, y = 20 + f, 30 + f // 2
            dets.append(B.Detection(x, y, x + 40 + f % 2, y + 44, f))
        if f % 4 == 0 and f > 8:
            x, y = 120 - f // 2, 60
            dets.append(B.Detection(x, y, x + 30, y + 28, f))
        if rng.uniform() < 0.2:
            x, y = (int(v) for v in rng.integers(0, 100, 2))
            dets.append(B.Detection(x, y, x + 12, y + 12, f))
        per_frame.append(dets)
    return per_frame


def _as_tuples(tracks):
    return [[(d.x1, d.y1, d.x2, d.y2, d.frame_number, d.interpolated)
             for d in tr] for tr in tracks]


def test_boxes_chain_equals_jax():
    """Every boxes.py function, chained as process_video chains them, on the
    same detections: tracks, drops and stats are identical."""
    from gifgan_tpu.track import boxes as JB
    from gifgan_tpu.track.stats import TrackStats as JStats

    out = {}
    for name, B, Stats in (("jax", JB, JStats), ("port", TB, TrackStats)):
        rng = np.random.default_rng(7)
        per_frame = _random_detections(B, rng)
        stats = Stats()
        tracks = B.associate_detections(per_frame, 0.6, 6, stats=stats)
        n_assoc = _as_tuples(tracks)
        tracks, untracked = B.discard_invalid_tracks(tracks, 20, 5,
                                                     stats=stats)
        tracks = B.interpolate_missing_frames(tracks)
        expanded, oversize = B.expand_bounding_boxes(
            tracks, (200, 160), 256, 256, stats=stats)
        moved = B.same_size_crop(expanded[0][3], expanded[0][0])
        out[name] = (n_assoc, _as_tuples([untracked]), _as_tuples(expanded),
                     _as_tuples(oversize), _as_tuples([[moved]]),
                     stats.to_dict())
    assert out["port"] == out["jax"]
    assert len(out["port"][2]) >= 1 and len(out["port"][0]) > 2


def test_jaccard_equals_jax():
    from gifgan_tpu.track import boxes as JB

    rng = np.random.default_rng(3)
    a = rng.integers(0, 60, (6, 2))
    boxes = np.concatenate([a, a + rng.integers(1, 40, (6, 2))], 1)
    want = np.asarray(JB.jaccard_matrix(boxes[:4], boxes))
    got = TB.jaccard_matrix(boxes[:4], boxes)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for i in range(4):
        for j in range(6):
            ti = TB.jaccard_index(TB.Detection(*boxes[i], 0),
                                  TB.Detection(*boxes[j], 0))
            ji = JB.jaccard_index(JB.Detection(*boxes[i], 0),
                                  JB.Detection(*boxes[j], 0))
            assert ti == ji
            assert abs(got[i, j] - ti) < 1e-6
    assert TB.Detection.from_rect((3, 4, 10, 20), 5) == TB.Detection(
        3, 4, 13, 24, 5)


def test_fit_similarity_and_box_update_equal_jax():
    from gifgan_tpu.track import boxes as JB
    from gifgan_tpu.track import stabilize as JS

    rng = np.random.default_rng(0)
    src = rng.uniform(0, 100, (30, 2))
    theta, scale = 0.2, 1.1
    rot = scale * np.array([[np.cos(theta), -np.sin(theta)],
                            [np.sin(theta), np.cos(theta)]])
    dst = src @ rot.T + [5.0, -3.0] + rng.normal(0, 0.3, src.shape)
    m = TS.fit_similarity(src, dst)
    np.testing.assert_allclose(m, JS.fit_similarity(src, dst), atol=1e-12)
    np.testing.assert_allclose(m[:, :2], rot, atol=0.02)
    assert TS.fit_similarity(src[:1], dst[:1]) is None
    assert TS.fit_similarity(np.ones((4, 2)), dst[:4]) is None
    for transform in (m, np.array([[1.0, 0.0, 2.0], [0.0, 1.0, 0.0]])):
        got = TS.stabilized_box_update(
            TB.Detection(10, 12, 50, 52, 3), TB.Detection(12, 12, 52, 52, 4,
                                                          True),
            transform, 1.0)
        want = JS.stabilized_box_update(
            JB.Detection(10, 12, 50, 52, 3), JB.Detection(12, 12, 52, 52, 4,
                                                          True),
            transform, 1.0)
        assert _as_tuples([[got]]) == _as_tuples([[want]])


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_crop_resize_bilinear_matches_jax(dtype):
    import jax.numpy as jnp

    from gifgan_tpu.kernels.crop_resize import crop_resize_bilinear as jcrop

    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (4, 40, 56, 3)).astype(dtype)
    fidx = np.array([0, 3, 3, 1, 2], np.int32)
    # [y1, x1, y2, x2] inclusive: small, large, touching the frame's edges
    boxes = np.array([[5, 7, 20, 22], [0, 0, 39, 55], [10, 30, 12, 33],
                      [2, 3, 37, 50], [30, 40, 39, 55]], np.float32)
    want = np.asarray(jcrop(jnp.asarray(frames), jnp.asarray(fidx),
                            jnp.asarray(boxes), 16))
    got = crop_resize_bilinear(torch.from_numpy(frames),
                               torch.from_numpy(fidx),
                               torch.from_numpy(boxes), 16)
    assert got.shape == (5, 16, 16, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


def _square_video(T=30, H=96, W=128):
    """tests/test_track.py's clip: a textured square drifting 1 px/frame."""
    frames = np.zeros((T, H, W, 3), np.uint8)
    boxes = []
    for t in range(T):
        x, y = 20 + t, 30
        frames[t, y:y + 40, x:x + 40] = 200
        frames[t, y:y + 40:4, x:x + 40] = 90
        frames[t, y:y + 40, x:x + 40:5] = 140
        boxes.append((x, y, 40, 40))
    return frames, boxes


def _detector(Detection, boxes):
    def detector(frame, i):
        if i % 5 == 0:            # sparse detections force interpolation
            x, y, w, h = boxes[i]
            return [Detection(x, y, x + w, y + h, i)]
        return []
    return detector


CFG = dict(min_frame_count=10, min_total_detections=3, target_size=32,
           max_corners=50, flow_backend="mxu")


def test_process_video_matches_jax(monkeypatch):
    """The slice's prep path against the JAX package's, both on the device
    flow backend: the same clips, stabilized boxes within 1 px, the same
    TrackStats counters, crops within 2 grey levels where the boxes are
    equal."""
    from gifgan_tpu.core.config import TrackConfig as JTrackConfig
    from gifgan_tpu.track import boxes as JB
    from gifgan_tpu.track import pipeline as jpipe
    from gifgan_tpu.track import stabilize as JS
    from gifgan_tpu.track.stats import TrackStats as JStats

    frames, boxes = _square_video()
    seen = {}
    for name, mod in (("jax", JS), ("port", TS)):
        real = mod.stabilize_tracks

        def spy(*a, _real=real, _name=name, **kw):
            seen[_name] = _real(*a, **kw)
            return seen[_name]

        monkeypatch.setattr(mod, "stabilize_tracks", spy)

    jstats, tstats = JStats(), TrackStats()
    want = jpipe.process_video(frames, _detector(JB.Detection, boxes),
                               JTrackConfig(**CFG), jstats)
    got = tpipe.process_video(frames, _detector(TB.Detection, boxes),
                              TrackConfig(**CFG), tstats, device="cpu")
    assert len(got) == len(want) == 1
    assert [c.shape for c in got] == [c.shape for c in want]
    assert got[0].dtype == np.uint8 and got[0].shape[1:] == (32, 32, 3)
    assert got[0].shape[0] >= 10
    assert tstats.counters == jstats.counters
    assert tstats.cnt_final_tracks == 1
    assert (tstats.histograms["hst_num_feature_points"].keys()
            == jstats.histograms["hst_num_feature_points"].keys())

    (jt,), (tt,) = seen["jax"], seen["port"]
    jb = np.array([[d.x1, d.y1, d.x2, d.y2] for d in jt])
    tb = np.array([[d.x1, d.y1, d.x2, d.y2] for d in tt])
    assert np.abs(jb - tb).max() <= 1
    same = (jb == tb).all(axis=1)
    assert same.sum() >= 10
    diff = np.abs(got[0][same].astype(int) - want[0][same].astype(int))
    assert diff.max() <= 2


def test_unported_flow_backend_raises():
    """Every flow backend the JAX package names is ported ("jax" is the
    gather flow, track/flow_gather.py: tests/test_torch_flow_gather.py
    holds it to the JAX package); a name no package has raises."""
    frames, boxes = _square_video(T=12)
    cfg = TrackConfig(**{**CFG, "flow_backend": "jax", "min_frame_count": 5,
                         "min_total_detections": 2})
    clips = tpipe.process_video(frames, _detector(TB.Detection, boxes), cfg,
                                device="cpu")
    assert len(clips) == 1 and clips[0].shape[1:] == (32, 32, 3)
    cfg = TrackConfig(**{**CFG, "flow_backend": "pallas"})
    with pytest.raises(ValueError, match="flow_backend"):
        tpipe.process_video(frames, _detector(TB.Detection, boxes), cfg,
                            device="cpu")


@pytest.mark.parametrize("backend", ["auto", "mxu"])
def test_default_flow_backend_is_the_device_one(monkeypatch, backend):
    """"auto" (the TrackConfig default) and "mxu" both run the device flow
    kernels, with cv2 installed or not; the host flow must be named."""
    from gifgan_tpu_torch.kernels import flow as tflow

    assert TrackConfig().flow_backend == "auto"
    calls = []
    monkeypatch.setattr(tflow, "mxu_flow_backend",
                        lambda a, b, *args, **kw: calls.append(kw["device"]))
    monkeypatch.setattr(TS, "cv2_flow_backend",
                        lambda *a, **kw: pytest.fail("host flow was taken"))
    cfg = TrackConfig(**{**CFG, "flow_backend": backend})
    tpipe._flow_backend(cfg, "cpu")(None, None)
    assert [str(d) for d in calls] == ["cpu"]
    with pytest.raises(ValueError, match="flow_backend"):
        tpipe._flow_backend(TrackConfig(flow_backend="opencv"), "cpu")
    with pytest.raises(TypeError, match="flow_backend"):
        TS.stabilize_tracks([], [], (8, 8))


def test_missing_detector_raises(tmp_path):
    """No detector and no cascade file: the default ("auto") and every
    named cascade backend raise, from both entry points; OpenCV's own
    classifier is never taken unasked."""
    frames, _ = _square_video(T=4)
    (tmp_path / "in").mkdir()
    for backend in ("auto", "device", "native", "python"):
        cfg = TrackConfig(**{**CFG, "detector_backend": backend})
        with pytest.raises(ValueError, match="needs a cascade file"):
            tpipe.process_video(frames, None, cfg, device="cpu")
        with pytest.raises(ValueError, match="needs a cascade file"):
            tpipe.run_directory(str(tmp_path / "in"), str(tmp_path / "out"),
                                cfg, device="cpu")


def test_process_video_cv2_backend_within_3px_of_device_backend():
    """The JAX tests' contract between flow backends: stabilized box
    centres within 3 px."""
    pytest.importorskip("cv2")
    frames, boxes = _square_video()
    tracks = {}
    for backend in ("mxu", "cv2"):
        per_frame = [_detector(TB.Detection, boxes)(None, i)
                     for i in range(len(frames))]
        tr = TB.interpolate_missing_frames(
            TB.associate_detections(per_frame, 0.6, 6))
        gray = list(frames[..., 0])
        cfg = TrackConfig(**{**CFG, "flow_backend": backend})
        (tracks[backend],) = TS.stabilize_tracks(
            gray, tr, (128, 96), 10,
            flow_backend=tpipe._flow_backend(cfg, "cpu"))
    n = min(len(tracks["mxu"]), len(tracks["cv2"]))
    assert n >= 10
    for dm, dc in zip(tracks["mxu"][:n], tracks["cv2"][:n]):
        assert abs((dm.x1 + dm.x2) - (dc.x1 + dc.x2)) <= 6
        assert abs((dm.y1 + dm.y2) - (dc.y1 + dc.y2)) <= 6


def test_run_directory_parallel_matches_sequential(tmp_path):
    """workers=2 gives the same crops and merged stats as the sequential
    run; a broken file is isolated; a second run resumes; stats.json loads
    in the JAX package's combine_stats_files and params.json-style params
    land in the dashboard."""
    pytest.importorskip("cv2")
    from gifgan_tpu.track.stats import combine_stats_files as jcombine

    from gifgan_tpu_torch.data.video import decode_clip, encode_mp4

    frames, boxes = _square_video()
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for i in range(3):
        encode_mp4(str(in_dir / f"v{i}.mp4"), frames)
    (in_dir / "broken.mp4").write_bytes(b"not a video")
    cfg = TrackConfig(**CFG)
    detector = _detector(TB.Detection, boxes)

    runs = {}
    for name, workers in (("seq", 1), ("par", 2)):
        out = tmp_path / name
        runs[name] = tpipe.run_directory(str(in_dir), str(out), cfg,
                                         detector=detector, workers=workers,
                                         device="cpu")
    s1, s2 = runs["seq"], runs["par"]
    assert s1.cnt_files_processed == s2.cnt_files_processed == 3
    assert s1.cnt_files_errored == s2.cnt_files_errored == 1
    assert s1.cnt_final_tracks == s2.cnt_final_tracks == 3
    hist = lambda s: {k: v for k, v in s.histograms.items()
                      if k != "hst_time_per_gif"}
    assert s1.counters == s2.counters and hist(s1) == hist(s2)
    files = {n: sorted(f for f in os.listdir(tmp_path / n)
                       if f.endswith(".mp4")) for n in runs}
    assert files["seq"] == files["par"] == [f"v{i}_crop_0.mp4"
                                            for i in range(3)]
    a = decode_clip(str(tmp_path / "seq" / "v1_crop_0.mp4"), 10, None)
    b = decode_clip(str(tmp_path / "par" / "v1_crop_0.mp4"), 10, None)
    assert a.shape == (10, 32, 32, 3) and np.array_equal(a, b)

    # resume: the three done files are skipped, the broken one fails again
    again = tpipe.run_directory(str(in_dir), str(tmp_path / "seq"), cfg,
                                detector=detector, device="cpu")
    assert again.cnt_files_processed == 3 and again.cnt_files_errored == 1
    assert again.cnt_final_tracks == 0

    paths = [str(tmp_path / n / "stats.json") for n in ("seq", "par")]
    merged = jcombine(paths)
    # the resumed run rewrote seq/stats.json with no new tracks
    assert merged.cnt_final_tracks == 3 and merged.cnt_files_processed == 6
    assert merged.to_dict()["counters"] == \
        combine_stats_files(paths).to_dict()["counters"]
    with open(paths[1]) as f:
        assert json.load(f)["counters"]["cnt_final_tracks"] == 3
    html = (tmp_path / "par" / "stats.html").read_text()
    assert "min_jaccard" in html and "hst_track_len_final" in html


def test_run_directory_aborts_after_consecutive_errors(tmp_path):
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for i in range(5):
        (in_dir / f"bad{i}.gif").write_bytes(b"junk")

    def decode_fn(path):
        raise ValueError("cannot decode")

    stats = tpipe.run_directory(str(in_dir), str(tmp_path / "out"),
                                TrackConfig(**CFG), detector=lambda f, i: [],
                                decode_fn=decode_fn,
                                max_consecutive_errors=2, device="cpu")
    assert stats.cnt_files_errored == 2 and stats.total_files == 5


def test_stats_roundtrip_and_merge_equal_jax(tmp_path):
    from gifgan_tpu.track.stats import TrackStats as JStats

    def fill(s):
        s.cnt_total_detections = 5
        s.observe_jaccard_raw(0.72, 1)
        s.observe_jaccard_used(0.72, 1)
        s.observe_feature_points(17)
        s.observe_file_time(1.3)
        s.observe_track(12, [40, 41], [38])
        s.observe_final(2, [12, 30])
        return s

    t, j = fill(TrackStats()), fill(JStats())
    assert t.to_dict() == j.to_dict()
    assert t.render_text() == j.render_text()
    t.write(str(tmp_path / "t"), {"a": 1})
    back = TrackStats.from_dict(json.load(open(tmp_path / "t" /
                                               "stats.json")))
    assert back.merge(t).cnt_total_detections == 10
    assert back.merge(t).histograms["hst_jaccard_used"][0.7] == 2


# -- detection from a cascade file ------------------------------------------

GLYPH_CFG = dict(min_frame_count=10, min_total_detections=3, target_size=32,
                 max_corners=50, flow_backend="mxu", min_neighbors=3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    in each keeps the plain kernels' large elementwise passes from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cascade_xml(tmp_path_factory):
    from gifgan_tpu_torch.track import synthetic_cascade as SC

    # five stages: on black backgrounds they already single out the glyph,
    # and the kernel's plain version costs a pass over every window per tree
    return SC.write_cascade(
        str(tmp_path_factory.mktemp("cascade") / "small.xml"), seed=0,
        stages=SC.SMALL_STAGES[:5], n_pos=300, n_neg=1500)


def _glyph_gifs(in_dir, n, frames=12, h=96, w=128, side=64):
    """n GIFs of the cascade's glyph drifting 1 px a frame over black, at a
    size that is its own letterbox canvas (multiples of 32). 64 px, not
    fewer: the stabilizer needs some tens of corners inside the box."""
    from gifgan_tpu_torch.data.video import write_gif
    from gifgan_tpu_torch.track import synthetic_cascade as SC

    glyph = np.rint(SC.glyph_image(side)).astype(np.uint8)
    for i in range(n):
        clip = np.zeros((frames, h, w, 3), np.uint8)
        for t in range(frames):
            x, y = 10 + 4 * i + t, 8 + 3 * i + t // 2
            clip[t, y:y + side, x:x + side] = glyph[:, :, None]
        write_gif(str(in_dir / f"g{i}.gif"), clip)


def _crops(out_dir):
    from gifgan_tpu_torch.data.video import read_gif

    names = sorted(f for f in os.listdir(out_dir) if "_crop_" in f)
    return {n: read_gif(str(out_dir / n)) for n in names}


def test_process_video_builds_the_default_detector(cascade_xml):
    from gifgan_tpu_torch.track.haar_device import DeviceHaarDetector

    frames, boxes = _square_video(T=4)
    built = []
    real = DeviceHaarDetector.detect_video

    def spy(self, f):
        built.append(self)
        return real(self, f)

    DeviceHaarDetector.detect_video = spy
    try:
        out = tpipe.process_video(frames, None, TrackConfig(**GLYPH_CFG),
                                  device="cpu", cascade_path=cascade_xml)
    finally:
        DeviceHaarDetector.detect_video = real
    assert out == [] and len(built) == 1
    assert built[0].device.type == "cpu" and built[0].min_neighbors == 3


def test_run_directory_with_cascade_batched_composed_and_per_file(
        tmp_path, cascade_xml):
    """The three ways through detection write the same crops: serial batched
    (auto: 8 clips a dispatch), the composed dispatcher (workers=2, 2 clips
    a dispatch) and per-file detect_video (backend named, no batch). The
    sources are their own letterbox canvas, so batching changes no frame's
    level plan."""
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    _glyph_gifs(in_dir, 2)
    (in_dir / "broken.gif").write_bytes(b"GIF89a-not-really")
    runs = {
        "serial": dict(cfg={}, workers=1),
        "composed": dict(cfg={}, workers=2, detect_batch_clips=2),
        "per_file": dict(cfg={"detector_backend": "device"}, workers=1),
    }
    stats, crops, params = {}, {}, {}
    for name, kw in runs.items():
        cfg = TrackConfig(**{**GLYPH_CFG, **kw.pop("cfg")})
        stats[name] = tpipe.run_directory(
            str(in_dir), str(tmp_path / name), cfg, cascade_path=cascade_xml,
            device="cpu", **kw)
        crops[name] = _crops(tmp_path / name)
        with open(tmp_path / name / "params.json") as f:
            params[name] = json.load(f)
    for name, s in stats.items():
        assert s.cnt_files_processed == 2 and s.cnt_files_errored == 1, name
        # the five-stage cascade may add a spurious track or two
        assert s.cnt_final_tracks >= 2, (name, s.counters)
        assert {f"g{i}_crop_0.gif" for i in range(2)} <= set(crops[name])
    assert stats["serial"].counters == stats["composed"].counters \
        == stats["per_file"].counters
    for name in ("composed", "per_file"):
        assert sorted(crops[name]) == sorted(crops["serial"])
        for k, clip in crops["serial"].items():
            assert clip.shape[1:] == (32, 32, 3) and clip.shape[0] >= 10
            assert np.array_equal(clip, crops[name][k]), (name, k)
    assert params["serial"]["detector_backend_selected"] == "device"
    assert params["serial"]["detect_batch_clips_selected"] == 8
    assert params["composed"]["detect_batch_clips_selected"] == 2
    assert "detector_backend_selected" not in params["per_file"]
    assert params["per_file"]["detector_backend"] == "device"
    # a crop follows the glyph: its bright face sits in the crop's middle

    def centred(clip):
        ys, xs = np.nonzero(clip[5].max(axis=-1) > 100)
        return abs(ys.mean() - 15.5) < 3 and abs(xs.mean() - 15.5) < 3

    assert any(centred(c) for k, c in crops["serial"].items()
               if k.startswith("g0_"))


@pytest.mark.parametrize("workers", [1, 2])
def test_each_source_is_decoded_once(tmp_path, cascade_xml, workers):
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    _glyph_gifs(in_dir, 2, frames=4)
    from gifgan_tpu_torch.data.video import read_gif

    seen = []

    def decode_fn(path):
        seen.append(os.path.basename(path))
        return read_gif(path)

    s = tpipe.run_directory(str(in_dir), str(tmp_path / "out"),
                            TrackConfig(**GLYPH_CFG),
                            cascade_path=cascade_xml, decode_fn=decode_fn,
                            workers=workers, device="cpu")
    assert s.cnt_files_processed == 2 and sorted(seen) == ["g0.gif", "g1.gif"]


@pytest.mark.parametrize("workers", [1, 2])
def test_failed_dispatch_marks_the_group_errored(tmp_path, capsys, workers):
    """A detect_clips that raises is not retried per clip on another path:
    its group's files count as errored and the traceback prints; the next
    group still runs."""
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    _glyph_gifs(in_dir, 3, frames=4)

    class Detector:
        calls = 0

        def detect_clips(self, grays):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("dispatch refused")
            return [[np.zeros((0, 4), np.int32)] * len(g) for g in grays]

        def __call__(self, frame, n):
            pytest.fail("per-clip detection was taken")

    det = Detector()
    s = tpipe.run_directory(str(in_dir), str(tmp_path / "out"),
                            TrackConfig(**GLYPH_CFG), detector=det,
                            detect_batch_clips=2, workers=workers,
                            device="cpu")
    assert det.calls == 2
    assert s.cnt_files_errored == 2 and s.cnt_files_processed == 1
    assert "dispatch refused" in capsys.readouterr().err
    assert _crops(tmp_path / "out") == {}


def test_track_command_on_the_cpu(tmp_path, cascade_xml):
    """`python -m gifgan_tpu_torch track --device cpu` over two GIFs."""
    import subprocess
    import sys

    in_dir = tmp_path / "in"
    in_dir.mkdir()
    _glyph_gifs(in_dir, 2, frames=6)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "gifgan_tpu_torch", "track",
           "--input-directory", str(in_dir), "--output-directory",
           str(tmp_path / "out"), "--cascade", cascade_xml,
           "--min-frame-count", "5", "--min-total-detections", "3",
           "--target-size", "32", "--workers", "2"]
    out = subprocess.run(cmd + ["--device", "cpu"], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo,
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "cnt_files_processed" in out.stdout
    with open(tmp_path / "out" / "params.json") as f:
        params = json.load(f)
    assert params["detector_backend_selected"] == "device"
    assert params["detect_batch_clips_selected"] == 8
    with open(tmp_path / "out" / "stats.json") as f:
        counters = json.load(f)["counters"]
    assert counters["cnt_files_processed"] == 2
    assert counters["cnt_files_errored"] == 0
    assert counters["cnt_total_detections"] >= 12
    # without --device the command wants the card
    if not torch.cuda.is_available():
        bad = subprocess.run(cmd, cwd=repo,
                             env=dict(os.environ, PYTHONPATH=repo),
                             capture_output=True, text=True, timeout=300)
        assert bad.returncode != 0 and "CUDA" in bad.stderr
