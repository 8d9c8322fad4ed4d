"""The gather cascade detectors (gifgan_tpu_torch/track/haar.py
GatherStageEvaluator, GatherHaarDetector, BatchedGatherHaarDetector) against
the JAX package's JaxStageEvaluator, JaxHaarDetector and
BatchedJaxHaarDetector on the repo's seeded cascade and the same seeded
frames.

Both evaluate the early stages in float32 from the same float32 integral
images, summing each feature's rects in order and the stage sums by a
product with the stage indicator; a window on a stage threshold could flip
under another summation order, so the survivor sets are compared per scale,
then the grouped boxes. Everything is compared for equality.
"""

import numpy as np
import pytest
import torch

from gifgan_tpu_torch.track import haar as TH
from gifgan_tpu_torch.track import synthetic_cascade as SC


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
def xml(tmp_path_factory):
    return SC.write_cascade(
        str(tmp_path_factory.mktemp("cascade") / "small.xml"), seed=0,
        stages=SC.SMALL_STAGES, n_pos=300, n_neg=1500)


@pytest.fixture(scope="module")
def grays():
    """4 frames of 96x112 with the glyph planted at several sizes, over
    black and over smooth noise, plus one of pure noise."""
    rng = np.random.default_rng(0)
    out = []
    for i, side in enumerate((34, 48, 60, 40)):
        f, _ = SC.planted_frame(rng, 96, 112, side,
                                "noise" if i % 2 else "black")
        out.append(f.astype(np.float64))
    out.append(rng.integers(0, 255, (96, 112)).astype(np.float64))
    return np.stack(out)


@pytest.fixture(scope="module")
def detectors(xml):
    from gifgan_tpu.track import haar as JH

    kw = dict(min_neighbors=2, min_size=20, scale_factor=1.2)
    return (JH.BatchedJaxHaarDetector(xml, **kw),
            TH.BatchedGatherHaarDetector(xml, device="cpu", **kw))


def test_survivor_sets_equal_per_scale(detectors, grays):
    from gifgan_tpu.track import haar as JH

    jd, td = detectors
    cas = td.cas
    h, w = grays.shape[1:]
    jev = JH.JaxStageEvaluator(jd.cas, jd.early_stages)
    survivors = 0
    scale = max(td.min_size / cas.window_w, 1.0)
    iis = np.stack([TH.integral_images(g)[0] for g in grays])
    ii2s = np.stack([TH.integral_images(g)[1] for g in grays])
    while True:
        ww, wh, rs, xs, ys = TH._window_origins(cas, scale, h, w)
        if ww > w or wh > h:
            break
        batched = td._gather_eval(iis, ii2s, xs, ys, scale)
        for i in range(len(grays)):
            want = jev(iis[i], ii2s[i], xs.astype(np.int32),
                       ys.astype(np.int32), scale)
            got = td._gather_eval(iis[i], ii2s[i], xs, ys, scale)
            np.testing.assert_array_equal(got, want, err_msg=f"{scale} {i}")
            np.testing.assert_array_equal(batched[i], want)
            survivors += int(want.sum())
        scale *= td.scale_factor
    assert survivors > 20


def test_detect_rects_and_detect_batch_equal_jax(detectors, grays):
    jd, td = detectors
    batched = td.detect_batch(grays)
    want = jd.detect_batch(grays)
    found = 0
    for i, g in enumerate(grays):
        np.testing.assert_array_equal(batched[i], want[i])
        # batched equal to single, as tests/test_haar.py holds in JAX
        np.testing.assert_array_equal(td.detect_rects(g), batched[i])
        found += len(want[i]) > 0
    assert found >= 3 and len(want[-1]) == 0


def test_detect_video_equals_jax_and_the_python_detector(detectors, grays,
                                                         xml):
    jd, td = detectors
    rgb = np.repeat(grays[..., None], 3, -1).clip(0, 255).astype(np.uint8)
    got = td.detect_video(rgb)
    want = jd.detect_video(rgb)
    host = TH.HaarDetector(xml, min_neighbors=2, min_size=20,
                           scale_factor=1.2)
    for i, (g, w) in enumerate(zip(got, want)):
        assert [(d.x1, d.y1, d.x2, d.y2, d.frame_number) for d in g] == \
            [(d.x1, d.y1, d.x2, d.y2, d.frame_number) for d in w]
        assert [(d.x1, d.y1, d.x2, d.y2) for d in td(rgb[i], i)] == \
            [(d.x1, d.y1, d.x2, d.y2) for d in host(rgb[i], i)]


def test_frames_past_the_float32_bound_take_the_float64_path(xml):
    """h * w * 255 > 2^24: the numpy float64 detector's boxes, single and
    batched, as in the JAX package."""
    f, _ = SC.planted_frame(np.random.default_rng(3), 264, 256, 90,
                            "black")
    g = f.astype(np.float64)
    td = TH.BatchedGatherHaarDetector(xml, device="cpu", min_neighbors=2,
                                      min_size=60)
    host = TH.HaarDetector(xml, min_neighbors=2, min_size=60)
    want = host.detect_rects(g)
    assert len(want) >= 1
    np.testing.assert_array_equal(td.detect_rects(g), want)
    np.testing.assert_array_equal(td.detect_batch(g[None])[0], want)


def test_gather_detectors_are_reached_by_name_only():
    from gifgan_tpu_torch.track import detect

    assert detect.BACKENDS == ("auto", "device", "native", "cv2", "python")
    with pytest.raises(ValueError, match="unknown detector backend"):
        detect.default_detector("/none.xml", backend="gather")
