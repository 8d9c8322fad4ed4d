"""The port's host cascade (gifgan_tpu_torch/track/haar.py) and its seeded
cascade file (track/synthetic_cascade.py) against the JAX package's
gifgan_tpu/track/haar.py on the same XML and the same seeded numpy inputs.

Everything here is float64 numpy on both sides with the same formulas, so
every comparison is exact (`array_equal`). The cascade is written from a seed
into a temporary directory; one optional case reads the real
haarcascade_frontalface_alt2.xml where the machine has it.
"""

import numpy as np
import pytest

from gifgan_tpu_torch.track import haar as TH
from gifgan_tpu_torch.track import synthetic_cascade as SC

CASCADE_FIELDS = ("rects", "n_rects", "node_feat", "node_thr", "node_left",
                  "node_right", "leaves", "stage_first", "stage_count",
                  "stage_thr")


@pytest.fixture(scope="module")
def xml(tmp_path_factory):
    return SC.write_cascade(
        str(tmp_path_factory.mktemp("cascade") / "small.xml"), seed=0,
        stages=SC.SMALL_STAGES, n_pos=300, n_neg=1500)


@pytest.fixture(scope="module")
def both(xml):
    from gifgan_tpu.track import haar as JH

    return JH.parse_cascade(xml), TH.parse_cascade(xml)


def _glyph_frame(seed, h, w, side, background="noise"):
    rng = np.random.default_rng(seed)
    frame, box = SC.planted_frame(rng, h, w, side, background)
    return frame.astype(np.float64), box


def _assert_cascades_equal(jc, tc):
    assert (tc.window_w, tc.window_h) == (jc.window_w, jc.window_h)
    for name in CASCADE_FIELDS:
        a, b = getattr(jc, name), getattr(tc, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_parse_cascade_equals_jax(both):
    jc, tc = both
    _assert_cascades_equal(jc, tc)
    assert tc.stage_count.tolist() == list(SC.SMALL_STAGES)
    assert len(tc.rects) == 2 * sum(SC.SMALL_STAGES)


def test_parse_real_cascade_equals_jax_when_present():
    """Optional: the cascade the detectors are written for, where the
    machine has it. Its shape is what synthetic_cascade.ALT2_STAGES copies."""
    from gifgan_tpu.track import haar as JH
    from gifgan_tpu_torch.track.detect import find_default_cascade

    path = find_default_cascade()
    if path is None:
        pytest.skip("no haarcascade_frontalface_alt2.xml on this machine")
    jc, tc = JH.parse_cascade(path), TH.parse_cascade(path)
    _assert_cascades_equal(jc, tc)
    assert tc.stage_count.tolist() == list(SC.ALT2_STAGES)
    assert (tc.window_w, tc.window_h) == (SC.WINDOW, SC.WINDOW)


@pytest.mark.parametrize("scale", [1.0, 1.1, 1.21, 2.5, 3.7])
def test_scaled_rects_equal_jax(both, scale):
    from gifgan_tpu.track import haar as JH

    jc, tc = both
    assert np.array_equal(JH._scaled_rects(jc, scale),
                          TH._scaled_rects(tc, scale))


@pytest.mark.parametrize("shape", [(20, 20), (33, 47), (64, 96)])
def test_integral_images_equal_jax(shape):
    from gifgan_tpu.track import haar as JH

    gray = np.random.default_rng(1).uniform(0, 255, shape)
    for a, b in zip(JH.integral_images(gray), TH.integral_images(gray)):
        assert a.shape == (shape[0] + 1, shape[1] + 1)
        assert np.array_equal(a, b)


@pytest.mark.parametrize("scale,lo,hi", [(1.0, 0, 3), (1.0, 3, 8),
                                         (1.5, 0, 8), (2.2, 2, 6)])
def test_eval_stages_equal_jax(both, scale, lo, hi):
    from gifgan_tpu.track import haar as JH

    jc, tc = both
    gray, _ = _glyph_frame(2, 96, 112, int(round(36 * scale)))
    ii, ii2 = TH.integral_images(gray)
    ext = int(round(SC.WINDOW * scale)) + 2
    ys, xs = (v.ravel() for v in np.mgrid[0:96 - ext:3, 0:112 - ext:3])
    want = JH._eval_stages(jc, ii, ii2, xs, ys, scale, lo, hi,
                           JH._scaled_rects(jc, scale))
    got = TH._eval_stages(tc, ii, ii2, xs, ys, scale, lo, hi,
                          TH._scaled_rects(tc, scale))
    assert got.dtype == bool and np.array_equal(got, want)
    if (lo, hi) == (0, 3):
        assert 0 < got.sum() < len(got)


@pytest.mark.parametrize("min_neighbors", [0, 1, 3])
def test_group_rectangles_equals_jax(min_neighbors):
    from gifgan_tpu.track import haar as JH

    rng = np.random.default_rng(4)
    centres = rng.integers(10, 90, (5, 2))
    boxes = np.concatenate([
        np.concatenate([c + rng.integers(-2, 3, (n, 2)),
                        30 + rng.integers(-2, 3, (n, 2))], axis=1)
        for c, n in zip(centres, (6, 4, 2, 1, 3))])
    want = JH.group_rectangles(boxes, min_neighbors)
    got = TH.group_rectangles(boxes, min_neighbors)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(TH.group_rectangles(np.zeros((0, 4)), 3),
                          JH.group_rectangles(np.zeros((0, 4)), 3))


@pytest.mark.parametrize("h,w,side,background", [(64, 64, 30, "black"),
                                                 (72, 96, 40, "noise")])
def test_haar_detector_rects_equal_jax(xml, h, w, side, background):
    """The numpy detector, and the glyph it was fitted to is found."""
    from gifgan_tpu.track import haar as JH

    gray, (x, y, s) = _glyph_frame(5, h, w, side, background)
    want = JH.HaarDetector(xml, min_neighbors=3).detect_rects(gray)
    det = TH.HaarDetector(xml, min_neighbors=3)
    got = det.detect_rects(gray)
    assert np.array_equal(got, want)
    best = got[np.argmax(got[:, 2] * got[:, 3])]
    assert np.abs(best - [x, y, s, s]).max() <= 3
    dets = det(np.repeat(gray[..., None], 3, 2).astype(np.uint8), 7)
    assert dets and all(d.frame_number == 7 for d in dets)
    with pytest.raises(ValueError, match="scale_factor"):
        TH.HaarDetector(xml, scale_factor=1.0)


@pytest.mark.parametrize("h,w,side,background", [(64, 64, 30, "noise"),
                                                 (128, 128, 60, "black"),
                                                 (200, 240, 90, "noise")])
def test_native_detector_rects_equal_jax(xml, h, w, side, background):
    """The C++ evaluator through the port's binding against the JAX
    package's binding, and against the numpy detector on the small case."""
    from gifgan_tpu.track import haar as JH

    gray, (x, y, s) = _glyph_frame(6, h, w, side, background)
    want = JH.NativeHaarDetector(xml, min_neighbors=3).detect_rects(gray)
    got = TH.NativeHaarDetector(xml, min_neighbors=3).detect_rects(gray)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    best = got[np.argmax(got[:, 2] * got[:, 3])]
    assert np.abs(best - [x, y, s, s]).max() <= 4
    if h == 64:
        assert np.array_equal(
            got, TH.HaarDetector(xml, min_neighbors=3).detect_rects(gray))


def test_detectors_reject_noise(xml):
    rng = np.random.default_rng(8)
    det = TH.NativeHaarDetector(xml, min_neighbors=3)
    for _ in range(3):
        assert len(det.detect_rects(rng.integers(0, 255, (96, 96)).astype(
            np.float64))) == 0
    assert len(det.detect_rects(np.zeros((96, 96)))) == 0


def test_synthetic_cascade_is_seeded(tmp_path, xml):
    again = SC.write_cascade(str(tmp_path / "again.xml"), seed=0,
                             stages=SC.SMALL_STAGES, n_pos=300, n_neg=1500)
    other = SC.write_cascade(str(tmp_path / "other.xml"), seed=1,
                             stages=SC.SMALL_STAGES, n_pos=300, n_neg=1500)
    assert open(again).read() == open(xml).read()
    assert open(other).read() != open(xml).read()


def test_synthetic_cascade_has_alt2_shape(tmp_path):
    """The full-size fixture: 20x20 window, alt2's 20 stage sizes, every
    tree two nodes and three leaves, one feature per node, two- and
    three-rectangle features inside the window with balanced weights."""
    cas = TH.parse_cascade(SC.write_cascade(str(tmp_path / "full.xml")))
    assert (cas.window_w, cas.window_h) == (20, 20)
    assert cas.stage_count.tolist() == list(SC.ALT2_STAGES)
    n_trees = sum(SC.ALT2_STAGES)
    assert n_trees == 1047 and int(cas.stage_count[:10].sum()) == 253
    assert cas.rects.shape == (2 * n_trees, 3, 5)
    assert sorted(cas.node_feat.ravel().tolist()) == list(range(2 * n_trees))
    # one child of node 0 is node 1, the other a leaf; node 1 has two leaves
    kids = np.sort(np.stack([cas.node_left[:, 0], cas.node_right[:, 0]], 1))
    assert (kids == [0, 1]).all()
    assert (cas.node_left[:, 1] == -1).all()
    assert (cas.node_right[:, 1] == -2).all()
    assert np.isfinite(cas.node_thr).all()
    assert set(np.unique(cas.n_rects)) == {2, 3}
    assert 0.1 < (cas.n_rects == 3).mean() < 0.25
    r = cas.rects
    assert (r[:, :, 0] + r[:, :, 2]).max() <= 20
    assert (r[:, :, 1] + r[:, :, 3]).max() <= 20 and r[:, :, :4].min() >= 0
    assert np.array_equal((r[:, :, 2] * r[:, :, 3] * r[:, :, 4]).sum(1),
                          np.zeros(len(r)))
    # every stage threshold lets a clean glyph window through
    gray = SC.glyph_image(20)
    ii, ii2 = TH.integral_images(gray)
    zero = np.zeros(1, np.int64)
    assert TH._eval_stages(cas, ii, ii2, zero, zero, 1.0, 0, 20,
                           TH._scaled_rects(cas, 1.0)).all()


def test_glyph_image_scales():
    for side in (20, 57, 160):
        g = SC.glyph_image(side)
        assert g.shape == (side, side) and g.min() == 0 and g.max() <= 255
        m = max(1, side // 10 - 1)
        assert g[:m].max() == 0 and g[:, -m:].max() == 0   # black margin
        assert g[side // 2, side // 2] > 150                # bright face
