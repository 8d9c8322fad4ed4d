"""The port's detector backends and face ranking
(gifgan_tpu_torch/track/detect.py) against gifgan_tpu/track/detect.py.

Ranking and similarity are float32 convolutions in both packages: rtol 1e-5
(the frameworks sum the 9 or 64 taps in another order). Backend selection is
a table of cases; it differs from the JAX package by design: "auto" with a
cascade is the device detector, "auto" without one raises, and nothing
degrades to a host backend.
"""

import numpy as np
import pytest
import torch

from gifgan_tpu_torch.track import detect as TDet
from gifgan_tpu_torch.track import synthetic_cascade as SC
from gifgan_tpu_torch.track.boxes import Detection
from gifgan_tpu_torch.track.haar import HaarDetector, NativeHaarDetector
from gifgan_tpu_torch.track.haar_device import DeviceHaarDetector


@pytest.fixture(scope="module")
def xml(tmp_path_factory):
    return SC.write_cascade(
        str(tmp_path_factory.mktemp("cascade") / "small.xml"), seed=0,
        stages=SC.SMALL_STAGES, n_pos=300, n_neg=1500)


def _images(seed, n=4, size=24, channels=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (n, size, size, channels)).astype(np.float32)


def test_to_gray_and_sharpness_match_jax():
    import jax.numpy as jnp

    from gifgan_tpu.track import detect as JDet

    x = _images(0)
    np.testing.assert_allclose(
        TDet._to_gray(torch.from_numpy(x)).numpy(),
        np.asarray(JDet._to_gray(jnp.asarray(x))), rtol=1e-5)
    one = _images(1, channels=1)
    assert TDet._to_gray(torch.from_numpy(one)).shape == (4, 24, 24)
    for imgs in (x, one, x[..., 0]):
        np.testing.assert_allclose(
            TDet.sharpness(torch.from_numpy(imgs)).numpy(),
            np.asarray(JDet.sharpness(jnp.asarray(imgs))), rtol=1e-5)


def test_rank_faces_matches_jax():
    import jax.numpy as jnp

    from gifgan_tpu.track import detect as JDet

    x = _images(2)
    x[1] = 128.0                                  # a flat crop ranks last
    boxes = np.array([[10, 10, 40, 42], [50, 20, 90, 70], [0, 0, 20, 20],
                      [60, 60, 100, 100]])
    want = JDet.rank_faces(jnp.asarray(x), boxes, (120, 160))
    got = TDet.rank_faces(torch.from_numpy(x), boxes, (120, 160))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got.shape == (4,) and np.argmin(got[:2]) == 1


def test_mssim_matches_jax():
    import jax.numpy as jnp

    from gifgan_tpu.track import detect as JDet

    a, b = _images(3), _images(4)
    b[0] = a[0]
    want = np.asarray(JDet.mssim(jnp.asarray(a), jnp.asarray(b)))
    got = TDet.mssim(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert abs(got[0] - 1.0) < 1e-5 and got[1] < 0.5


def test_callable_detector_and_cascade_search():
    from gifgan_tpu.track import detect as JDet

    det = TDet.CallableDetector(lambda frame, n: [(1, 2, 10, 12)] * (n % 2))
    assert det(None, 0) == []
    assert det(None, 3) == [Detection(1, 2, 11, 14, 3)]
    assert TDet.find_default_cascade() == JDet.find_default_cascade()
    assert TDet._CASCADE_SEARCH == JDet._CASCADE_SEARCH
    assert TDet.AUTO_DETECT_BATCH == JDet.AUTO_DETECT_BATCH == 8


@pytest.mark.parametrize("kwargs,want", [
    (dict(device_available=True), ("device", 8)),
    (dict(device_available=True, detect_batch_clips=0), ("device", 8)),
    (dict(device_available=True, detect_batch_clips=1), ("device", 8)),
    (dict(device_available=True, detect_batch_clips=2), ("device", 2)),
    (dict(device_available=True, detect_batch_clips=3), ("device", 3)),
    (dict(device_available=True, detect_batch_clips=16), ("device", 16)),
    (dict(device_available=False), RuntimeError),
    (dict(device_available=False, detect_batch_clips=4), RuntimeError),
])
def test_select_detector_backend(kwargs, want):
    if isinstance(want, tuple):
        assert TDet.select_detector_backend(**kwargs) == want
    else:
        with pytest.raises(want, match="CUDA"):
            TDet.select_detector_backend(**kwargs)


@pytest.mark.parametrize("backend,device,cascade,want", [
    ("auto", "cpu", True, DeviceHaarDetector),
    ("device", "cpu", True, DeviceHaarDetector),
    ("native", None, True, NativeHaarDetector),
    ("python", None, True, HaarDetector),
    ("auto", None, True, "CUDA"),            # no card and nobody said cpu
    ("device", None, True, "CUDA"),
    ("auto", "cpu", False, "needs a cascade file"),   # never OpenCV unasked
    ("auto", None, False, "CUDA"),           # the card is asked for first
    ("device", "cpu", False, "needs a cascade file"),
    ("native", None, False, "needs a cascade file"),
    ("python", "cpu", False, "needs a cascade file"),
    ("opencv", "cpu", True, "unknown detector backend"),
])
def test_default_detector(monkeypatch, xml, backend, device, cascade, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = dict(cascade_path=xml if cascade else None, scale_factor=1.2,
                min_neighbors=4, backend=backend, device=device)
    if isinstance(want, str):
        with pytest.raises((RuntimeError, ValueError), match=want):
            TDet.default_detector(**args)
        return
    det = TDet.default_detector(**args)
    assert type(det) is want
    assert (det.scale_factor, det.min_neighbors, det.min_size) == (1.2, 4, 20)
    if want is DeviceHaarDetector:
        assert det.device == torch.device("cpu") and det.early_stages == 8


@pytest.mark.parametrize("cascade", [True, False])
def test_cv2_backend_is_taken_by_name_only(monkeypatch, xml, cascade):
    """"cv2" means OpenCV's classifier, with or without a cascade file: it
    is built where the cv2 build has objdetect and raises where it has not,
    and it never turns into another backend. No other name reaches it."""
    built = []
    monkeypatch.setattr(TDet, "CV2HaarDetector",
                        lambda *a: built.append(a) or "cv2-detector")
    assert TDet.default_detector(xml if cascade else None, 1.3, 2,
                                 backend="cv2") == "cv2-detector"
    assert built == [(xml if cascade else None, 1.3, 2, 20, 1.0)]
    with pytest.raises(ValueError, match="needs a cascade file"):
        TDet.default_detector(None, backend="auto", device="cpu")
    assert len(built) == 1
    monkeypatch.undo()
    try:
        import cv2
        have = hasattr(cv2, "CascadeClassifier")
    except ImportError:
        have = False
    if not have:
        with pytest.raises(RuntimeError, match="objdetect"):
            TDet.default_detector(None, backend="cv2")
