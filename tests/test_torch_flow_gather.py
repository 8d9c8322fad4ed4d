"""The gather flow (gifgan_tpu_torch/track/flow_gather.py, the stabilizer's
`flow_backend="jax"`) against the JAX package's gifgan_tpu/track/flow_jax.py
on the same seeded images, and process_video with that backend in both
packages.

Tolerances: corners and their validity are equal (the same float32 response,
ties to the lower index); LK's new points within 1e-3 px with the same
status (float32 window sums in another order); the backend's kept points
within 1e-3 px; process_video's stabilized boxes within 1 px.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gifgan_tpu.track import flow_jax as J
from gifgan_tpu_torch.core.config import TrackConfig
from gifgan_tpu_torch.track import flow_gather as T
from gifgan_tpu_torch.track import pipeline as tpipe
from gifgan_tpu_torch.track import stabilize as TS


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    in each keeps this file's many small tensor ops from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _texture(h, w, seed):
    """Smooth seeded texture (bilinear-upsampled noise), float32."""
    rng = np.random.default_rng(seed)
    base = torch.as_tensor(rng.uniform(0, 255, (1, 1, h // 4 + 3,
                                                w // 4 + 3)))
    up = torch.nn.functional.interpolate(base, scale_factor=4,
                                         mode="bilinear",
                                         align_corners=False)
    return up[0, 0, :h, :w].numpy().astype(np.float32)


def _corners_both(img, **kw):
    jp, jv = J.shi_tomasi_corners(jnp.asarray(img), **kw)
    tp, tv = T.shi_tomasi_corners(torch.as_tensor(img), **kw)
    return (np.asarray(jp), np.asarray(jv)), (tp, tv)


@pytest.mark.parametrize("shape,kw", [
    ((90, 110), dict()),
    ((64, 64), dict(max_corners=40, quality=0.05, min_distance=5)),
])
def test_corners_equal_flow_jax(shape, kw):
    (jp, jv), (tp, tv) = _corners_both(_texture(*shape, seed=1), **kw)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert jv.sum() > 5


def test_corner_ties_go_to_the_lower_index():
    """A flat image with identical squares: equal responses everywhere the
    squares repeat, so the order is the tie order."""
    img = np.zeros((64, 80), np.float32)
    for y in (10, 30):
        for x in (12, 36, 60):
            img[y:y + 8, x:x + 8] = 200.0
    (jp, jv), (tp, tv) = _corners_both(img, max_corners=30)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tv.numpy(), jv)


@pytest.mark.parametrize("shift,size", [((1.5, -2.25), (96, 112)),
                                        ((-3.0, 4.0), (40, 52))])
def test_lk_flow_within_1e_3_px(shift, size):
    """Shifted textures; the small size runs one pyramid level and puts
    windows over the image edge (the edge-clamped extrapolation)."""
    h, w = size
    big = _texture(h + 16, w + 16, seed=3)
    dx, dy = shift
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    a = big[8:8 + h, 8:8 + w]
    b = torch.nn.functional.grid_sample(
        torch.as_tensor(big)[None, None],
        torch.as_tensor(np.stack([(xs + 8 - dx) / (w + 15) * 2 - 1,
                                  (ys + 8 - dy) / (h + 15) * 2 - 1],
                                 -1))[None],
        align_corners=True)[0, 0].numpy()
    (jp, jv), (tp, tv) = _corners_both(a)
    # points at and past the edges too
    extra = np.array([[0, 0], [w - 1, h - 1], [1.5, h / 2], [w - 0.5, 3]],
                     np.float32)
    jp = np.concatenate([jp, extra])
    jv = np.concatenate([jv, np.ones(4, bool)])
    jn, js = J.lk_flow(jnp.asarray(a), jnp.asarray(b), jnp.asarray(jp),
                       jnp.asarray(jv))
    tn, ts = T.lk_flow(torch.as_tensor(a), torch.as_tensor(b),
                       torch.as_tensor(jp), torch.as_tensor(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0,
                               atol=1e-3)
    flow = (tn.numpy() - jp)[ts.numpy()]
    assert ts.numpy().sum() >= 10
    np.testing.assert_allclose(np.median(flow, axis=0), shift, atol=0.1)


@pytest.mark.parametrize("prev,cur", [((37, 53), (37, 53)),
                                      ((45, 61), (50, 55)),
                                      ((61, 47), (58, 44))])
def test_backend_equals_jax_flow_backend(prev, cur):
    """Odd sizes, unpadded: the previous crop padded to multiples of 16,
    the current one padded or clipped to it, corners in the padding
    dropped."""
    big = _texture(80, 80, seed=4)
    a = big[:prev[0], :prev[1]]
    b = big[1:1 + cur[0], 2:2 + cur[1]]
    jp0, jp1, jn = J.jax_flow_backend(a, b)
    tp0, tp1, tn = T.gather_flow_backend(a, b, device="cpu")
    assert tn == jn > 0
    np.testing.assert_array_equal(tp0, jp0)
    np.testing.assert_allclose(tp1, jp1, rtol=0, atol=1e-3)
    assert len(tp0) >= 5
    empty = T.gather_flow_backend(a[:8], b, device="cpu")
    assert empty[0].shape == (0, 2) and empty[2] == 0


def test_process_video_with_the_jax_backend_in_both_packages(monkeypatch):
    """The stabilizer with flow_backend="jax" in both packages, one injected
    detector: the same stabilized boxes within 1 px, the same counters."""
    from gifgan_tpu.core.config import TrackConfig as JTrackConfig
    from gifgan_tpu.track import boxes as JB
    from gifgan_tpu.track import pipeline as jpipe
    from gifgan_tpu.track import stabilize as JS
    from gifgan_tpu.track.stats import TrackStats as JStats
    from gifgan_tpu_torch.track import boxes as TB
    from gifgan_tpu_torch.track.stats import TrackStats

    T_, H, W = 24, 96, 128
    tex = _texture(40, 40, seed=5).clip(0, 255).astype(np.uint8)
    frames = np.zeros((T_, H, W, 3), np.uint8)
    boxes = []
    for t in range(T_):
        x, y = 20 + t, 30 + t // 3
        frames[t, y:y + 40, x:x + 40] = tex[..., None]
        boxes.append((x, y, 40, 40))

    def detector(Detection):
        def det(frame, i):
            if i % 4:
                return []
            x, y, w, h = boxes[i]
            return [Detection(x, y, x + w, y + h, i)]
        return det

    seen = {}
    for name, mod in (("jax", JS), ("port", TS)):
        real = mod.stabilize_tracks

        def spy(*a, _real=real, _name=name, **kw):
            seen[_name] = _real(*a, **kw)
            return seen[_name]

        monkeypatch.setattr(mod, "stabilize_tracks", spy)
    cfg = dict(min_frame_count=10, min_total_detections=3, target_size=32,
               max_corners=50, flow_backend="jax")
    jstats, tstats = JStats(), TrackStats()
    want = jpipe.process_video(frames, detector(JB.Detection),
                               JTrackConfig(**cfg), jstats)
    got = tpipe.process_video(frames, detector(TB.Detection),
                              TrackConfig(**cfg), tstats, device="cpu")
    assert len(got) == len(want) == 1
    assert got[0].shape == want[0].shape
    assert tstats.counters == jstats.counters
    (jt,), (tt,) = seen["jax"], seen["port"]
    jb = np.array([[d.x1, d.y1, d.x2, d.y2] for d in jt])
    tb = np.array([[d.x1, d.y1, d.x2, d.y2] for d in tt])
    assert jb.shape == tb.shape and len(jb) >= 10
    assert np.abs(jb - tb).max() <= 1
