"""The port's corner + LK flow kernels (gifgan_tpu_torch/kernels/flow.py)
and K4, the LK refinement (kernels/flow_refine.py), against the JAX package
(gifgan_tpu/kernels/flow.py, flow_pallas.py in interpret mode) on the same
numpy inputs. One shape bucket (96x96 images, 64x64 for the corner sets,
K <= 40) keeps the number of programs JAX compiles small.

Tolerances, in pixels unless said: window samples rtol 1e-5 / atol 1e-3
(grey levels, tests/test_kernels_flow.py's own); refined flow 5e-3 against
the Pallas kernel and tracked points 0.05 against lk_flow_batch (ten
dependent float32 steps whose window sums each framework adds in another
order; the JAX test itself allows 0.35 between its two paths); known
shifts 0.5.

The JAX package is imported inside the tests that compare with it, so the
card test at the end also runs where only PyTorch is installed:
`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_flow.py`.
"""

import numpy as np
import pytest
import torch

from gifgan_tpu_torch.kernels import flow as tflow
from gifgan_tpu_torch.kernels.flow_refine import (bilinear_windows, lk_refine,
                                                  lk_refine_plain)


def _smooth(img):
    """5x5 box blur with zero SAME padding, in numpy (both packages get the
    same image)."""
    p = np.pad(img.astype(np.float64), 2)
    out = sum(p[i:i + img.shape[0], j:j + img.shape[1]]
              for i in range(5) for j in range(5)) / 25.0
    return out.astype(np.float32)


def _pairs(n, size, shifts, seed):
    rng = np.random.default_rng(seed)
    img0s = np.stack([_smooth(rng.uniform(0, 255, (size, size)))
                      for _ in range(n)])
    img1s = np.stack([np.roll(np.roll(i, dy, axis=0), dx, axis=1)
                      for i, (dx, dy) in zip(img0s, shifts)])
    return img0s, img1s


def _refine_inputs(seed=4, b=2, k=24, size=96, win=15):
    """img1 and the per-corner arrays lk_refine takes, built once in numpy /
    the port and handed to both packages."""
    img0s, img1s = _pairs(b, size, [(2, -1), (-1, 2)][:b], seed)
    rng = np.random.default_rng(seed + 1)
    pts = rng.uniform(2, size - 3, (b, k, 2)).astype(np.float32)
    pts[0, 0] = (0.0, 0.0)                      # clamped window bases
    pts[0, 1] = (size - 1.0, size - 1.0)
    i0 = torch.from_numpy(img0s)
    tp = torch.from_numpy(pts)
    t0 = bilinear_windows(i0, tp, win)
    gxw, gyw, a11, a12, a22, det = tflow._lk_system(i0, tp, win)
    amat = torch.stack([a11, a12, a22, det], dim=-1)
    amat[-1, 0, 3] = 0.0                        # a degenerate corner
    flow0 = rng.uniform(-0.5, 0.5, (b, k, 2)).astype(np.float32)
    return (torch.from_numpy(img1s), t0, gxw, gyw, amat, tp,
            torch.from_numpy(flow0))


def test_sample_windows_matches_jax():
    """Interior points and points whose window leaves the frame (the clamp
    of base and fraction), single image and stack."""
    import jax.numpy as jnp

    from gifgan_tpu.kernels import flow as jflow

    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, (2, 64, 80)).astype(np.float32)
    pts = rng.uniform(-3, 82, (2, 17, 2)).astype(np.float32)
    pts[:, :8] = rng.uniform(12, 50, (2, 8, 2))
    for win in (9, 15):
        want = np.stack([np.asarray(jflow.sample_windows(
            jnp.asarray(imgs[i]), jnp.asarray(pts[i]), win))
            for i in range(2)])
        got = tflow.sample_windows(torch.from_numpy(imgs),
                                   torch.from_numpy(pts), win)
        assert got.shape == (2, 17, win, win)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
        one = tflow.sample_windows(torch.from_numpy(imgs[1]),
                                   torch.from_numpy(pts[1]), win)
        np.testing.assert_allclose(one.numpy(), want[1], rtol=1e-5,
                                   atol=1e-3)


def test_corner_sets_equal_jax():
    import jax.numpy as jnp

    from gifgan_tpu.kernels import flow as jflow

    rng = np.random.default_rng(1)
    imgs = np.stack([_smooth(rng.uniform(0, 255, (64, 64)))
                     for _ in range(3)])
    jp, jv = jflow.shi_tomasi_corners_batch(jnp.asarray(imgs),
                                            max_corners=32, min_distance=6)
    jp, jv = np.asarray(jp), np.asarray(jv)
    tp, tv = tflow.shi_tomasi_corners_batch(torch.from_numpy(imgs),
                                            max_corners=32, min_distance=6)
    assert tp.shape == (3, 32, 2) and tv.shape == (3, 32)
    assert tp.dtype == torch.float32 and tv.dtype == torch.bool
    tp, tv = tp.numpy(), tv.numpy()
    for i in range(3):
        assert tv[i].sum() == jv[i].sum() > 5
        assert set(map(tuple, tp[i][tv[i]])) == set(map(tuple, jp[i][jv[i]]))


def test_corner_ties_break_towards_lower_index():
    """Equal responses (a periodic texture) fill the corner slots in index
    order, as lax.top_k orders them."""
    import jax.numpy as jnp

    from gifgan_tpu.kernels import flow as jflow

    img = np.zeros((1, 64, 64), np.float32)
    img[0, 8:56, 8:56] = 200.0
    img[0, 8:56:4, 8:56] = 90.0
    img[0, 8:56, 8:56:5] = 140.0
    jp, jv = jflow.shi_tomasi_corners_batch(jnp.asarray(img), max_corners=10,
                                            min_distance=8)
    tp, tv = tflow.shi_tomasi_corners_batch(torch.from_numpy(img),
                                            max_corners=10, min_distance=8)
    assert tv.numpy().sum() == np.asarray(jv).sum()
    np.testing.assert_array_equal(tp.numpy()[tv.numpy()],
                                  np.asarray(jp)[np.asarray(jv)])


def test_lk_refine_plain_matches_pallas_interpret():
    import jax.numpy as jnp

    from gifgan_tpu.kernels.flow_pallas import lk_refine as jrefine

    img1, t0, gx, gy, amat, pts, flow0 = _refine_inputs()
    got = lk_refine(img1, t0, gx, gy, amat, pts, flow0, win=15, iters=10)
    assert got.shape == (2, 24, 2) and got.dtype == torch.float32
    assert torch.equal(got, lk_refine_plain(img1, t0, gx, gy, amat, pts,
                                            flow0, 15, 10))
    for b in range(2):
        want = np.asarray(jrefine(
            *(jnp.asarray(a[b].numpy()) for a in (img1, t0, gx, gy, amat,
                                                  pts, flow0)),
            win=15, iters=10, interpret=True))
        np.testing.assert_allclose(got[b].numpy(), want, atol=5e-3)
    # the degenerate corner keeps its flow
    assert torch.equal(got[1, 0], flow0[1, 0])
    # no steps: the flow comes back unchanged
    assert torch.equal(lk_refine(img1, t0, gx, gy, amat, pts, flow0, 15, 0),
                       flow0)


@pytest.mark.parametrize("pallas_refine", ["off", "interpret"])
def test_lk_flow_batch_matches_jax(pallas_refine):
    import jax.numpy as jnp

    from gifgan_tpu.kernels import flow as jflow

    shifts = [(3, -2), (-1, 4)]
    img0s, img1s = _pairs(2, 96, shifts, 4)
    pts, valid = tflow.shi_tomasi_corners_batch(torch.from_numpy(img0s),
                                                max_corners=40,
                                                min_distance=6)
    want_pts, want_st = jflow.lk_flow_batch(
        jnp.asarray(img0s), jnp.asarray(img1s), jnp.asarray(pts.numpy()),
        jnp.asarray(valid.numpy()), win=15, levels=2,
        pallas_refine=pallas_refine)
    got_pts, got_st = tflow.lk_flow_batch(
        torch.from_numpy(img0s), torch.from_numpy(img1s), pts, valid,
        win=15, levels=2)
    want_st = np.asarray(want_st)
    np.testing.assert_array_equal(got_st.numpy(), want_st)
    assert want_st.sum() > 20
    np.testing.assert_allclose(got_pts.numpy()[want_st],
                               np.asarray(want_pts)[want_st], atol=0.05)
    flow = (got_pts - pts).numpy()
    for i, shift in enumerate(shifts):
        np.testing.assert_allclose(np.median(flow[i][want_st[i]], axis=0),
                                   shift, atol=0.5)


def test_lk_batch_recovers_translations_three_levels():
    shifts = [(3, -2), (-1, 4), (2, 2)]
    img0s, img1s = _pairs(3, 96, shifts, 2)
    i0, i1 = torch.from_numpy(img0s), torch.from_numpy(img1s)
    pts, valid = tflow.shi_tomasi_corners_batch(i0, max_corners=40,
                                                min_distance=6)
    new_pts, status = tflow.lk_flow_batch(i0, i1, pts, valid, win=15,
                                          levels=3)
    flow = (new_pts - pts).numpy()
    for i, shift in enumerate(shifts):
        f = flow[i][status[i].numpy()]
        assert len(f) > 5
        np.testing.assert_allclose(np.median(f, axis=0), shift, atol=0.5)


@pytest.mark.parametrize("shape,win,levels,want", [
    ((96, 96), 15, 3, 3), ((96, 96), 15, 2, 2), ((32, 64), 15, 3, 2),
    ((224, 224), 15, 3, 3), ((20, 20), 15, 3, 1), ((64, 64), 15, 1, 1)])
def test_pyramid_levels(shape, win, levels, want):
    assert tflow.pyramid_levels(*shape, win, levels) == want


def test_flow_pairs_batched_matches_per_pair_and_jax():
    from gifgan_tpu.kernels import flow as jflow

    img0s, img1s = _pairs(3, 96, [(1, 0)] * 3, 3)
    pts_b, new_b, st_b, n_b = tflow.flow_pairs(img0s, img1s, max_corners=30,
                                               device="cpu")
    assert pts_b.shape == (3, 30, 2) and st_b.dtype == np.bool_
    for i in range(3):
        pts_s, new_s, st_s, n_s = tflow.flow_pairs(
            img0s[i:i + 1], img1s[i:i + 1], max_corners=30, device="cpu")
        np.testing.assert_allclose(pts_b[i], pts_s[0], atol=1e-4)
        np.testing.assert_array_equal(st_b[i], st_s[0])
        np.testing.assert_allclose(new_b[i][st_b[i]], new_s[0][st_s[0]],
                                   atol=1e-3)
        assert n_b[i] == n_s[0]
    jp, jn, js, jc = jflow.flow_pairs(img0s, img1s, max_corners=30)
    np.testing.assert_array_equal(n_b, jc)
    np.testing.assert_array_equal(st_b, js)
    np.testing.assert_allclose(new_b[st_b], jn[js], atol=0.05)


def test_mxu_flow_backend_matches_jax():
    """The stabilizer's single-pair entry: crops of unequal, non-bucket
    sizes are padded alike and give the same tracked pairs."""
    from gifgan_tpu.kernels import flow as jflow

    img0s, img1s = _pairs(1, 96, [(2, 1)], 5)
    a = img0s[0][:70, :83].astype(np.uint8)
    b = img1s[0][:70, :83].astype(np.uint8)
    kw = dict(max_corners=30, win_size=15, max_level=2)
    p0, p1, n = tflow.mxu_flow_backend(a, b, device="cpu", **kw)
    j0, j1, jn = jflow.mxu_flow_backend(a, b, **kw)
    assert n == jn and len(p0) == len(j0) > 5
    np.testing.assert_allclose(p0, j0, atol=1e-4)
    np.testing.assert_allclose(p1, j1, atol=0.05)
    tiny = np.zeros((8, 8), np.uint8)
    assert tflow.mxu_flow_backend(tiny, tiny, device="cpu")[2] == 0


def _bad_refine_args():
    good = list(_refine_inputs(b=1, k=3, size=32))
    cases = {}
    for name, pos, bad in [
            ("img1-rank", 0, good[0][0]),
            ("t0-shape", 1, good[1][:, :, :14]),
            ("gx-shape", 2, good[2][:, :2]),
            ("amat-shape", 4, good[4][..., :3]),
            ("pts-dtype", 5, good[5].double()),
            ("flow-shape", 6, good[6][:, :2]),
            ("device", 3, good[3].to("meta"))]:
        args = list(good)
        args[pos] = bad
        cases[name] = (args, 15)
    cases["win-too-large"] = (good, 33)
    cases["image-too-small"] = ([good[0][:, :12]] + good[1:], 15)
    return cases


@pytest.mark.parametrize("name", ["img1-rank", "t0-shape", "gx-shape",
                                  "amat-shape", "pts-dtype", "flow-shape",
                                  "device", "win-too-large",
                                  "image-too-small"])
def test_lk_refine_rejects_bad_input(name):
    args, win = _bad_refine_args()[name]
    with pytest.raises(ValueError):
        lk_refine(*args, win=win, iters=2)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against the plain version on the card, with clamped
    windows, a degenerate corner, a strided img1 and win = 15 and 21 (more
    than one element per thread). Gate 1e-2 px: the block's tree reduction
    and the plain version's sum add 225 (441) products in another order,
    and ten steps feed that difference back through the solve. Counts one
    launch per call for all pairs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; the kernel has no CPU mode")
    for win in (15, 21):
        args = [a.cuda() for a in _refine_inputs(win=win)]
        before = lk_refine.launches
        got = lk_refine(*args, win=win, iters=10)
        torch.cuda.synchronize()
        assert lk_refine.launches == before + 1
        want = lk_refine_plain(*args, win, 10)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert float((got - want).abs().max()) <= 1e-2
        wide = torch.zeros((2, 96, 192), device="cuda")
        wide[:, :, ::2] = args[0]
        strided = lk_refine(wide[:, :, ::2], *args[1:], win=win, iters=10)
        assert torch.equal(strided, got)
    with pytest.raises(ValueError):
        lk_refine(args[0], args[1].transpose(2, 3), *args[2:], win=21,
                  iters=1)
