"""K2, the fused resize + normalize (gifgan_tpu_torch/kernels/resize.py),
against the JAX package's resize_normalize_ref and its Pallas kernel in
interpret mode, as tests/test_kernels.py runs them.

Tolerances: tests/test_kernels.py's own (rtol 1e-5, atol 1e-4 on the
[0, 255] scale; atol 1e-5 on [-1, 1]) — two float32 products of two taps
each, summed in another order by each framework's matmul.

The JAX package is imported inside the tests that compare with it, so the
card test at the end also runs where only PyTorch is installed:
`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_resize.py`.
"""

import numpy as np
import pytest
import torch

from gifgan_tpu_torch.kernels import resize as kresize
from gifgan_tpu_torch.kernels.resize import (MAX_THREADS, ROWS_PER_THREAD,
                                             interp_matrix, interp_taps,
                                             launch_plan, resize_normalize,
                                             resize_normalize_plain)

CASES = {
    "u8-down": ((3, 32, 32, 3), np.uint8, 16, 16),
    "u8-up-nonsquare": ((2, 12, 20, 3), np.uint8, 30, 24),
    "f32-down-nonsquare": ((2, 24, 40, 1), np.float32, 10, 16),
    "f32-up": ((1, 8, 8, 3), np.float32, 16, 16),
    "u8-odd-ratio": ((2, 25, 31, 3), np.uint8, 7, 13),
}


def _frames(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.uniform(0, 255, shape).astype(np.float32)


@pytest.mark.parametrize("n_in,n_out", [
    (8, 4), (4, 8), (7, 3), (256, 64), (5, 5), (1, 4), (360, 256),
    (480, 256), (93, 64), (121, 64), (4, 2), (7, 16), (25, 7), (6016, 8)])
def test_interp_matrix_and_taps_equal_jax(n_in, n_out):
    from gifgan_tpu.kernels.resize import interp_matrix as jinterp

    want = jinterp(n_in, n_out)
    assert np.array_equal(interp_matrix(n_in, n_out), want)
    # the kernel's tap tables are exactly the matrix's non-zeros
    idx, wt = interp_taps(n_in, n_out)
    assert idx.dtype == np.int32 and wt.dtype == np.float32
    rebuilt = np.zeros_like(want)
    for i in range(n_out):
        rebuilt[i, idx[i, 0]] += wt[i, 0]
        rebuilt[i, idx[i, 1]] += wt[i, 1]
    assert np.array_equal(rebuilt, want)


@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_resize_matches_jax_ref_and_pallas(case, normalize):
    import jax.numpy as jnp

    from gifgan_tpu.kernels.resize import (resize_normalize as jresize,
                                           resize_normalize_ref)

    shape, dtype, oh, ow = CASES[case]
    frames = _frames(shape, dtype)
    ref = np.asarray(resize_normalize_ref(jnp.asarray(frames), oh, ow,
                                          normalize=normalize))
    pallas = np.asarray(jresize(jnp.asarray(frames), oh, ow,
                                normalize=normalize, interpret=True))
    x = torch.from_numpy(frames)
    atol = 1e-5 if normalize else 1e-4
    for fn in (resize_normalize, resize_normalize_plain):
        got = fn(x, oh, ow, normalize=normalize)
        assert got.dtype == torch.float32
        assert got.shape == (shape[0], oh, ow, shape[3])
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=atol)
        np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=atol)


def test_plain_resize_constant_and_identity():
    """A constant image stays constant (rows of the matrix sum to 1), and
    equal sizes give the input back."""
    x = torch.full((1, 9, 14, 3), 200, dtype=torch.uint8)
    y = resize_normalize(x, 5, 21)
    np.testing.assert_allclose(y.numpy(), 200 / 127.5 - 1.0, atol=1e-6)
    z = torch.from_numpy(_frames((2, 6, 6, 3), np.uint8, 1))
    np.testing.assert_array_equal(
        resize_normalize(z, 6, 6, normalize=False).numpy(),
        z.numpy().astype(np.float32))


def test_plain_resize_within_one_level_of_cv2():
    """cv2.INTER_LINEAR rounds in fixed point; the float result stays
    within tests/test_kernels.py's 0.75 of a grey level of it."""
    cv2 = pytest.importorskip("cv2")
    frames = _frames((2, 40, 48, 3), np.uint8, 2)
    got = resize_normalize(torch.from_numpy(frames), 16, 20,
                           normalize=False).numpy()
    want = np.stack([cv2.resize(f, (20, 16), interpolation=cv2.INTER_LINEAR)
                     for f in frames]).astype(np.float32)
    assert np.abs(got - want).max() <= 0.75


@pytest.mark.parametrize("frames,oh,ow", [
    (torch.zeros((2, 8, 8, 3), dtype=torch.int32), 4, 4),
    (torch.zeros((2, 8, 8, 3), dtype=torch.float64), 4, 4),
    (torch.zeros((8, 8, 3), dtype=torch.uint8), 4, 4),
    (torch.zeros((2, 0, 8, 3), dtype=torch.uint8), 4, 4),
    (torch.zeros((2, 8, 8, 3), dtype=torch.uint8), 0, 4),
    (np.zeros((2, 8, 8, 3), np.uint8), 4, 4),
    (torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device="meta"), 4, 4),
], ids=["int32", "float64", "rank3", "empty-axis", "zero-out", "numpy",
        "no-kernel-device"])
def test_resize_rejects_bad_input(frames, oh, ow):
    with pytest.raises(ValueError):
        resize_normalize(frames, oh, ow)


@pytest.mark.parametrize("c,oh,ow,plan", [
    (3, 64, 64, (4, 48, 4, 192, 16)),      # the feed
    (3, 256, 256, (4, 192, 1, 192, 4)),    # data/video.py resize_u8
    (3, 100, 48, (4, 36, 4, 160, 16)),     # the float32 case of chip_smoke
    (3, 6, 5, (1, 15, 2, 32, 6)),          # ow*C = 15: one float a thread
    (3, 12, 40, (4, 30, 2, 64, 8)),        # 8 groups fit, 3 rows of 4 needed
    (1, 8, 24, (4, 6, 2, 32, 8)),
    (4, 5, 7, (4, 7, 2, 32, 5)),
    (3, 2, 2, (1, 6, 1, 32, 2)),
    (4, 2, 2, (4, 2, 1, 32, 2)),
    (3, 12, 150, (1, 450, 1, 256, 4)),     # a row wider than a block
    (3, 1, 1, (1, 3, 1, 32, 1)),
    (4, 1024, 1024, (4, 1024, 1, 256, 4)),
])
def test_launch_plan(c, oh, ow, plan):
    """The block shape the wrapper gives the kernel: whole warps within
    MAX_THREADS, a power-of-two number of row groups that all have their
    threads, float4 units only where an output row is whole float4s, and
    tiles of at most ROWS_PER_THREAD rows a thread."""
    got = launch_plan(c, oh, ow)
    assert tuple(got) == plan
    assert got.threads % 32 == 0 and got.threads <= MAX_THREADS
    assert got.vec * got.units == ow * c and (ow * c) % got.vec == 0
    assert got.groups & (got.groups - 1) == 0
    assert got.groups == 1 or got.groups * got.units <= got.threads
    assert got.rows_per_tile <= got.groups * ROWS_PER_THREAD


# (N, H, W, C), dtype, out_h, out_w: the feed's shape (one frame), W*C =
# 363, ow*C not a multiple of 4, identity, a non-integer upscale, C = 1 and
# 4, float32, tiny frames, wide rows, an output row wider than a block
EMULATED = {
    "feed": ((1, 256, 256, 3), np.uint8, 64, 64),
    "wc-363": ((1, 93, 121, 3), np.uint8, 64, 64),
    "owc-15": ((2, 9, 16, 3), np.uint8, 6, 5),
    "identity": ((2, 16, 16, 3), np.uint8, 16, 16),
    "upscale-7x16-16x20": ((1, 7, 16, 3), np.uint8, 16, 20),
    "c1": ((2, 16, 16, 1), np.uint8, 8, 24),
    "c4": ((1, 12, 16, 4), np.uint8, 5, 7),
    "f32": ((1, 30, 40, 3), np.float32, 16, 33),
    "tiny": ((3, 4, 4, 3), np.uint8, 2, 2),
    "wide-rows": ((1, 4, 6016, 4), np.uint8, 2, 8),
    "row-wider-than-block": ((2, 8, 200, 3), np.uint8, 12, 150),
}


def _emulate(frames, oh, ow, grid_y):
    """csrc/resize_normalize.cu's loops in Python, with the launch plan and
    tap tables the wrapper gives it and `grid_y` blocks along the frames
    (the kernel loops over frames past gridDim.y). Returns the raw
    (unscaled) output and how often each output value was written."""
    n, h, w, c = frames.shape
    plan = launch_plan(c, oh, ow)
    yidx, ywt = interp_taps(h, oh)
    xidx, xwt = interp_taps(w, ow)
    rows_per_tile, vec, units = plan.rows_per_tile, plan.vec, plan.units
    row_len, out_len = w * c, ow * c
    src = frames.reshape(n, h, row_len).astype(np.float64)
    out = np.zeros((n, oh, out_len), np.float64)
    writes = np.zeros(out.shape, np.int64)
    for by in range(min(n, grid_y)):
        for tile in range(-(-oh // rows_per_tile)):
            i0 = tile * rows_per_tile
            rows = min(rows_per_tile, oh - i0)
            for t in range(plan.threads):
                u0, g = t % units, t // units
                if g >= plan.groups:
                    continue
                for u in range(u0, units, plan.threads):
                    e = u * vec + np.arange(vec)
                    j, ch = e // c, e % c
                    o0, o1 = xidx[j, 0] * c + ch, xidx[j, 1] * c + ch
                    for f in range(by, n, grid_y):
                        for r in range(g, rows, plan.groups):
                            a, wy = yidx[i0 + r], ywt[i0 + r]
                            left = (wy[1] * src[f, a[1], o0]
                                    + wy[0] * src[f, a[0], o0])
                            right = (wy[1] * src[f, a[1], o1]
                                     + wy[0] * src[f, a[0], o1])
                            cols = slice(u * vec, (u + 1) * vec)
                            out[f, i0 + r, cols] = (xwt[j, 1] * right
                                                    + xwt[j, 0] * left)
                            writes[f, i0 + r, cols] += 1
    return out.reshape(n, oh, ow, c), writes


@pytest.mark.parametrize("grid_y", [65_535, 2], ids=["frames-in-grid",
                                                    "frames-looped"])
@pytest.mark.parametrize("case", sorted(EMULATED))
def test_kernel_loops_cover_every_output_once(case, grid_y):
    """The kernel's indexing, emulated on the CPU: every output value is
    written exactly once, from the right taps (against the plain version,
    at tests/test_kernels.py's [0, 255] tolerance), also where the frames
    outnumber the grid's blocks along them."""
    shape, dtype, oh, ow = EMULATED[case]
    frames = _frames(shape, dtype, 4)
    got, writes = _emulate(frames, oh, ow, grid_y)
    assert (writes == 1).all()
    want = resize_normalize_plain(torch.from_numpy(frames), oh, ow,
                                  normalize=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _offset_frames(shape, seed):
    """uint8 frames that start one byte into their storage: contiguous,
    not 16-byte aligned."""
    flat = torch.from_numpy(_frames((int(np.prod(shape)) + 1,), np.uint8,
                                    seed)).cuda()
    return flat[1:].view(shape)


# the card test's cases beyond CASES: (N, H, W, C), dtype, out_h, out_w
CARD_CASES = {
    "storage-offset": ((3, 32, 32, 3), "offset", 16, 16),
    "wc-not-16-bytes": ((4, 93, 121, 3), np.uint8, 64, 64),
    "owc-not-4": ((2, 9, 16, 3), np.uint8, 6, 5),
    "identity": ((2, 64, 64, 3), np.uint8, 64, 64),
    "upscale-non-integer": ((2, 7, 16, 3), np.uint8, 16, 20),
    "c1": ((2, 16, 16, 1), np.uint8, 8, 24),
    "c4": ((2, 12, 16, 4), np.uint8, 5, 7),
    "wide-rows": ((2, 4, 6016, 4), np.uint8, 2, 8),
    "row-wider-than-block": ((2, 8, 200, 3), np.uint8, 12, 150),
    "frames-over-65535": ((70_000, 4, 4, 3), np.uint8, 2, 2),
    "frames-over-65535-c4": ((70_000, 4, 4, 4), np.uint8, 2, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES) + sorted(CARD_CASES))
def test_kernel_matches_plain_on_card(case, monkeypatch):
    """The CUDA kernel against the plain version on the card: uint8 and
    float32, down- and upscale, non-square, identity, C = 1, 3 and 4, rows
    that are not 16-byte sized, output rows that are not whole float4s or
    wider than a block, a storage offset and more frames than gridDim.y
    holds, with and without the scale. Gate: 4 ulp of the largest value
    (two roundings per tap pair, two tap pairs), i.e. 5e-7 on [-1, 1] and
    1.3e-4 on [0, 255]. Counts one launch per call; the plain version is
    never called on a CUDA tensor; a non-contiguous input raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; the kernel has no CPU mode")
    shape, dtype, oh, ow = CASES[case] if case in CASES else CARD_CASES[case]
    x = (_offset_frames(shape, 3) if dtype == "offset"
         else torch.from_numpy(_frames(shape, dtype, 3)).cuda())

    def plain_on_cpu_only(frames, *args, **kwargs):
        assert frames.device.type == "cpu", "plain version on the card"
        return plain(frames, *args, **kwargs)

    plain = kresize.resize_normalize_plain
    monkeypatch.setattr(kresize, "resize_normalize_plain", plain_on_cpu_only)
    for normalize in (True, False):
        before = resize_normalize.launches
        got = resize_normalize(x, oh, ow, normalize=normalize)
        torch.cuda.synchronize()
        assert resize_normalize.launches == before + 1
        want = plain(x, oh, ow, normalize=normalize)
        assert got.shape == want.shape and got.dtype == torch.float32
        gate = 4 * 2.0 ** -23 * (1.0 if normalize else 256.0)
        assert float((got - want).abs().max()) <= gate, case
    with pytest.raises(ValueError):
        resize_normalize(x.permute(0, 2, 1, 3), 4, 4)
