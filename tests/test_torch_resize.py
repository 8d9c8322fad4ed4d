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

from gifgan_tpu_torch.kernels.resize import (interp_matrix, interp_taps,
                                             resize_normalize,
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


@pytest.mark.parametrize("n_in,n_out", [(8, 4), (4, 8), (7, 3), (256, 64),
                                        (5, 5), (1, 4)])
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


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against the plain version on the card: uint8 and
    float32, down- and upscale, non-square, C = 1 and 3, with and without
    the scale. Gate: 4 ulp of the largest value (two roundings per tap pair,
    two tap pairs), i.e. 5e-7 on [-1, 1] and 1.3e-4 on [0, 255]. Counts one
    launch per call; a non-contiguous input raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; the kernel has no CPU mode")
    for case in sorted(CASES):
        shape, dtype, oh, ow = CASES[case]
        x = torch.from_numpy(_frames(shape, dtype, 3)).cuda()
        for normalize in (True, False):
            before = resize_normalize.launches
            got = resize_normalize(x, oh, ow, normalize=normalize)
            torch.cuda.synchronize()
            assert resize_normalize.launches == before + 1
            want = resize_normalize_plain(x, oh, ow, normalize=normalize)
            assert got.shape == want.shape and got.dtype == torch.float32
            gate = 4 * 2.0 ** -23 * (1.0 if normalize else 256.0)
            assert float((got - want).abs().max()) <= gate, case
    with pytest.raises(ValueError):
        resize_normalize(x.permute(0, 2, 1, 3), 4, 4)
