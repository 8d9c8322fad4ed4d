"""The leaky ReLU's one pass each way (gifgan_tpu_torch/kernels/lrelu.py):
its plain versions against autograd through the expression it replaces,
torch.maximum(x, 0.2 * x), bit for bit (the sign of a zero too; NaN where
NaN); its gradient at 0 against the JAX package's jax.vjp; ops/nn.py
lrelu on a CPU tensor as before; and, on the card, the kernels against
the plain versions and the expression at the shapes the image D tap
runs.

The JAX package is imported inside the test that compares with it, so the
card tests also run where only PyTorch is installed:
`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_lrelu.py`.
"""

import numpy as np
import pytest
import torch

from gifgan_tpu_torch.core import profile
from gifgan_tpu_torch.kernels import lrelu as K
from gifgan_tpu_torch.ops import nn

DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
INT = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
       torch.float16: torch.int16, torch.float64: torch.int64}


def same_bits(a, b):
    """Equal bit for bit, NaN where NaN (its payload aside)."""
    nan = torch.isnan(a)
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(nan, torch.isnan(b))
            and torch.equal(a.view(INT[a.dtype])[~nan],
                            b.view(INT[b.dtype])[~nan]))


def specials(dtype):
    """+-0, +-tiny where 0.2 x underflows to a zero (the least subnormal)
    and where it does not (the least normal), +-inf, NaN."""
    fi = torch.finfo(dtype)
    least = torch.tensor(0, dtype=INT[dtype]).add(1).view(dtype).item()
    vals = [0.0, -0.0, least, -least, fi.tiny, -fi.tiny, float("inf"),
            -float("inf"), float("nan"), 1.0, -1.0]
    return torch.tensor(vals, dtype=torch.float64).to(dtype)


def inputs(dtype, n=4096, seed=0, device="cpu"):
    """x: the specials, then a normal draw; g: a normal draw with +-0s and
    the specials of the gradient (+-inf, NaN) in places."""
    gen = torch.Generator().manual_seed(seed)
    s = specials(dtype)
    x = torch.cat([s, torch.randn(n, generator=gen, dtype=torch.float64)
                   .to(dtype)])
    g = torch.randn(x.shape, generator=gen, dtype=torch.float64).to(dtype)
    g[::7], g[3::11] = -0.0, 0.0
    g[-3:] = torch.tensor([float("inf"), -float("inf"), float("nan")])
    return x.to(device), g.to(device)


def expression(x, g):
    """y and dx of torch.maximum(x, 0.2 * x) through autograd."""
    xr = x.detach().clone().requires_grad_()
    y = torch.maximum(xr, 0.2 * xr)
    y.backward(g)
    return y.detach(), xr.grad


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_versions_are_the_expression(dtype):
    """Both passes, every value and gradient of `inputs`, bit for bit."""
    x, g = inputs(dtype)
    y, dx = expression(x, g)
    assert same_bits(K.lrelu_plain(x), y)
    assert same_bits(K.lrelu_backward_plain(x, g), dx)


def test_gradient_at_zero_is_the_jax_tie_rule():
    """At x = 0 the two sides of the maximum tie, and jnp.maximum's
    gradient sends half of g each way: 0.5 g + 0.2 * 0.5 g = 0.6 g."""
    import jax
    import jax.numpy as jnp

    from gifgan_tpu.ops import nn as jnn

    x = np.zeros(6, np.float32)
    g = np.array([1.0, -2.5, 0.125, 3e-3, -7.0, 1e4], np.float32)
    _, vjp = jax.vjp(jnn.lrelu, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = K.lrelu_backward_plain(torch.from_numpy(x),
                                 torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(want, 0.6 * g, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_nn_lrelu_on_cpu_takes_the_expression():
    """No kernel, no span, the expression's numbers, inside a recording
    profiler session with a step span open (where a CUDA call would be
    recorded)."""
    x, _ = inputs(torch.float32, n=64)
    before = K.lrelu.launches
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with profile.span("vid.step"):
            y = nn.lrelu(x)
        spans = profile.span_summary()["spans"]
    assert "vid.step" in spans and "nn.lrelu" not in spans
    assert K.lrelu.launches == before
    assert same_bits(y, torch.maximum(x, 0.2 * x))


def test_dense_and_same_layout():
    """What runs flat over its storage on the card, and which gradients
    walk it as x does."""
    base = torch.zeros(4, 5, 6, 7)
    perm = base.permute(0, 2, 3, 1)
    assert K.dense(base) and K.dense(perm)
    assert K.dense(base[1:])                        # a storage offset
    assert K.dense(torch.zeros(3, 1, 5).transpose(0, 1))
    assert K.dense(torch.zeros(5, 1)[:, :1].as_strided((5, 1), (1, 99)))
    assert not K.dense(base[:, :, :, 1:])
    assert not K.dense(base[:, ::2])
    assert not K.dense(torch.zeros(5, 1).expand(5, 3))
    assert not K.dense(torch.zeros(6).as_strided((2, 3), (1, 1)))
    assert K.same_layout(perm, torch.ones(4, 5, 6, 7).permute(0, 2, 3, 1))
    assert K.same_layout(torch.zeros(3, 1, 5), torch.zeros(15).as_strided(
        (3, 1, 5), (5, 99, 1)))
    assert not K.same_layout(perm, perm.contiguous())
    assert not K.same_layout(base, base.double())
    assert not K.same_layout(torch.zeros(5, 3),
                             torch.zeros(1, 3).expand(5, 3))


@pytest.mark.parametrize("x", [torch.zeros(4, dtype=torch.int32),
                               torch.zeros(4, device="meta"),
                               torch.zeros(4)],
                         ids=["int32", "meta", "cpu"])
def test_lrelu_kernel_rejects(x):
    """The kernels' entry takes float CUDA tensors only: ops/nn.py lrelu
    keeps the expression for every other tensor."""
    with pytest.raises(ValueError):
        K.lrelu(x)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

TAP = {"h0": (4096, 32, 32, 64), "h1": (4096, 16, 16, 128),
       "h2": (4096, 8, 8, 256)}


def _case(name, dtype, gen):
    """(x, g) on the card: x laid out as the case says, its first row
    along the last dim starting with the specials; g a draw of x's shape,
    in x's layout or another as the case says."""
    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    if name in TAP:
        x, g = draw(*TAP[name]), draw(*TAP[name])
    elif name == "odd":
        x, g = draw(7, 13, 1001), draw(7, 13, 1001)
    elif name == "offset":                      # not 16-byte aligned
        x, g = draw(100_003)[1:], draw(100_005)[3:]
    elif name == "permuted":                    # the vid-D's conv3d output
        x = draw(3, 24, 4, 9, 9).permute(0, 2, 3, 4, 1)
        g = draw(3, 24, 4, 9, 9).permute(0, 2, 3, 4, 1)
    elif name == "permuted_grad_contiguous":
        x = draw(3, 24, 4, 9, 9).permute(0, 2, 3, 4, 1)
        g = draw(3, 4, 9, 9, 24)
    elif name == "slice":                       # not dense
        x, g = draw(65, 130)[:, 1:127], draw(65, 126)
    else:                                       # "expanded_grad"
        x, g = draw(64, 33), draw(1, 33).expand(64, 33)
    s = specials(dtype)
    x[(0,) * (x.ndim - 1)][: s.numel()] = s.cuda()
    return x, g


CASES = [*TAP, "odd", "offset", "permuted", "permuted_grad_contiguous",
         "slice", "expanded_grad"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_is_the_plain_version_and_the_expression(card, dtype, case):
    """Forward and backward, bit for bit, against the plain versions and
    against autograd through torch.maximum on the card (the path the
    kernels replace)."""
    gen = torch.Generator(device="cuda").manual_seed(CASES.index(case))
    x, g = _case(case, dtype, gen)
    xr = x.detach().requires_grad_()
    y = K.lrelu(xr, 0.2)
    y.backward(g)
    torch.cuda.synchronize()
    assert same_bits(y.detach(), K.lrelu_plain(x))
    assert same_bits(xr.grad, K.lrelu_backward_plain(x, g))
    want_y, want_dx = expression(x, g)
    assert same_bits(y.detach(), want_y) and same_bits(xr.grad, want_dx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_on_specials(card, dtype):
    """Every special value and gradient of `inputs`, with the vectors'
    head and tail: the same tensors at a shared storage offset, so that
    the kernel's scalar head runs before its vectors."""
    x, g = inputs(dtype, n=1000, device="cuda")
    xr = x.clone().requires_grad_()
    y = K.lrelu(xr)
    y.backward(g)
    want_y, want_dx = expression(x, g)
    assert same_bits(y.detach(), want_y) and same_bits(xr.grad, want_dx)
    fwd, bwd = K._kernels()
    for off in (1, 3):
        xs, gs = x[off:], g[off:]
        ys, dxs = (torch.empty(x.numel(), dtype=dtype, device="cuda")[off:]
                   for _ in range(2))
        K._launch(fwd, 0.2, xs, ys)
        K._launch(bwd, 0.2, xs, gs, dxs)
        assert same_bits(ys, want_y[off:]) and same_bits(dxs, want_dx[off:])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["permuted", "slice", "offset"])
def test_kernel_without_autograd(card, case):
    """Where autograd records nothing (no_grad, or an x that needs no
    gradient) the forward launches without the Function: the same bits,
    x's strides where x is dense, one launch."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    x, _ = _case(case, torch.bfloat16, gen)
    want = K.lrelu_plain(x)
    before = K.lrelu.launches
    with torch.no_grad():
        y = K.lrelu(x.detach().requires_grad_())
    y2 = K.lrelu(x.detach())
    assert K.lrelu.launches == before + 2
    assert same_bits(y, want) and same_bits(y2, want)
    assert not y.requires_grad and not y2.requires_grad
    if K.dense(x):
        assert y.stride() == x.stride() and y2.stride() == x.stride()


@pytest.mark.cuda
def test_launches_count_one_pass_each_way(card):
    x = torch.randn(4096, 8, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    before = K.lrelu.launches
    y = nn.lrelu(x)
    assert K.lrelu.launches == before + 1
    y.backward(torch.ones_like(y))
    assert K.lrelu.launches == before + 2
