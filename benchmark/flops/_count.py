"""FLOPs of one layer's forward pass, from its shapes: two per
multiply-add. A backward pass costs the forward's FLOPs once for the
input gradient and once for the weight gradient, each counted only where
the step computes it (`passes`)."""

from __future__ import annotations


def conv(out_positions: int, k: int, c_in: int, c_out: int,
         nd: int = 2) -> float:
    """A k^nd convolution, per output position."""
    return 2.0 * out_positions * k ** nd * c_in * c_out


def deconv(in_positions: int, k: int, c_in: int, c_out: int) -> float:
    """A k x k transposed convolution, per input position: each input
    value meets every tap once, whatever the stride."""
    return 2.0 * in_positions * k * k * c_in * c_out


def matmul(rows: int, n_in: int, n_out: int) -> float:
    return 2.0 * rows * n_in * n_out


def passes(fwd: float, input_grad: bool, weight_grad: bool) -> float:
    return fwd * (1 + input_grad + weight_grad)
