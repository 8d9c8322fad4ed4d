"""The benchmark's FLOP and byte counts against hand counts of one layer
of each kind, and against the configuration's published shapes."""

import copy

import pytest

from benchmark import run as R
from benchmark.flops import _count
from benchmark.peaks import k1_bytes


@pytest.mark.parametrize("fn, args, hand", [
    # 5x5/2 conv, 64x64x3 -> 32x32x64: 1,024 outputs x 25 taps x 3 x 64
    (_count.conv, (32 * 32, 5, 3, 64), 2 * 1024 * 25 * 3 * 64),
    # 5x5/2 transposed conv 4x4x512 -> 8x8x256, per input position
    (_count.deconv, (4 * 4, 5, 512, 256), 2 * 16 * 25 * 512 * 256),
    # 3x3x3/2 conv3d 16x8x8x256 -> 8x4x4x256
    (lambda *a: _count.conv(*a, nd=3), (8 * 4 * 4, 3, 256, 256),
     2 * 128 * 27 * 256 * 256),
    # linear 100 -> 8192 over 4,096 frames
    (_count.matmul, (4096, 100, 8192), 2 * 4096 * 100 * 8192),
    # the LSTM's gate product: [8192 codes, 100 state] -> 4 x 100 gates
    (_count.matmul, (640, 8192 + 100, 400), 2 * 640 * 8292 * 400),
])
def test_layer_counts(fn, args, hand):
    assert fn(*args) == hand


def test_passes():
    assert _count.passes(10.0, False, False) == 10.0
    assert _count.passes(10.0, True, False) == 20.0
    assert _count.passes(10.0, True, True) == 30.0


def _cell(name):
    spec = R.cell_spec(name)
    return spec, R.load("flops", spec["config_name"])


def test_vid_step_by_hand():
    """One vid step at 256 clips, counted by hand from the layers:
    GFLOP a frame of the vid-G MLP, image G, image-D tap and vid-D."""
    spec, flops = _cell("vid_train_corpus_b256")
    n, b = 256 * 16, 256
    g = 2 * n * (121 * 512 + 512 * 512 * 2 + 512 * 100)
    ig = 2 * n * (100 * 8192 + 25 * (16 * 512 * 256 + 64 * 256 * 128
                                     + 256 * 128 * 64 + 1024 * 64 * 3))
    tap = 2 * n * 25 * (1024 * 3 * 64 + 256 * 64 * 128 + 64 * 128 * 256)
    d_layers = [2 * b * 27 * 256 * 256 * p for p in (128, 16, 2)] + [
        2 * b * 512]
    vd_fwd = sum(d_layers)
    d_update = tap + g + ig + tap + 2 * (3 * vd_fwd - d_layers[0])
    g_update = (3 * g - 2 * n * 121 * 512) + 2 * ig + 2 * tap + 2 * vd_fwd
    assert flops.step_flops(spec["config"], b) == d_update + 2 * g_update


def test_count_ignores_packed_c3():
    spec, flops = _cell("vid_train_corpus_b256")
    other = copy.deepcopy(spec["config"])
    other["image_gan"]["packed_c3"] = not other["image_gan"]["packed_c3"]
    assert (flops.step_flops(spec["config"], 256)
            == flops.step_flops(other, 256))


def test_k1_bytes():
    """256 distinct clip rows of 16x64x64x3 bytes read, 256 float32 rows
    written, 256 int64 ids read."""
    d = 16 * 64 * 64 * 3
    assert k1_bytes(256, 256, d) == 256 * d + 256 * d * 4 + 256 * 8
    assert k1_bytes(1, 4, 10) == 10 + 4 * 48
