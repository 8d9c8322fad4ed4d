"""The port's device detector (gifgan_tpu_torch/track/haar_device.py) and its
stage kernel's module (kernels/haar_stages.py) against the JAX package's
gifgan_tpu/track/haar_device.py, on one seeded cascade file and seeded numpy
frames. The port runs with device="cpu", where the kernel's wrapper takes its
plain version; the JAX package runs its XLA stage program and, once, its
Pallas kernel in interpret mode.

Tolerances. The planner, the resize matrices, the grid and the kernel tables
are equal exactly. The early-stage alive mask may differ from the JAX
package's on at most 0.01 % of the valid windows: the two frameworks' resize
products and cumsums round in another order, which can flip a window that
sits on a threshold (the count is printed). Detections after the float64
finisher and the grouping are equal exactly on the mask cases, and within
1 px with equal counts on the whole-slice cases. Above the float32 bound the
port keeps the card with float64 canvases where the JAX package goes to the
feature-scaled host detector, so that case is held to the port's own host
detector by IoU > 0.6, the contract between the two families of backends.

The kernel itself against the plain version on a card:
`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_haar_device.py`.
"""

import numpy as np
import pytest
import torch

from gifgan_tpu_torch.core.interop import cascade_tables
from gifgan_tpu_torch.kernels import haar_stages as K
from gifgan_tpu_torch.track import haar_device as TD
from gifgan_tpu_torch.track import synthetic_cascade as SC
from gifgan_tpu_torch.track.haar import (NativeHaarDetector, _scaled_rects,
                                         parse_cascade)

MASK_TOLERANCE = 1e-4        # share of valid windows that may differ


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    in each keeps the plain kernels' large elementwise passes from
    oversubscribing the cores."""
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
def full_xml(tmp_path_factory):
    return SC.write_cascade(
        str(tmp_path_factory.mktemp("cascade") / "full.xml"), seed=0)


def _clip(seed, t, h, w, side, background="noise"):
    rng = np.random.default_rng(seed)
    frames, boxes = zip(*(SC.planted_frame(rng, h, w, side, background)
                          for _ in range(t)))
    return np.stack(frames), boxes


def _jax_detector(xml, **kw):
    from gifgan_tpu.track.haar_device import DeviceHaarDetector

    return DeviceHaarDetector(xml, **kw)


def _jax_mask(det, frames):
    """The JAX package's early-stage mask and the program it came from,
    which is left in the detector's cache for detect_batch to reuse."""
    import jax.numpy as jnp

    t, h, w = frames.shape
    prog = det._build_program(t, h, w)
    det._progs[(t, h, w)] = prog
    ny, nx, valid = prog[2], prog[3], prog[4]
    packed = np.asarray(prog[0](jnp.asarray(frames)))
    return np.unpackbits(packed)[:t * ny * nx].reshape(t, ny, nx), valid


def _iou(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2 = min(a[0] + a[2], b[0] + b[2])
    y2 = min(a[1] + a[3], b[1] + b[3])
    inter = max(0, x2 - x1) * max(0, y2 - y1)
    return inter / (a[2] * a[3] + b[2] * b[3] - inter)


def _largest(rects):
    return rects[np.argmax(rects[:, 2] * rects[:, 3])]


@pytest.mark.parametrize("h,w,scale_factor,min_size,max_factor", [
    (64, 64, 1.1, 20, 1.0), (96, 112, 1.1, 20, 1.0), (256, 256, 1.1, 20, 1.0),
    (360, 480, 1.2, 30, 0.8), (100, 37, 1.25, 24, 1.0), (19, 40, 1.1, 20, 1.0)])
def test_plan_levels_equals_jax(xml, h, w, scale_factor, min_size, max_factor):
    from gifgan_tpu.track import haar_device as JD

    cas = parse_cascade(xml)
    want = JD._plan_levels(cas, h, w, scale_factor, min_size, max_factor)
    got = TD._plan_levels(cas, h, w, scale_factor, min_size, max_factor)
    assert [tuple(lv) for lv in got] == [tuple(lv) for lv in want]
    if (h, w) == (256, 256):
        assert len(got) == 27 and got[-1].row == 2620
    if h == 19:
        assert got == []


@pytest.mark.parametrize("n_in,n_out", [(64, 64), (96, 87), (112, 21),
                                        (360, 33), (20, 20)])
def test_resize_matrix_equals_jax(n_in, n_out):
    from gifgan_tpu.track import haar_device as JD

    want = JD._resize_matrix(n_in, n_out)
    got = TD._resize_matrix(n_in, n_out)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("h,w,stride", [(64, 64, 1), (96, 112, 1),
                                        (96, 112, 2)])
def test_grid_meta_equals_jax(xml, h, w, stride):
    jd = _jax_detector(xml, stride=stride)
    td = TD.DeviceHaarDetector(xml, stride=stride, device="cpu")
    assert (td.ext_x, td.ext_y) == (jd.ext_x, jd.ext_y)
    levels = TD._plan_levels(td.cas, h, w, 1.1, 20, 1.0)
    last = levels[-1]
    canvas_h = last.row + ((last.h + 2) // 2) * 2 + td.ext_y
    canvas_w = levels[0].w + 1
    want = jd._grid_meta(levels, canvas_h, canvas_w)
    got = td._grid_meta(levels, canvas_h, canvas_w)
    assert got[:2] == want[:2]
    assert np.array_equal(got[2], want[2]) and np.array_equal(got[3], want[3])
    plan = td._plan(h, w)
    assert (plan.canvas_h, plan.canvas_w, plan.ny, plan.nx) == (
        canvas_h, canvas_w) + want[:2]
    assert np.array_equal(plan.grid.valid.numpy() != 0, want[2])
    assert plan.dtype == torch.float32


@pytest.mark.parametrize("n_early", [1, 3, 8])
def test_stage_tables_equal_jax(xml, n_early):
    """The kernel tables, fed through interop.cascade_tables from the JAX
    package's parse of the file, against _cascade_params_rolled; and
    stage_tables' whole-cascade arrays start with the same rows."""
    jd = _jax_detector(xml, early_stages=n_early)
    want = jd._cascade_params_rolled(n_early)
    got = cascade_tables(jd.cas, n_early)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    cas = parse_cascade(xml)
    rects0 = _scaled_rects(cas, 1.0)
    tables = K.stage_tables(cas, rects0, torch.float32, "cpu")
    assert tables.stage_end[n_early - 1] == want[0]
    assert tables.ends.tolist() == list(tables.stage_end)
    on_device = unpack_records(tables.records.numpy(), np.float32)
    for a, b, c in zip(tables.host, on_device, want[1:]):
        assert np.array_equal(a[:want[0]], c)
        assert b.dtype == a.dtype and np.array_equal(b, a)
    wide = K.stage_tables(cas, rects0, torch.float64, "cpu")
    assert wide.host[2].dtype == np.float64 and wide.dtype == torch.float64
    assert np.array_equal(wide.host[2], cas.node_thr)
    # one figure for the furthest corner: the detector's grid takes the
    # tables' own, which the launch check reads too
    td = TD.DeviceHaarDetector(xml, device="cpu")
    assert (td.ext_x, td.ext_y) == (tables.ext_x, tables.ext_y) == (
        wide.ext_x, wide.ext_y) == (jd.ext_x, jd.ext_y)
    assert np.array_equal(wide.host[0], tables.host[0])


@pytest.fixture(scope="module")
def mask_case(xml):
    """One clip through the JAX XLA program, the JAX Pallas kernel in
    interpret mode and the port's plain version, early_stages = 3."""
    frames, boxes = _clip(3, 3, 96, 112, 40)
    jd = _jax_detector(xml, min_neighbors=3, early_stages=3)
    jp = _jax_detector(xml, min_neighbors=3, early_stages=3, use_pallas=True)
    jp._pallas_interpret = True
    td = TD.DeviceHaarDetector(xml, min_neighbors=3, early_stages=3,
                               device="cpu")
    xla, valid = _jax_mask(jd, frames)
    pallas, _ = _jax_mask(jp, frames)
    port = td.early_mask(frames)
    return dict(frames=frames, boxes=boxes, jd=jd, td=td, xla=xla,
                pallas=pallas, port=port, valid=valid)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_plain_mask_matches_jax(mask_case, reference):
    c = mask_case
    port = c["port"]
    assert port.dtype == torch.int8 and port.shape == c["xla"].shape
    port = port.numpy()
    n_valid = int(c["valid"].sum()) * len(c["frames"])
    differ = int((port != c[reference]).sum())
    print(f"{reference}: {differ} of {n_valid} valid windows differ, "
          f"{int(port.sum())} survive")
    assert differ <= MASK_TOLERANCE * n_valid
    assert not port[:, ~c["valid"]].any()
    assert 0 < port.sum() < 0.25 * n_valid


def test_detections_after_finisher_equal_jax(mask_case):
    c = mask_case
    grays = c["frames"].astype(np.float64)
    want = c["jd"].detect_batch(grays)
    got = c["td"].detect_batch(grays)
    assert len(got) == len(want) == 3
    for a, b, (x, y, s) in zip(got, want, c["boxes"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.abs(_largest(a) - [x, y, s, s]).max() <= 4


def test_ten_early_stages_of_the_full_cascade_match_jax(full_xml):
    """The stage kernel's real depth: 253 trees in 10 stages."""
    frames, boxes = _clip(4, 2, 64, 80, 32)
    jd = _jax_detector(full_xml, min_neighbors=3)
    td = TD.DeviceHaarDetector(full_xml, min_neighbors=3, device="cpu")
    assert td.early_stages == 10 and td._plan(64, 80).tables.stage_end[9] == 253
    want, valid = _jax_mask(jd, frames)
    got = td.early_mask(frames).numpy()
    differ = int((got != want).sum())
    print(f"{differ} of {int(valid.sum()) * 2} valid windows differ, "
          f"{int(got.sum())} survive")
    assert differ <= MASK_TOLERANCE * valid.sum() * 2
    grays = frames.astype(np.float64)
    for a, b, (x, y, s) in zip(td.detect_batch(grays), jd.detect_batch(grays),
                               boxes):
        assert np.array_equal(a, b)
        assert len(a) == 1 and np.abs(a[0] - [x, y, s, s]).max() <= 3


def _assert_rects_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        if len(a):
            assert np.abs(a - b).max() <= 1


def test_detect_clips_and_video_match_jax(xml):
    """The slice as a whole: two clips of different size and length through
    detect_clips (both packages pad to a 64x96 canvas; the JAX package
    also pads to 32 frames), then detect_video and __call__."""
    from gifgan_tpu.track.boxes import Detection as JDetection

    big, big_boxes = _clip(5, 3, 64, 96, 36)
    small, _ = _clip(6, 2, 56, 80, 30, "black")
    noise = np.random.default_rng(7).integers(0, 255, (1, 64, 96))
    clips = [big.astype(np.float64), small.astype(np.float64),
             noise.astype(np.float64)]
    jd = _jax_detector(xml, min_neighbors=3, early_stages=3)
    td = TD.DeviceHaarDetector(xml, min_neighbors=3, early_stages=3,
                               device="cpu")
    want = jd.detect_clips(clips)
    got = td.detect_clips(clips)
    assert [len(c) for c in got] == [3, 2, 1]
    for g, w in zip(got, want):
        _assert_rects_close(g, w)
    assert len(got[2][0]) == 0                        # noise: nothing
    for rects, (x, y, s) in zip(got[0], big_boxes):
        assert np.abs(_largest(rects) - [x, y, s, s]).max() <= 4
    for frames, (h_i, w_i) in zip(got, ((64, 96), (56, 80))):
        for rects in frames:
            for x, y, w, h in rects:
                assert x >= 0 and y >= 0 and x + w <= w_i and y + h <= h_i
    assert td.detect_clips([]) == []

    # detect_video on RGB frames of the canvas's own size reuses the
    # (3, 64, 96) shape; the JAX program for it is compiled once more
    rgb = np.repeat(big[..., None], 3, axis=-1)
    jv = jd.detect_video(rgb)
    tv = td.detect_video(rgb)
    assert [[(d.x1, d.y1, d.x2, d.y2, d.frame_number) for d in f]
            for f in tv] == [[(d.x1, d.y1, d.x2, d.y2, d.frame_number)
                              for d in f] for f in jv]
    assert isinstance(jv[0][0], JDetection) and tv[0]
    one = td(rgb[1], 9)
    assert [(d.x1, d.y1, d.x2, d.y2) for d in one] == [
        (d.x1, d.y1, d.x2, d.y2) for d in tv[1]]
    assert all(d.frame_number == 9 for d in one)
    assert np.array_equal(td.detect_rects(clips[0][2]),
                          td.detect_batch(clips[0])[2])


def test_float64_canvases_above_the_float32_bound(xml):
    """A 360x480 frame: 360 * 480 * 255 > 2^24, so the canvases are float64
    and the port stays on its device path; held to the port's host detector
    as the JAX package's tests hold its device detector (primary box IoU >
    0.6), and to the planted box."""
    frames, boxes = _clip(8, 1, 360, 480, 170, "black")
    td = TD.DeviceHaarDetector(xml, min_neighbors=3, early_stages=3,
                               device="cpu")
    plan = td._plan(360, 480)
    assert plan.dtype == torch.float64
    assert plan.tables.dtype == torch.float64
    assert plan.tables.records.shape == (plan.tables.stage_end[-1], 144)
    before = td.early_mask(frames)
    assert before.dtype == torch.int8 and before.shape[1:] == (plan.ny,
                                                               plan.nx)
    host = NativeHaarDetector(xml, min_neighbors=3)
    for rects, frame, (x, y, s) in zip(
            td.detect_batch(frames.astype(np.float64)), frames, boxes):
        primary = _largest(rects)
        assert _iou(primary, _largest(host.detect_rects(
            frame.astype(np.float64)))) > 0.6
        assert _iou(primary, (x, y, s, s)) > 0.8


def test_frames_are_chunked_by_canvas_bytes(xml, monkeypatch):
    frames, _ = _clip(9, 5, 64, 64, 30)
    td = TD.DeviceHaarDetector(xml, min_neighbors=3, early_stages=3,
                               device="cpu")
    whole = td.early_mask(frames)
    calls = []
    real = TD.haar_stages
    monkeypatch.setattr(TD, "haar_stages",
                        lambda ii, *a, **k: calls.append(ii.shape[0])
                        or real(ii, *a, **k))
    plan = td._plan(64, 64)
    monkeypatch.setattr(TD, "MAX_CANVAS_BYTES",
                        2 * 2 * plan.canvas_h * plan.canvas_w * 4)
    assert torch.equal(td.early_mask(frames), whole)
    assert calls == [2, 2, 1]


def test_numpy_finisher_equals_native(xml):
    """The C++ finisher the detector binds against the numpy one, on the
    survivors of three early stages, frame by frame."""
    frames, _ = _clip(10, 2, 96, 112, 40)
    td = TD.DeviceHaarDetector(xml, min_neighbors=3, early_stages=3,
                               device="cpu")
    plan = td._plan(96, 112)
    idx = torch.nonzero(td.early_mask(frames)).numpy()
    native = td._host_deep()
    assert td._native is not None
    for fr in range(2):
        gy, gx = idx[idx[:, 0] == fr, 1], idx[idx[:, 0] == fr, 2]
        need = np.unique(plan.level_id[gy, gx])
        args = (frames[fr].astype(np.float64), gx, gy, need, plan.levels,
                plan.np_mats, plan.canvas_h, 112)
        want = TD.numpy_deep_eval(td.cas, td.rects0, 3, *args)
        got = native(*args)
        assert len(gy) > 100 and 0 < got.sum() < len(gy)
        assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="scale_factor"):
        TD.DeviceHaarDetector(xml, scale_factor=1.0, device="cpu")
    tiny = td.detect_batch(np.zeros((2, 12, 30)))
    assert [r.shape for r in tiny] == [(0, 4), (0, 4)]


def test_wrapper_refuses_what_the_kernel_does_not_take(xml):
    td = TD.DeviceHaarDetector(xml, early_stages=3, device="cpu")
    plan = td._plan(64, 64)
    frames, _ = _clip(11, 1, 64, 64, 30)
    ii, ii2 = td._canvases(plan, torch.from_numpy(frames))
    grid = plan.grid
    ok = K.haar_stages(ii, ii2, grid, plan.tables, 3)
    assert torch.equal(ok, K.haar_stages_plain(ii, ii2, grid.valid,
                                               plan.tables, 3))
    # no stage: every valid window is alive
    assert torch.equal(K.haar_stages(ii, ii2, grid, plan.tables, 0)[0],
                       grid.valid)
    with pytest.raises(ValueError, match="torch.Tensor"):
        K.haar_stages(ii.numpy(), ii2, grid, plan.tables, 3)
    with pytest.raises(ValueError, match="float32 or float64"):
        K.haar_stages(ii.half(), ii2.half(), grid, plan.tables, 3)
    with pytest.raises(ValueError, match="tables are"):
        K.haar_stages(ii.double(), ii2.double(), grid, plan.tables, 3)
    with pytest.raises(ValueError, match="int8"):
        K.haar_stages(ii, ii2, grid._replace(valid=grid.valid.bool()),
                      plan.tables, 3)
    with pytest.raises(ValueError, match="n_stages"):
        K.haar_stages(ii, ii2, grid, plan.tables, 99)
    with pytest.raises(ValueError, match="reaches past"):
        K.haar_stages(ii[:, :-1], ii2[:, :-1], grid, plan.tables, 3)
    with pytest.raises(ValueError, match="reaches past"):
        K.haar_stages(ii, ii2, grid, plan.tables, 3, stride=2)


def unpack_records(packed: np.ndarray, dtype) -> tuple:
    """The inverse of K.pack_records: (N, record size) uint8 -> geo, wts,
    thr, leaf, flg, is_last, sthr as cascade_tables_rolled gives them."""
    rec = np.ascontiguousarray(packed).view(K.record_dtype(dtype))[:, 0]
    t = np.dtype(dtype)
    flags = rec["flags"]
    flg = np.stack([(flags & K.LEFT_LEAF) != 0, (flags & K.RIGHT_LEAF) != 0],
                   axis=1).astype(t)
    return (rec["geo"].reshape(-1, 2, 3).copy(),
            rec["wts"].reshape(-1, 2, 3).copy(), rec["thr"].copy(),
            rec["leaf"].copy(), flg, ((flags & K.ENDS_STAGE) != 0).astype(t),
            rec["sthr"].copy())


@pytest.mark.parametrize("n_stages", [1, 3, 10])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_records_unpack_to_the_rolled_tables(full_xml, dtype, n_stages):
    """The kernel's packed per-tree records hold exactly the plain
    version's arrays (cascade_tables_rolled), bit for bit."""
    cas = parse_cascade(full_xml)
    rolled = K.cascade_tables_rolled(cas, _scaled_rects(cas, 1.0), n_stages,
                                     dtype)
    packed = K.pack_records(rolled[1:], dtype)
    assert packed.dtype == np.uint8 and packed.shape == (
        rolled[0], 96 if dtype == np.float32 else 144)
    got = unpack_records(packed, dtype)
    for a, b in zip(got, rolled[1:]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), np.ascontiguousarray(
            b).view(np.uint8))


@pytest.mark.parametrize("h,w,stride", [(64, 64, 1), (96, 112, 1),
                                        (96, 112, 2)])
def test_valid_cell_list_equals_nonzero(xml, h, w, stride):
    """The plan's list of valid windows, which the kernel walks, holds the
    cells of torch.nonzero(valid), each once, in TILE x TILE tile order:
    tiles row-major, and inside a tile the order of torch.nonzero."""
    td = TD.DeviceHaarDetector(xml, stride=stride, device="cpu")
    plan = td._plan(h, w)
    valid, cells = plan.grid
    want = torch.nonzero(valid)
    got = cells.long()
    assert cells.dtype == torch.int32 and cells.is_contiguous()
    assert len(got) == len(want) == int(valid.sum()) > 0
    tile_of = lambda c: (int(c[0]) // K.TILE, int(c[1]) // K.TILE)
    by_tile = sorted(range(len(want)), key=lambda i: tile_of(want[i]))
    assert torch.equal(got, want[by_tile])
    assert sorted(map(tuple, got.tolist())) == list(map(tuple, want.tolist()))
    if h == 96 and stride == 1:
        assert plan.ny > K.TILE and plan.nx > K.TILE    # several tiles


def _bad_k3_args(td, plan, frames):
    ii, ii2 = td._canvases(plan, torch.from_numpy(frames))
    wide = K.stage_tables(td.cas, td.rects0, torch.float64, "cpu")
    grid = plan.grid
    base = [ii, ii2, grid, plan.tables, 3]
    cells = lambda c: (2, grid._replace(cells=c))
    cases = {
        "float64-tables": (3, wide),
        "records-not-uint8": (3, plan.tables._replace(
            records=plan.tables.records.view(torch.int32))),
        "canvas-not-contiguous": (0, ii.transpose(1, 2).contiguous(
            ).transpose(1, 2)),
        "grid-not-from-window-grid": (2, tuple(grid)),
        "cells-int64": cells(grid.cells.long()),
        "cells-shape": cells(grid.cells[:, :1]),
        "cells-too-many": cells(torch.zeros((grid.valid.numel() + 1, 2),
                                            dtype=torch.int32)),
        "cells-not-contiguous": cells(grid.cells.t().contiguous().t()),
        "cells-device": cells(grid.cells.to("meta")),
    }
    out = {}
    for name, (pos, bad) in cases.items():
        args = list(base)
        args[pos] = bad
        if name == "canvas-not-contiguous":
            args[1] = bad.clone()
        out[name] = args
    return out


@pytest.mark.parametrize("name", [
    "float64-tables", "records-not-uint8", "canvas-not-contiguous",
    "grid-not-from-window-grid", "cells-int64", "cells-shape", "cells-too-many", "cells-not-contiguous",
    "cells-device"])
def test_haar_stages_rejects_what_the_kernel_does_not_take(xml, name):
    """Refused on every device, before any kernel or plain version runs:
    tables of another type, canvases or cells the kernel cannot walk, a
    validity grid and cell list not made together by window_grid."""
    td = TD.DeviceHaarDetector(xml, early_stages=3, device="cpu")
    plan = td._plan(64, 64)
    args = _bad_k3_args(td, plan, _clip(13, 1, 64, 64, 30)[0])[name]
    with pytest.raises(ValueError):
        K.haar_stages(*args)


RUN = K.TILE ** 2   # list entries a block takes (csrc/haar_stages.cu kRun)


def _card_masks(xml, frames, stages, stride=1):
    """The kernel's and the plain version's masks on the card for each
    n_stages in `stages`, one launch per call; the list's length too."""
    td = TD.DeviceHaarDetector(xml, early_stages=3, stride=stride,
                               device="cuda")
    plan = td._plan(*frames.shape[1:])
    ii, ii2 = td._canvases(plan, torch.from_numpy(frames).cuda())
    out = []
    for n_stages in stages:
        before = K.haar_stages.launches
        got = K.haar_stages(ii, ii2, plan.grid, plan.tables, n_stages,
                            stride)
        torch.cuda.synchronize()
        assert K.haar_stages.launches == before + 1
        want = K.haar_stages_plain(ii, ii2, plan.grid.valid, plan.tables,
                                   n_stages, stride)
        assert got.dtype == torch.int8 and got.shape == want.shape
        out.append((n_stages, int((got != want).sum()), int(got.sum())))
    return out, len(plan.grid.cells)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(xml, full_xml):
    """The CUDA kernel against the plain version on the card, every byte of
    the mask (0 differing windows), at float32 and float64, stride 1 and 2,
    and at the edges that compacting survivors creates: no stage (mask =
    valid), all 20 stages of the full cascade, flat frames whose windows
    all die early, one frame, a grid smaller than one block's run of
    windows, and valid-window counts that are not a multiple of a run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; the kernel has no CPU mode")
    n_small = len(SC.SMALL_STAGES)
    for (h, w, side), stride in (((96, 112, 40), 1), ((96, 112, 40), 2),
                                 ((360, 480, 170), 1)):
        frames, _ = _clip(12, 3, h, w, side)
        res, n_cells = _card_masks(xml, frames, (0, 1, 3, n_small), stride)
        assert all(d == 0 for _, d, _ in res), res
        assert res[0][2] == 3 * n_cells and 0 < res[-1][2] < 3 * n_cells
        assert n_cells % RUN != 0 or stride == 2
    # the full cascade: 10 and all 20 stages, 2 frames and one
    for t in (2, 1):
        frames, _ = _clip(14, t, 128, 128, 60)
        res, _ = _card_masks(full_xml, frames, (1, 10, 20))
        assert all(d == 0 for _, d, _ in res), res
        assert res[1][2] > 0
    # flat frames: every window has zero variance and the same features
    flat = np.stack([np.zeros((96, 112), np.uint8),
                     np.full((96, 112), 128, np.uint8)])
    res, _ = _card_masks(full_xml, flat, (0, 1, 2, 10, 20))
    assert all(d == 0 for _, d, _ in res), res
    assert res[3][2] == res[4][2] == 0
    # a grid of fewer windows than one run
    frames, _ = _clip(15, 2, 24, 30, 20)
    res, n_cells = _card_masks(xml, frames, (0, 1, n_small))
    assert n_cells < RUN and all(d == 0 for _, d, _ in res), res


@pytest.mark.cuda
def test_kernel_skips_cells_outside_the_grid(xml):
    """A cell list that reaches outside its grid (one not from window_grid)
    makes the kernel neither read nor write out of bounds: it skips those
    cells, and the mask is the one of the cells inside."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; the kernel has no CPU mode")
    frames, _ = _clip(16, 2, 96, 112, 40)
    td = TD.DeviceHaarDetector(xml, early_stages=3, device="cuda")
    plan = td._plan(96, 112)
    ii, ii2 = td._canvases(plan, torch.from_numpy(frames).cuda())
    grid = plan.grid
    ny, nx = grid.valid.shape
    outside = torch.tensor([[ny, 0], [0, nx], [-1, 3], [ny + 7, nx + 9],
                            [2 ** 30, -2 ** 30]], dtype=torch.int32,
                           device="cuda")
    mixed = grid._replace(cells=torch.cat([outside, grid.cells[:-5]]))
    want = K.haar_stages_plain(ii, ii2, grid.valid, plan.tables, 3)
    inside = torch.zeros_like(grid.valid)
    kept = grid.cells[:-5].long()
    inside[kept[:, 0], kept[:, 1]] = 1
    got = K.haar_stages(ii, ii2, mixed, plan.tables, 3)
    torch.cuda.synchronize()
    assert torch.equal(got, want & inside[None])
