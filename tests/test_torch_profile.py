"""gifgan_tpu_torch/core/profile.py against gifgan_tpu/core/profile.py:
step timing, the epoch estimate, sync over trees, and summarize_trace on a
real CPU capture and on hand-written traces."""

import gzip
import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from gifgan_tpu.core import profile as jprofile
from gifgan_tpu_torch.core import profile as tprofile


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TIMES = [0.5, 0.25, 0.125, 0.2, 0.0625]


@pytest.mark.parametrize("skip", [0, 1, 3, 10])
def test_step_times_summary_equals_the_jax_one(skip):
    got, want = tprofile.StepTimes(), jprofile.StepTimes()
    got.times, want.times = list(TIMES), list(TIMES)
    assert got.summary(skip) == want.summary(skip)


def test_estimate_epoch_hours_equals_the_jax_one():
    for batches in (1, 3165, 10_000):
        assert (tprofile.estimate_epoch_hours(TIMES, batches)
                == jprofile.estimate_epoch_hours(TIMES, batches))
    assert abs(tprofile.estimate_epoch_hours([1.0, 1.0], 3600) - 1.0) < 1e-9


def test_step_times_measure_syncs_a_result():
    st = tprofile.StepTimes()
    for _ in range(3):
        with st.measure() as out:
            out["result"] = {"d_loss": torch.ones(4) * 2}
    s = st.summary(skip=1)
    assert s["n"] == 2 and s["steps_per_sec"] > 0


class _Pair(NamedTuple):
    p: object
    q: object


def test_sync_walks_nested_trees_in_the_jax_order():
    import jax

    arrs = [np.full(2, i, np.float32) for i in range(6)]
    tree = {"b": [arrs[0], (arrs[1], None)], "a": {"y": arrs[2],
                                                   "x": arrs[3]},
            "c": _Pair(p=arrs[4], q=arrs[5])}
    got = tprofile._leaves(tree)
    want = jax.tree_util.tree_leaves(tree)
    assert [id(x) for x in got] == [id(x) for x in want]

    tensors = {"m": _Pair(p=[torch.ones(3)], q=torch.zeros(())),
               "a": (None, torch.arange(4.0))}
    tprofile.sync(tensors)
    for empty in ({}, [], (), None, {"a": None}, [torch.empty(0)]):
        tprofile.sync(empty)


# The capture of the test below, run in a process of its own: a capture
# records the ops of every thread of its process, and a test worker may
# hold threads that earlier tests started. One intra-op thread, and a
# product ~1000x the tanh's work, so `dot` leads on a loaded host too.
_CAPTURE = """
import sys
import torch
from gifgan_tpu_torch.core import profile as tprofile

torch.set_num_threads(1)
g = torch.Generator().manual_seed(0)
x = torch.rand((256, 1024), generator=g)
w = torch.rand((1024, 1024), generator=g) / 1024


def f(x):
    for _ in range(3):
        x = torch.tanh(x @ w)
    return x


f(x)
with tprofile.trace(sys.argv[1]):
    f(x)
"""


def test_summarize_trace_of_a_real_cpu_capture(tmp_path):
    """The counterpart of tests/test_profile_ckpt_tools.py's: a CPU trace
    of tanh(x @ w) three times; dot takes most of the time and a container
    op (aten::matmul) is not counted again through the op it calls
    (aten::mm)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", _CAPTURE, str(tmp_path)],
                   check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1"))
    files = [n for _, _, ns in os.walk(tmp_path) for n in ns]
    assert len(files) == 1 and files[0].endswith(".pt.trace.json.gz")

    s = tprofile.summarize_trace(str(tmp_path), top=10)
    assert s["total_us"] > 0
    cats = s["by_category"]
    assert max(cats, key=cats.get) == "dot"
    names = [n for n, _, _ in s["ops"]]
    assert "aten::matmul" in names and "aten::mm" not in names
    assert abs(sum(p for _, _, p in s["ops"]) - 100.0) < 1e-6
    assert abs(sum(cats.values()) - s["total_us"]) < 1e-6


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _write(path, events, mtime=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    if mtime is not None:
        os.utime(path, (mtime, mtime))


GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"
DEVICE_EVENTS = [
    {"ph": "M", "name": "thread_name", "pid": 1, "tid": 7,
     "args": {"name": "stream 7"}},
    # host rows: not counted once the trace has device rows
    _x("cpu_op", "aten::matmul", 0, 50), _x("cpu_op", "aten::mm", 1, 40),
    _x("cuda_runtime", "cudaLaunchKernel", 2, 5),
    _x("user_annotation", "step", 0, 100),
    _x("kernel", GEMM, 10, 12.5, tid=7, grid=[1, 2, 1]),
    _x("kernel", GEMM, 30, 7.5, tid=7),
    _x("kernel", "void gather_rows_scaled_vec16(unsigned char const*, "
       "long const*, float*, long, long)", 40, 4.0, tid=7),
    _x("kernel", "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_"
       "nhwckrsc_nhwc", 50, 9.0, tid=7),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4, "
       "at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3> >"
       "(int, at::native::CUDAFunctor_add<float>, at::detail::Array<char*,"
       " 3>)", 60, 3.0, tid=7),
    _x("kernel", "void at::native::reduce_kernel<512, 1, at::native::"
       "ReduceOp<float, at::native::MeanOps<float, float, float, float>, "
       "unsigned int, float, 4> >(at::native::ReduceOp<float, at::native::"
       "MeanOps<float, float, float, float>, unsigned int, float, 4>)",
       70, 2.0, tid=7),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 80, 1.5, tid=7),
    _x("gpu_memset", "Memset (Device)", 90, 0.5, tid=7),
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 1, "tid": 1,
     "ts": 2},
    {"ph": "i", "name": "Record Window End", "ts": 100, "pid": "", "tid": ""},
]


def test_summarize_trace_counts_the_device_rows(tmp_path):
    """A hand-written capture with kernels, a memcpy, a memset and nested
    host rows: exactly the device rows count, once each, the hand-written
    kernel under its own name; an older capture is not read."""
    _write(str(tmp_path / "a" / "old.pt.trace.json.gz"),
           [_x("kernel", GEMM, 0, 1000.0)], mtime=1_000_000)
    _write(str(tmp_path / "b" / "new.pt.trace.json.gz"), DEVICE_EVENTS)
    s = tprofile.summarize_trace(str(tmp_path))
    assert s["total_us"] == 40.0
    assert list(s["by_category"].items()) == [
        ("dot", 20.0), ("convolution", 9.0), ("gather_rows_scaled", 4.0),
        ("elementwise", 3.0), ("reduce", 2.0), ("copy", 1.5),
        ("other", 0.5)]
    assert [(n, us) for n, us, _ in s["ops"]] == [
        (GEMM, 20.0), (DEVICE_EVENTS[8]["name"], 9.0),
        ("gather_rows_scaled", 4.0), (DEVICE_EVENTS[9]["name"], 3.0),
        (DEVICE_EVENTS[10]["name"], 2.0),
        ("Memcpy HtoD (Pageable -> Device)", 1.5), ("Memset (Device)", 0.5)]
    assert [p for _, _, p in s["ops"]][:3] == [50.0, 22.5, 10.0]
    first = s["op_details"][0]
    assert first == {"name": GEMM, "us": 20.0, "pct": 50.0,
                     "category": "dot", "tflops": 0.0, "gbps": 0.0,
                     "source": ""}
    top2 = tprofile.summarize_trace(str(tmp_path), top=2)
    assert len(top2["ops"]) == 2 and top2["total_us"] == 40.0


def test_summarize_trace_counts_outermost_host_ops_without_device_rows(
        tmp_path):
    """A CPU capture: each aten op that no other op on its thread encloses
    counts once; an op on another thread overlapping in time counts too."""
    events = [
        _x("cpu_op", "aten::conv2d", 0, 100),
        _x("cpu_op", "aten::convolution", 1, 99),
        _x("cpu_op", "aten::_convolution", 2, 97),
        _x("cpu_op", "aten::add_", 100, 10),        # starts where conv ends
        _x("cpu_op", "aten::empty", 105, 1),        # inside add_
        _x("cpu_op", "aten::mm", 50, 30, tid=2),
        _x("user_annotation", "step", 0, 200),
        _x("python_function", "f.py(3): f", 0, 200),
    ]
    _write(str(tmp_path / "cpu.pt.trace.json.gz"), events)
    s = tprofile.summarize_trace(str(tmp_path))
    assert s["total_us"] == 140.0
    assert s["by_category"] == {"convolution": 100.0, "dot": 30.0,
                                "elementwise": 10.0}
    assert [n for n, _, _ in s["ops"]] == ["aten::conv2d", "aten::mm",
                                           "aten::add_"]


def test_summarize_trace_keys_equal_the_jax_result(tmp_path):
    _write(str(tmp_path / "jax" / "x.trace.json.gz"),
           [{"ph": "X", "name": "dot.1", "ts": 0, "dur": 5.0, "pid": 1,
             "tid": 1, "args": {}}])
    _write(str(tmp_path / "torch" / "x.pt.trace.json.gz"), DEVICE_EVENTS)
    want = jprofile.summarize_trace(str(tmp_path / "jax"))
    got = tprofile.summarize_trace(str(tmp_path / "torch"))
    assert set(got) == set(want)
    assert set(got["op_details"][0]) == set(want["op_details"][0])
    assert len(got["ops"][0]) == len(want["ops"][0]) == 3
    with pytest.raises(FileNotFoundError):
        tprofile.summarize_trace(str(tmp_path / "none"))


@pytest.mark.parametrize("name, want", [
    ("void gather_rows_scaled_scalar(unsigned char const*)",
     "gather_rows_scaled"),
    ("void resize_rows<unsigned char, true>(unsigned char const*)",
     "resize_normalize"),
    ("void haar_stages_kernel<double>(double const*)", "haar_stages"),
    ("lk_refine_kernel(float const*)", "lk_refine"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16", "convolution"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s16816gemm>", "dot"),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)>", "copy"),
    ("void at::native::index_elementwise_kernel<128, 4>", "gather"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel",
     "elementwise"),
    ("aten::linear", "dot"),
    ("Memset (Device)", "other"),
])
def test_category(name, want):
    assert tprofile.category(name) == want


# ---------------------------------------------------------------------------
# spans inside the VID_DCGAN step
# ---------------------------------------------------------------------------

NET_SPANS = ("vid.vid_g", "vid.img_g", "vid.img_d_tap", "vid.vid_d")
BWD_SPANS = tuple(f"{n}.bwd" for n in NET_SPANS)
# each span with the parents it may have: the forward and update spans
# sit in the step, the nets' backward parts in the update's backward
# pass, the folds of the frozen nets' inference BN in those nets' spans
PARENTS = {**{n: ("vid.step",) for n in NET_SPANS + (
    "vid.loss", "vid.backward", "vid.optimizer")},
    **{n: ("vid.backward",) for n in BWD_SPANS}, "vid.step": (None,),
    "nn.bn_fold": ("vid.img_g", "vid.img_d_tap")}
# one step of 1 D and 2 G updates; 4 folds an image G, 2 a tap
COUNTS = {"vid.step": 1, "vid.vid_g": 3, "vid.img_g": 3, "vid.img_d_tap": 4,
          "vid.vid_d": 4, "vid.loss": 3, "vid.backward": 3,
          "vid.optimizer": 3, "vid.vid_d.bwd": 3, "vid.img_d_tap.bwd": 2,
          "vid.img_g.bwd": 2, "vid.vid_g.bwd": 2, "nn.bn_fold": 20}


@pytest.fixture(scope="module")
def vid_step():
    """The tiny video GAN of tests/test_serve.py (widths 8, 32 px, 4
    frames) and one batch: (state, frames, z, cfg, tcfg)."""
    from gifgan_tpu_torch.core.config import (DCGANConfig, TrainConfig,
                                              VidGANConfig)
    from gifgan_tpu_torch.train import vid

    img = DCGANConfig(output_size=32, c_dim=3, z_dim=16, gf_dim=8, df_dim=8)
    cfg = VidGANConfig(z_input_size=20, z_output_size=16, vid_length=4,
                       hidden_dim=32, d_filters=16, image_gan=img,
                       first_frame_loss_scalar=1.0)
    tcfg = TrainConfig(batch_size=4, disc_updates=1, gen_updates=2)
    ts = vid.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg,
                              device="cpu")
    g = torch.Generator().manual_seed(1)
    frames = torch.rand((16, 32, 32, 3), generator=g) * 2 - 1
    z = torch.rand((4, 20), generator=g) * 2 - 1
    return ts, frames, z, cfg, tcfg


def _steps(vid_step, k=1):
    from gifgan_tpu_torch.train import vid

    ts, frames, z, cfg, tcfg = vid_step
    return vid.train_chunk(ts, torch.stack([frames] * k),
                           torch.stack([z] * k), None, cfg, tcfg)


def profile_cpu():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def _recorded(vid_step, k=1):
    """k steps under a profiler session of their own (the summary taken
    first sees the profiler off, so the session's spans start a list)."""
    tprofile.span_summary()
    with profile_cpu() as prof:
        out = _steps(vid_step, k)
    return out, prof


def test_span_off_records_nothing(vid_step, monkeypatch):
    """With no profiler: one shared no-op, and no record_function, hook,
    CUDA event or record."""
    def refuse(*a, **k):
        raise AssertionError("called with no profiler active")

    _recorded(vid_step)
    before = tprofile.span_summary()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.Tensor, "register_hook", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(tprofile, "_Record", refuse)
    assert tprofile.span("a") is tprofile.span("b", "cpu")
    _steps(vid_step)
    assert tprofile.span_summary() == before


def test_spans_of_one_step(vid_step):
    """Every span of the step once per its work, inside its parent."""
    _recorded(vid_step)
    records = list(tprofile._SPANS.records)
    s = tprofile.span_summary()
    assert s["steps"] == 1
    assert {n: v["count"] for n, v in s["spans"].items()} == COUNTS
    for r in records:
        assert (r.parent.name if r.parent else None) in PARENTS[r.name]
        assert r.step == 1
        assert r.host[0] <= r.host[1]
        if r.parent:
            assert r.parent.host[0] <= r.host[0] <= r.host[1] <= \
                r.parent.host[1]


def test_backward_parts_tile_the_backward_pass(vid_step):
    """The nets' backward parts, after the loss's own, fill `vid.backward`;
    forward, backward, Adam and the step's own time fill `vid.step`."""
    _recorded(vid_step)
    sp = tprofile.span_summary()["spans"]
    bwd = sp["vid.backward"]
    parts = sum(sp[n]["host_s"] for n in BWD_SPANS)
    loss_part = bwd["self_device_s"]     # the CPU's clock is the host's
    assert 0 < loss_part < bwd["host_s"]
    assert parts + loss_part == pytest.approx(bwd["host_s"], rel=1e-2)
    whole = sum(sp[n]["device_s"] for n in NET_SPANS + (
        "vid.loss", "vid.backward", "vid.optimizer"))
    assert whole + sp["vid.step"]["self_device_s"] == pytest.approx(
        sp["vid.step"]["device_s"], rel=1e-9)


def test_spans_are_user_annotations_of_the_capture(vid_step, tmp_path):
    _, prof = _recorded(vid_step)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(COUNTS) <= names


@pytest.mark.parametrize("between", ["summary", "unrecorded_step",
                                     "trace"])
def test_two_sessions_give_two_summaries(vid_step, between, tmp_path):
    """A session's first span starts a new list: in a session that
    `trace` opens, or once the previous session's end has been seen (by a
    summary, or by a span with no profiler). Else the second summary
    would count three steps."""
    _recorded(vid_step)
    if between == "summary":
        assert tprofile.span_summary()["steps"] == 1
    if between == "unrecorded_step":
        _steps(vid_step)
    if between == "trace":
        with tprofile.trace(str(tmp_path)):
            _steps(vid_step, k=2)
    else:
        with profile_cpu():
            _steps(vid_step, k=2)
    second = tprofile.span_summary()
    assert second["steps"] == 2
    assert {n: v["count"] for n, v in second["spans"].items()} == {
        n: 2 * c for n, c in COUNTS.items()}
    assert tprofile.span_summary() == second


def test_recorded_step_equals_the_unrecorded_one(vid_step):
    """The spans and their hooks change no loss and no new state."""
    from gifgan_tpu_torch.core.tree import flatten

    (ts_on, m_on), _ = _recorded(vid_step)
    ts_off, m_off = _steps(vid_step)
    assert m_on.keys() == m_off.keys()
    for k in m_off:
        assert torch.equal(m_on[k], m_off[k]), k
    on, off = flatten(ts_on._asdict()), flatten(ts_off._asdict())
    assert on.keys() == off.keys()
    for k in off:
        assert torch.equal(on[k], off[k]), k


def test_bn_folds_are_spans_of_an_open_span_only(vid_step):
    """A fold records an `nn.bn_fold` span inside an open span and
    nothing outside one: a profiled `sample_videos` after the step adds
    no root, so no step, and no fold; inside a span its image G records
    its 4."""
    from gifgan_tpu_torch.train import vid

    ts, _, z, cfg, _ = vid_step
    tprofile.span_summary()
    with profile_cpu():
        _steps(vid_step)
        vid.sample_videos(ts, z, cfg)
    s = tprofile.span_summary()
    assert s["steps"] == 1
    assert s["spans"]["nn.bn_fold"]["count"] == 20
    with profile_cpu():
        with tprofile.span("serve"):
            vid.sample_videos(ts, z, cfg)
    s = tprofile.span_summary()
    assert s["steps"] == 1
    assert {n: v["count"] for n, v in s["spans"].items()} == {
        "serve": 1, "nn.bn_fold": 4}
