"""The trace reduction and the metric readers on a hand-made capture."""

import pytest

from benchmark import run as R
from benchmark import trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _x("bench.step", "user_annotation", 0, 100),
    _x("bench.step", "user_annotation", 100, 100),
    _x("bench.step", "gpu_user_annotation", 10, 40),   # the device's copy
    _x("sm90_xmma_fprop_implicit_gemm_bf16", "kernel", 10, 20),
    _x("vectorized_elementwise_kernel<4, add>", "kernel", 40, 10),
    _x("gather_rows_scaled_u8_kernel", "kernel", 120, 10),
    _x("Memcpy DtoH", "gpu_memcpy", 195, 2),
    _x("late_kernel", "kernel", 250, 10),           # after the window
    _x("aten::add", "cpu_op", 30, 15),
    _x("cudaLaunchKernel", "cuda_runtime", 50, 10),
]


def test_reduce():
    out = trace.reduce(EVENTS)
    assert out["window_s"] == pytest.approx(200e-6)
    assert out["busy_s"] == pytest.approx(42e-6)
    assert out["steps"] == 2 and out["kernel_rows"] == 3
    assert out["by_category_s"] == pytest.approx(
        {"convolution": 20e-6, "elementwise": 10e-6,
         "gather_rows_scaled": 10e-6, "copy": 2e-6})
    assert out["kernel_s"] == pytest.approx({"gather_rows_scaled": 10e-6})
    gaps = dict(out["idle_gaps"])
    # [0,10], [50,120], [130,195] and [197,200] under no host event but
    # the step; [30,40] under aten::add
    assert gaps == pytest.approx({"bench.step": 148e-6, "aten::add": 10e-6})


def test_readers():
    tr = trace.reduce(EVENTS)
    tr["work"] = {"gather_rows_scaled": {"bytes": 3.35e12 * 5e-6}}
    run = {"setup_s": 12.5, "window_s": 2.0, "steps": 10, "items": 2560,
           "dispatch_s": [0.05, 0.07], "flops": 13.2e12 * 10,
           "peak_flops_per_s": 989e12, "trace": tr}
    read = lambda name: R.load("metrics", name).read(run)
    assert read("train_clips_per_s") == 1280.0
    assert read("setup_s") == 12.5
    assert read("train_mfu") == pytest.approx(100 * 13.2e12 * 10
                                              / (2.0 * 989e12))
    assert read("host_dispatch_ms_per_step.train") == pytest.approx(60.0)
    assert read("launches_per_step.train") == 1.5
    assert read("pointwise_ms_per_step.train") == pytest.approx(6e-3)
    assert read("conv_ms_per_step.train") == pytest.approx(10e-3)
    assert read("device_idle_pct.train") == pytest.approx(79.0)
    assert read("k1_roofline") == pytest.approx(50.0)
    run["trace"] = None
    assert read("launches_per_step.train") is None
    assert read("k1_roofline") is None
