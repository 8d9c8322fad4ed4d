"""gifgan_tpu_torch/bench.py against the repo-root bench.py (the JAX
package's benchmark): the flagship configs field for field, the emitted
line, a tiny CPU run and the `bench` command's wiring."""

import dataclasses
import importlib.util
import json
import math
import os

import pytest
import torch

from gifgan_tpu_torch import bench, cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_reference", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("packed", [None, "0", "1"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flagship_equals_the_jax_bench(jax_bench, monkeypatch, packed,
                                       dtype):
    if packed is None:
        monkeypatch.delenv("GIFGAN_PACKED_C3", raising=False)
    else:
        monkeypatch.setenv("GIFGAN_PACKED_C3", packed)
    got = [dataclasses.asdict(c) for c in bench._flagship(dtype)]
    want = [dataclasses.asdict(c) for c in jax_bench._flagship(dtype)]
    assert got == want
    assert got[0]["image_gan"]["packed_c3"] is (packed != "0")


def test_emit_prints_the_jax_line(jax_bench, capsys):
    jax_bench._emit(12.345678)
    want = json.loads(capsys.readouterr().out)
    bench._emit(12.345678)
    out = capsys.readouterr().out
    assert out.count("\n") == 1
    got = json.loads(out)
    assert set(got) == set(want) - {"vs_baseline"}
    assert got["metric"] == want["metric"] == bench.METRIC
    assert (got["value"], got["unit"]) == (want["value"], want["unit"])
    assert got["compile_cache"] == "none"


def test_run_bench_on_the_cpu():
    v = bench.run_bench(device="cpu", batch_size=2, chunk=1, steps=1,
                        warmup=1, dtype="float32")
    assert math.isfinite(v) and v > 0


def test_bench_command_runs_bench_main(monkeypatch, capsys):
    """`bench --device D` hands D to run_bench and prints its line last."""
    seen = []
    monkeypatch.setattr(bench, "run_bench",
                        lambda **kw: seen.append(kw) or 2.5)
    assert cli.main(["bench", "--device", "cpu"]) == 0
    assert cli.main(["bench"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert seen == [{"device": "cpu"}, {"device": None}]
    assert len(lines) == 2
    for line in lines:
        out = json.loads(line)
        assert out["metric"] == bench.METRIC and out["value"] == 2.5
