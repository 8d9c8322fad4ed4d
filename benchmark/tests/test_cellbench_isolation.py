"""What the benchmark may import, and that a cell, a traffic mix and a
metric added as new files are found and run by name."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
JAX_NAMES = {"jax", "jaxlib", "flax", "gifgan_tpu"}


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported_tops(path):
    """Top-level names of every module the file imports, whole."""
    tree = ast.parse(open(path).read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_whole_names(tmp_path):
    """gifgan_tpu_torch begins with gifgan_tpu: only whole names count."""
    path = tmp_path / "probe.py"
    path.write_text("import gifgan_tpu_torch.x\n"
                    "from gifgan_tpu_torch import y\nimport jax.numpy\n")
    assert _imported_tops(str(path)) == {"gifgan_tpu_torch", "jax"}


@pytest.mark.parametrize("path", sorted(_sources(BENCH)))
def test_no_jax(path):
    assert not _imported_tops(path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted(_sources(
    os.path.join(BENCH, "reference"))))
def test_reference_imports_no_program(path):
    assert "gifgan_tpu_torch" not in _imported_tops(path)


def test_reference_loads_alone():
    """Importing the references loads neither the program nor JAX."""
    code = ("import sys; import benchmark.reference.vid_dcgan_flagship; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gifgan_tpu_torch', 'gifgan_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True).stdout
    assert out.strip() == "[]"


def test_new_files_found_by_name(tmp_path):
    """A copy of the benchmark with a new configuration, traffic mix, cell
    and per-layer metric, added as files and BENCHMARK.json entries only,
    runs the new cell on the CPU and reports the new metric."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b = tmp_path / "benchmark"
    cfg = json.load(open(b / "configs" / "vid_dcgan_flagship.json"))
    cfg["image_gan"].update(output_size=32, gf_dim=8, df_dim=8, z_dim=16)
    cfg.update(z_input_size=20, z_output_size=16, vid_length=4,
               hidden_dim=32, d_filters=16, compute_dtype="float32")
    (b / "configs" / "tiny_vid.json").write_text(json.dumps(cfg))
    for kind in ("reference", "flops"):
        (b / kind / "tiny_vid.py").write_text(
            f"from benchmark.{kind}.vid_dcgan_flagship import *  # noqa\n")
    (b / "traffic" / "tiny_clips.json").write_text(json.dumps(
        {"generator": "clips", "corpus_clips": 16, "clip_frames": 4,
         "frame": [32, 32, 3], "batch_size": 4, "z_dim": 20}))
    wl = json.load(open(b / "workloads" / "vid_train_corpus_b256.json"))
    (b / "workloads" / "tiny_cell.json").write_text(json.dumps(wl))
    (b / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return run['steps']\n")
    bench["configs"].append({"name": "tiny_vid", "source": "test",
                             "file": "benchmark/configs/tiny_vid.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_cell", "config": "tiny_vid",
                               "traffic": "tiny_clips", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "steps_in_window", "unit": "steps",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from benchmark import run as R; "
            "assert R.HERE.startswith(sys.argv[1]); "
            "print(json.dumps(R.run_cell(R.cell_spec('tiny_cell'), 7, 0.2, "
            "False, 'cpu')))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), ROOT],
                         cwd=tmp_path, text=True, capture_output=True,
                         check=True, env=dict(os.environ,
                                              OMP_NUM_THREADS="2"))
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"train_clips_per_s", "setup_s",
                                      "steps_in_window"}
    assert result["metrics"]["steps_in_window"]["value"] == result[
        "attempted"]


def test_cli_without_card_prints_nothing():
    """Without CUDA the command refuses before it makes anything."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", "vid_train_corpus_b256", "--seed",
                          str(2 ** 33 + 5), "--seconds", "1"], cwd=ROOT,
                         text=True, capture_output=True)
    assert out.returncode != 0 and out.stdout == ""
