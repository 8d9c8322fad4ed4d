"""Tensor and sequence parallelism of the port (gifgan_tpu_torch/parallel/
tp.py, sp.py, the layers' forms in ops/nn.py and the models, and the
train-vid flags) on a 4-rank gloo process group on the CPU, against the
JAX package's single-device step and against the port's one-process step.

One module-scoped fixture starts the four ranks once
(tests/torch_tp_sp_ranks.py runs every case and each rank writes its
results) and, while they run, compiles the two JAX reference steps; the
tests compare. Inputs come from numpy seeds; the states have std-0.2
weights and warm Adam slots (torch_parallel_ranks.warm_flat). The mesh
steps take one G update each (gen_updates=1): a second G update starts
from the first update's float32 rounding, which the vid-G's Adam slots
amplify past these tolerances even between two one-process runs that
differ only in their intra-op thread count; tests/test_torch_parallel.py
covers gen_updates=2 on the data axis.

Tolerances, each with its reason:
- a layer on 2 model ranks against one process: 1e-6 of each tensor's
  largest |value| (its forward, input gradient and weight-block gradient:
  the same products summed in another order);
- a mesh step against one process of the port: 1e-5 of each array's
  largest |value| (at least 1), as tests/test_torch_parallel.py: the
  losses, metrics, weights and BN moments; the Adam slots (the step's
  gradients) 3e-4, since the vid-G's gradient sums B*T rows through three
  BNs whose backward cancels terms far larger than the result (a pre-BN
  bias's true gradient is 0), so the order of the rank blocks' sums moves
  it by float32 rounding of those terms;
- against the JAX package: the pre-update losses and activation stds
  within 1e-5 relative, the post-update losses and parameters within
  1e-3 + 1e-3*|a|, the tolerance the JAX tests allow their own layouts
  (tests/test_sp.py _assert_losses_match, tests/test_sharding.py).
"""

import json
import os
import shlex
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_tp_sp_ranks as R
from gifgan_tpu.core import checkpoint as jckpt
from gifgan_tpu.core.config import DCGANConfig, TrainConfig, VidGANConfig
from gifgan_tpu.core.mesh import make_mesh as jmake_mesh
from gifgan_tpu.parallel.tp import vid_state_tp_shardings as jtp_shardings
from gifgan_tpu.train import vid as jvid
from gifgan_tpu_torch import cli
from gifgan_tpu_torch.core import checkpoint as ckpt
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core.mesh import make_mesh
from gifgan_tpu_torch.core.tree import flatten
from gifgan_tpu_torch.data.device import DeviceCorpus
from gifgan_tpu_torch.parallel import tp
from gifgan_tpu_torch.train import vid
from test_torch_parallel import _jax_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, RANKS_TIMEOUT_S = 4, 300
TOL, SLOT_TOL, LAYER_TOL = 1e-5, 3e-4, 1e-6
JAX_PRE, JAX_POST = 1e-5, 1e-3
PRE_UPDATE = ("d_loss", "d_loss_real", "d_loss_fake", "images_std",
              "real_activation_std", "fake_activation_std")
MESH_CASES = [(m, c) for m in R.MESHES for c in ("step", "chunk")] + [
    ("dp1_sp4_T64", "step")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the ranks run (tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the four ranks and, while they run, the JAX references;
    returns (results by rank, workdir, JAX references)."""
    work = tmp_path_factory.mktemp("tp_sp")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_tp_sp_ranks.py"),
         str(r), str(WORLD), str(port), str(work)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    # the CLI as a user runs it: `python -m gifgan_tpu_torch train-vid`
    # under torch.distributed.run, one process a rank; the first command
    # again with 2 more steps resumes from its last checkpoint
    run = lambda name, flags, corpus, steps: shlex.join(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), "-m", "gifgan_tpu_torch"]
        + R.cli_argv(str(work / name), flags, corpus)
        + ["--steps-limit", str(steps)])
    (first, (flags, corpus)), *rest = R.CLI.items()
    cmds = [run(first, flags, corpus, R.CLI_STEPS) + " && "
            + run(first, flags, corpus, R.CLI_STEPS + 2)]
    cmds += [run(n, f, c, R.CLI_STEPS) for n, (f, c) in rest]
    procs += [subprocess.Popen(["bash", "-c", c], env=env, cwd=work,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for c in cmds]
    logs = []
    try:
        reference = {t: _jax_steps(t, b) for t, b in
                     ((R.VID["vid_length"], R.B), (R.LONG_T, 1))}
        for p in procs:
            logs.append(p.communicate(timeout=RANKS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return ([torch.load(work / f"results{r}.pt", weights_only=False)
             for r in range(WORLD)], work, reference)


def _jax_cfgs(t, b):
    jc = VidGANConfig(image_gan=DCGANConfig(**R.IMG),
                      **dict(R.VID, vid_length=t))
    return jc, TrainConfig(batch_size=b, gen_updates=1)


def _jax_steps(t, b):
    """The JAX single-device train_step, K steps from the warm state at
    noise 0 with the knobs' D-lr scale: [(metrics, flat state)] a step."""
    x = R.inputs(t, b)
    jc, jt = _jax_cfgs(t, b)
    ts, out = _jax_state(x["vid_flat"]), []
    for i in range(R.K if t == R.VID["vid_length"] else 1):
        ts, m = jvid.train_step(ts, x["frames"][i], x["z"][i],
                                jax.random.PRNGKey(0), jc, jt,
                                jvid.make_knobs(jc, 0.0, 0.0, 0.5))
        flat = jckpt._flatten_with_paths(jax.device_get(ts._asdict()))
        tree = interop.from_jax_flat(
            {k.replace("/0/", "/", 1) if k.startswith("opt_") else k:
             np.asarray(v) for k, v in flat.items()}, "cpu")
        out.append(({k: float(np.asarray(v)) for k, v in m.items()},
                    _np(tree)))
    return out


def _np(tree) -> dict:
    return {k: v.detach().numpy() for k, v in flatten(tree).items()
            if isinstance(v, torch.Tensor)}


def _one_process(t, b, steps, gen=None, noise=0.0):
    """The port's one-process train_step x steps: ([metrics], flat)."""
    cfg, tcfg = R.cfgs(t, b)
    x = R.inputs(t, b)
    ts, ms = R.vid_state(x["vid_flat"]), []
    for i in range(steps):
        ts, m = vid.train_step(ts, torch.from_numpy(x["frames"][i]),
                               torch.from_numpy(x["z"][i]), gen, cfg, tcfg,
                               R.knobs(cfg, noise))
        ms.append({k: v.numpy() for k, v in m.items()})
    return ms, _np(ts)


def _scaled(got, want, tol, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _by_step(metrics, case):
    if case == "step":
        return [metrics]
    return [{k: v[i] for k, v in metrics.items()} for i in range(R.K)]


def _block(a, index, dim):
    a = np.asarray(a)
    n = a.shape[dim] // 2
    return np.take(a, range(index * n, (index + 1) * n), axis=dim)


@pytest.mark.parametrize("name", list(R.LAYERS))
def test_tp_layer_matches_one_process(ranks, name):
    """Each layer's tensor-parallel form on the 2 ranks of a model axis,
    with this rank's block of the whole weight, against the one-process
    layer on the whole weight, L = sum(y * r): the forward, dL/dx and the
    weight block's and bias's (gamma's, beta's) gradients within 1e-6 of
    each tensor's largest value; a column-parallel layer's output and a
    sharded input's gradient are this rank's channel block. BN's new
    running moments are whole and equal on both model ranks. These decide
    each gather's backward (parallel/collectives.py gather_model)."""
    y, gx, gp, state = R.run_layer(name, False)
    layer = R.LAYERS[name][0]
    wdim = 0 if layer in ("conv2d", "conv3d", "deconv2d") else 1
    for res in ranks[0]:
        ty, tgx, tgp, tstate = res["layers"][name]
        i = res["model_index"]
        fit = lambda got, want, d: (want if got.shape == want.shape
                                    else _block(want, i, d))
        for what, got, want in [("y", ty, fit(ty, y, -1)),
                                ("dx", tgx, fit(tgx, gx, -1))] + [
                (k, tgp[k], fit(tgp[k], v, wdim)) for k, v in gp.items()]:
            want = np.asarray(want, np.float64)
            np.testing.assert_allclose(
                got, want, rtol=0, atol=LAYER_TOL * np.abs(want).max(),
                err_msg=what)
        assert (ty.shape != y.shape) == (layer not in ("deconv2d",)), name
        for k, v in state.items():
            np.testing.assert_allclose(tstate[k], v, rtol=0,
                                       atol=LAYER_TOL * np.abs(v).max())
            np.testing.assert_array_equal(
                tstate[k], ranks[0][0]["layers"][name][3][k])


def test_dcgan_on_tp_params_matches_one_process(ranks):
    """shard_dcgan_params_tp on the dp2 x tp2 mesh: each rank holds its
    block of every split weight (the out-channels of the convs and h0_lin,
    the in-channels of the deconvs; the 1-wide h3_lin whole), and the
    image generator's samples and the discriminator's logits and h2 tap on
    them, through the layers' tensor-parallel forms, equal the one-process
    nets' within 1e-6 of each array's largest value."""
    x, logits, tap, shapes = R.dcgan_tp()
    for res in ranks[0]:
        gx, glogits, gtap, local = res["dcgan"]
        for got, want in ((gx, x), (glogits, logits), (gtap, tap)):
            np.testing.assert_allclose(got, want, rtol=0, atol=LAYER_TOL
                                       * np.abs(want).max())
        halved = {k for k in shapes if local[k] != shapes[k]}
        assert halved == {k for k in shapes if k.endswith("/w")
                          and "h3_lin" not in k}, halved


@pytest.mark.parametrize("mesh,case", MESH_CASES)
def test_mesh_step_matches_jax(ranks, mesh, case):
    """Each mesh's train_step, and its train_chunk (batch_axis=1, K = 2),
    both with live knobs (pass_knobs; noise 0, the D update at half rate),
    against the JAX package's single-device train_step from the same
    params: the pre-update losses and activation stds within 1e-5
    relative, the post-update losses and every parameter within
    1e-3 + 1e-3*|a|."""
    res, _, ref = ranks
    t = R.LONG_T if mesh.endswith("T64") else R.VID["vid_length"]
    metrics, flat = res[0][mesh][case]
    steps = _by_step(metrics, case)
    for i, m in enumerate(steps):
        want_m, _ = ref[t][i]
        for k, w in want_m.items():
            tol = JAX_PRE if (i == 0 and k in PRE_UPDATE) else JAX_POST
            assert abs(float(m[k]) - w) <= tol + tol * abs(w), (i, k, m[k], w)
    _, want = ref[t][len(steps) - 1]
    assert sorted(flat) == sorted(want)
    for k, w in want.items():
        if k.startswith("params/"):
            np.testing.assert_allclose(flat[k], w, rtol=JAX_POST,
                                       atol=JAX_POST, err_msg=k)


@pytest.mark.parametrize("mesh,case", [
    (m, c) for m in R.MESHES for c in ("step", "chunk", "chunk_noise")] + [
    ("dp1_sp4_T64", "step")])
def test_mesh_step_matches_one_process(ranks, mesh, case):
    """The same runs against the port's one-process steps on the same
    inputs: losses, metrics, weights and BN moments within 1e-5 of each
    array's largest value, the Adam slots within 3e-4 (module docstring),
    the counts and step equal. With noise on (chunk_noise), each rank
    keeps its rows of the one global draw."""
    t, b = (R.LONG_T, 1) if mesh.endswith("T64") else (
        R.VID["vid_length"], R.B)
    gen = torch.Generator().manual_seed(5) if case == "chunk_noise" else None
    want_ms, want = _one_process(t, b, 1 if case == "step" else R.K, gen,
                                 R.KNOB_NOISE if gen else 0.0)
    metrics, flat = ranks[0][0][mesh][case]
    for got, w in zip(_by_step(metrics, case), want_ms):
        for k in w:
            _scaled(got[k], w[k], TOL, k)
    assert sorted(flat) == sorted(want)
    for k, w in want.items():
        if w.dtype.kind != "f":
            np.testing.assert_array_equal(flat[k], w, err_msg=k)
        else:
            _scaled(flat[k], w, SLOT_TOL if k.startswith("opt_") else TOL,
                    k)


@pytest.mark.parametrize("full", [False, True])
def test_tp_placement_matches_jax(ranks, full):
    """vid_state_tp_shardings against the JAX package's on a dp2 x tp2
    mesh: every leaf split on the port dim that the JAX spec's `model`
    axis maps to through core/interop.py, or replicated in both; six or
    more opt_d slot leaves split in the full layout (none in the other);
    each rank's placed leaves have those blocks' shapes."""
    x = R.inputs()
    ts = R.vid_state(x["vid_flat"])
    got = flatten(tp.vid_state_tp_shardings(
        make_mesh(list(range(4)), data_parallel=2, model_parallel=2), ts,
        full))
    jmesh = jmake_mesh(jax.devices()[:4], data_parallel=2,
                       model_parallel=2)
    jts = _jax_state(x["vid_flat"])
    want = {"/".join(jckpt._path_str(p) for p in path): sh
            for path, sh in jax.tree_util.tree_flatten_with_path(
                jtp_shardings(jmesh, jts, full)._asdict(),
                is_leaf=lambda v: isinstance(v, NamedSharding))[0]}
    shapes = {k: v.shape for k, v in flatten(ts).items()}
    split = 0
    for jkey, sh in want.items():
        key = jkey.replace("/0/", "/", 1) if jkey.startswith("opt_") else jkey
        if key not in got:
            assert jkey.startswith("opt_") and jkey.endswith("/1"), jkey
            continue
        spec = tuple(sh.spec)
        jdims = [d for d, a in enumerate(spec) if a == "model"]
        _, port_dim = interop.jax_shape(key, shapes[key])
        assert got[key].dim == (port_dim[jdims[0]] if jdims else None), key
        split += key.startswith("opt_d/") and got[key].dim is not None
    assert (split >= 6) if full else split == 0, split
    local = ranks[0][0]["dp2_tp2_full" if full else "dp2_tp2"]["local_shapes"]
    for k, sh in got.items():
        want_shape = list(shapes[k])
        if sh.dim is not None:
            want_shape[sh.dim] //= 2
        assert local[k] == tuple(want_shape), k


def test_tp_step_gathers_no_weight_over_model(ranks):
    """In the tensor-parallel steps and chunks no collective over `model`
    all-gathers a tensor of a split weight's block shape (a weight gather
    would be FSDP over `model`); the model axis's byte counter shows the
    activations' all-gathers, all-reduces and reduce-scatters."""
    ts = R.vid_state(R.inputs()["vid_flat"])
    for mesh in ("dp2_tp2", "dp2_tp2_full", "dp1_sp2_tp2"):
        d, s, m, full = R.MESHES[mesh]
        sh = flatten(tp.vid_state_tp_shardings(make_mesh(
            list(range(4)), data_parallel=d, seq_parallel=s,
            model_parallel=m), ts, full))
        blocks = set()
        for k, v in flatten(ts).items():
            if sh[k].dim is not None and k.startswith("params/"):
                shape = list(v.shape)
                shape[sh[k].dim] //= m
                blocks.add(tuple(shape))
        for res in ranks[0]:
            calls = res[mesh]["model_calls"]
            gathered = {shape for kind, shape in calls if kind == "all_gather"}
            assert gathered and not gathered & blocks, (mesh, gathered)
            kinds = res[mesh]["bytes"]["model"]
            assert all(kinds.get(k, 0) > 0 for k in
                       ("all_gather", "all_reduce", "reduce_scatter")), kinds


def test_sp_placement_time_slices(ranks):
    """shard_vid_batch on the dp2 x sp2 and dp1 x sp4 meshes: a rank holds
    the contiguous rows of its (data, seq) block (b-major/t-minor: a
    time slice of one clip), z its data block's clips; its rows gathered
    over `seq` are its clips' frames whole (vid_d_sharding)."""
    x = R.inputs()
    frames, z = x["frames"][0], x["z"][0]
    for mesh in ("dp2_sp2", "dp1_sp4"):
        d, s, _, _ = R.MESHES[mesh]
        n, nz = frames.shape[0] // (d * s), z.shape[0] // d
        for r, res in enumerate(ranks[0]):
            f_s, z_s, wall = res[mesh]["placed"]
            np.testing.assert_array_equal(f_s, frames[r * n:(r + 1) * n])
            np.testing.assert_array_equal(z_s, z[(r // s) * nz:
                                                 (r // s + 1) * nz])
            assert wall


def test_tp_checkpoint_restores_in_one_process_and_in_jax(ranks):
    """The dp2 x tp2 (full) chunk's checkpoint, written by rank 0 from the
    gathered state: one step directory, which restores in one process to
    the state the chunk ended with, and which JAX `restore` reads leaf for
    leaf."""
    ckpt_dir = str(ranks[1] / "tp_ckpt")
    assert ckpt.all_steps(ckpt_dir) == [R.K]
    cfg, tcfg = R.cfgs()
    fresh = vid.init_train_state(torch.Generator().manual_seed(9), cfg,
                                 tcfg, device="cpu")
    _, want = ranks[0][0]["dp2_tp2_full"]["chunk"]
    got = _np(ckpt.restore(ckpt_dir, fresh))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    jc, jt = _jax_cfgs(R.VID["vid_length"], R.B)
    shapes = jax.eval_shape(lambda: jvid.init_train_state(
        jax.random.PRNGKey(1), jc, jt))
    target = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                    shapes._asdict())
    jgot = jckpt._flatten_with_paths(jckpt.restore(ckpt_dir, target))
    files = ckpt.load_flat(ckpt_dir)
    assert sorted(jgot) == sorted(files)
    for k, v in files.items():
        np.testing.assert_array_equal(np.asarray(jgot[k]), v, err_msg=k)


def test_device_corpus_on_seq_model_mesh(ranks):
    """DeviceCorpus(mesh=) on the dp1 x sp2 x tp2 mesh: every rank samples
    all the ids' clips (one data index), in a sequence-parallel step
    fold_sample_fn gives each rank its seq block of their frames (the
    blocks gathered are the one-process fold), and train_chunk_ids
    through make_sp_step(folded=False) matches the one-process chunk."""
    x = R.inputs()
    corpus = DeviceCorpus(R.clips(), device="cpu")
    ids = torch.from_numpy(x["ids"])
    whole = corpus.sample(ids).numpy()
    fold = corpus.fold_sample_fn(corpus.data, ids[0]).numpy()
    cfg, tcfg = R.cfgs()
    ts, m = vid.train_chunk_ids(R.vid_state(x["vid_flat"]), ids,
                                torch.from_numpy(x["z"]), None, corpus.data,
                                cfg, tcfg, corpus.fold_sample_fn,
                                knobs=R.knobs(cfg))
    want = _np(ts)
    for res in ranks[0]:
        got = res["corpus"]
        np.testing.assert_array_equal(got["sample"], whole)
        assert got["fold_rows"] * 2 == fold.shape[0]
        np.testing.assert_array_equal(got["fold"], fold)
        gm, flat = got["chunk_ids"]
        for k, v in m.items():
            _scaled(gm[k], v.numpy(), TOL, k)
        for k, w in want.items():
            _scaled(flat[k], w, SLOT_TOL if k.startswith("opt_") else TOL,
                    k)


def _records(run_dir):
    with open(os.path.join(run_dir, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f if '"auto_' not in line]


@pytest.mark.parametrize("name", list(R.CLI))
def test_cli_train_vid_tensor_and_seq_parallel(ranks, tmp_path, name):
    """`python -m gifgan_tpu_torch train-vid --tensor-parallel 2`
    (--device-corpus) and `--seq-parallel 2` (host clips), --chunk 1
    --auto-intervene --steps-limit 4 --device cpu, under
    torch.distributed.run on 4 ranks (the data axis takes the other 2):
    the loops refuse neither axis, and rank 0 alone
    writes (one metrics record a step, params.json, the checkpoints and
    grids), every step's images_std is one process's, and the first
    step's losses are within 1e-4 of one process's (the gate of
    chip_smoke.py's mesh phases; later steps part as free GAN runs do
    from fresh Adam slots, chip_smoke.py MESH_CLI_TOL). The tensor-
    parallel run, started again with 2 more steps, resumes from its
    step-4 checkpoint (the whole tree, placed again) and trains steps 5
    and 6."""
    flags, corpus = R.CLI[name]
    run = ranks[1] / name
    got = _records(run)
    resumed = name == next(iter(R.CLI))
    assert [r["step"] for r in got] == [1, 2, 3, 4] + (
        [5, 6] if resumed else [])
    assert os.path.exists(run / "params.json")
    assert ckpt.all_steps(str(run / "checkpoints"))[:2] == [2, 4]
    gifs = lambda d: sorted(p for p in os.listdir(d) if p.endswith(".gif"))
    assert len(gifs(run)) == 4 + 2 * resumed
    if resumed:
        assert ckpt.all_steps(str(run / "checkpoints"))[-1] == 6
        got = got[:4]
    cli.main(R.cli_argv(str(tmp_path / "one"), [], corpus))
    assert set(gifs(tmp_path / "one")) <= set(gifs(run))
    want = _records(tmp_path / "one")
    assert [r["step"] for r in want] == [1, 2, 3, 4]
    for g, w in zip(got, want):
        assert abs(g["images_std"] - w["images_std"]) <= 1e-6, (g, w)
    for k in ("d_loss", "d_loss_real", "d_loss_fake", "g_loss",
              "first_frame_loss"):
        assert abs(got[0][k] - want[0][k]) <= 1e-4, (k, got[0], want[0])
