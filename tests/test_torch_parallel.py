"""The port's mesh paths (gifgan_tpu_torch/parallel/, core/mesh.py and the
mesh arguments of the loops, the corpus, the samplers, inversion and the
CLI) on a 2-rank gloo process group on the CPU, against the JAX package's
sharded step on 2 of the conftest's virtual devices and against the port's
one-process run.

One module-scoped fixture starts the two ranks once
(tests/torch_parallel_ranks.py runs every case and rank 0 writes the
results); the tests compare. Inputs come from numpy seeds; the states have
std-0.2 weights and warm Adam slots (torch_parallel_ranks.warm_flat), so a
step's update follows its gradient.

Tolerances, each with its reason:
- 2 ranks against one process of the port: 1e-5 (float32): the same
  arithmetic, but each rank sums its rows and the all-reduce adds the two
  partial sums, in another order than one process's sum;
- against the JAX package's sharded chunk: 1e-5 of each array's largest
  |value| (at least 1), the same float32 arithmetic in other accumulation
  orders (a BN variance of ~1e2 carries rounding of ~1e-5 of itself);
- inversion: 1e-4, the inversion tolerance of tests/test_torch_invert.py.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_ranks as R
from gifgan_tpu.core import checkpoint as jckpt
from gifgan_tpu.core.config import DCGANConfig, TrainConfig, VidGANConfig
from gifgan_tpu.core.mesh import make_mesh as jmake_mesh
from gifgan_tpu.data.device import DeviceCorpus as JDeviceCorpus
from gifgan_tpu.models import vid_dcgan as jvid_dcgan
from gifgan_tpu.parallel.dp import make_sharded_step as jmake_sharded_step
from gifgan_tpu.train import vid as jvid
from gifgan_tpu_torch import cli
from gifgan_tpu_torch.core import checkpoint as ckpt
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core.tree import flatten
from gifgan_tpu_torch.invert.optimize import image_problem, invert
from gifgan_tpu_torch.serve.sampler import vid_sample_fn, vid_sample_fn_q
from gifgan_tpu_torch.train import gan, vid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, RANKS_TIMEOUT_S = 2, 240
TOL = 1e-5


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
    """Start the two ranks and, while they run, compile and run the JAX
    reference chunk; returns (results, workdir, JAX chunk)."""
    work = tmp_path_factory.mktemp("ranks")
    z0 = jax.random.uniform(jax.random.PRNGKey(0), (R.B, 12), minval=-1.0,
                            maxval=1.0)
    np.savez(work / "jax_inputs.npz", inv_z0=np.asarray(z0))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_parallel_ranks.py"),
         str(r), str(WORLD), str(port), str(work)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        reference = _jax_chunk()
        for p in procs:
            logs.append(p.communicate(timeout=RANKS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return (torch.load(work / "results.pt", weights_only=False), work,
            reference)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _close_trees(got: dict, want: dict, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], tol, k)


def _np(tree) -> dict:
    return {k: v.detach().numpy() for k, v in flatten(tree).items()
            if isinstance(v, torch.Tensor)}


def _one_process_vid(x, n_steps, gen=None, noise=0.0):
    """The port's one-process train_step x n_steps from the warm state."""
    cfg, tcfg, _ = R.cfgs()
    ts, ms = R.vid_state(x["vid_flat"]), []
    for i in range(n_steps):
        ts, m = vid.train_step(ts, torch.from_numpy(x["frames"][i]),
                               torch.from_numpy(x["z"][i]), gen, cfg, tcfg,
                               R.knobs(cfg, noise))
        ms.append({k: v.numpy() for k, v in m.items()})
    return ms, _np(ts)


def _jax_state(flat):
    tree = {}
    for k, v in flat.items():
        *ps, last = k.split("/")
        node = tree
        for p in ps:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(v)
    return jvid.VidTrainState(
        params=jvid_dcgan.VidGANParams(**tree["params"]),
        state=jvid_dcgan.VidGANState(**tree["state"]),
        opt_g=(optax.ScaleByAdamState(**tree["opt_g"]["0"]),
               optax.EmptyState()),
        opt_d=(optax.ScaleByAdamState(**tree["opt_d"]["0"]),
               optax.EmptyState()),
        step=tree["step"])


@pytest.fixture(scope="module")
def jax_chunk(ranks):
    return ranks[2]


def _jax_chunk():
    """JAX make_sharded_step(train_chunk, batch_axis=1, pass_knobs=True)
    on a 2-device mesh, K steps at noise 0 with the knobs' D-lr scale: the
    module's one JAX train-step compile."""
    x = R.inputs()
    img = DCGANConfig(**R.IMG)
    jc = VidGANConfig(image_gan=img, **R.VID)
    jt = TrainConfig(batch_size=R.B, gen_updates=2)
    mesh = jmake_mesh(jax.devices()[:WORLD], data_parallel=WORLD)
    step = jmake_sharded_step(jvid.train_chunk, mesh,
                              static_args={"cfg": jc, "tcfg": jt},
                              batch_axis=1, pass_knobs=True)
    ts, m = step(_jax_state(x["vid_flat"]), x["frames"], x["z"],
                 jax.random.PRNGKey(0), jvid.make_knobs(jc, 0.0, 0.0, 0.5))
    flat = {k: np.asarray(v) for k, v in
            jckpt._flatten_with_paths(jax.device_get(ts._asdict())).items()}
    return {k: np.asarray(v) for k, v in m.items()}, flat


def _against_jax(metrics_by_step, port_flat, jax_chunk):
    want_m, want_flat = jax_chunk
    for k, w in want_m.items():
        got = np.array([float(m[k]) for m in metrics_by_step])
        _close_scaled(got, w, k)
    tree = interop.from_jax_flat({k.replace("/0/", "/", 1)
                                  if k.startswith("opt_") else k: v
                                  for k, v in want_flat.items()}, "cpu")
    want = _np(tree)
    assert sorted(port_flat) == sorted(want)
    for k, w in want.items():
        if k.endswith("count") or k == "step":
            np.testing.assert_array_equal(port_flat[k], w, err_msg=k)
        else:
            _close_scaled(port_flat[k], w, k)


def _close_scaled(got, want, what):
    """Within TOL of the array's largest |value| (at least 1): a BN
    variance of ~1e2 carries float32 rounding of ~1e-5 of itself."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("path", ["steps", "chunk"])
def test_dp_vid_step_matches_jax_sharded_chunk(ranks, jax_chunk, path):
    """Two train_steps, and one train_chunk (K=2, pass_knobs), on 2 ranks
    against JAX make_sharded_step(train_chunk) on 2 devices: losses,
    metrics, every parameter and BN moment, the Adam counts."""
    res = ranks[0]
    if path == "steps":
        ms, flat = res["dp_steps"]
    else:
        m, flat = res["dp_chunk"]
        ms = [{k: v[i] for k, v in m.items()} for i in range(R.K)]
    _against_jax(ms, flat, jax_chunk)


@pytest.mark.parametrize("case", ["steps", "chunk", "chunk_noise"])
def test_dp_vid_matches_one_process(ranks, case):
    """The same runs against the port's one-process steps at 1e-5: losses,
    metrics and every leaf of the state. With noise on, each rank keeps its
    rows of the one draw (parallel/collectives.py randn_like_rows)."""
    res, x = ranks[0], R.inputs()
    gen = torch.Generator().manual_seed(5) if case == "chunk_noise" else None
    want_ms, want = _one_process_vid(x, R.K, gen,
                                     R.KNOB_NOISE if gen else 0.0)
    if case == "steps":
        ms, flat = res["dp_steps"]
    else:
        m, flat = res["dp_chunk" if case == "chunk" else "dp_chunk_noise"]
        ms = [{k: v[i] for k, v in m.items()} for i in range(R.K)]
    for got, w in zip(ms, want_ms):
        _close_trees(got, w, TOL)
    _close_trees(flat, want, TOL)


def test_fsdp_vid_step_matches_dp(ranks):
    """FSDP (min_size 256): the state is really split (each sharded leaf
    holds half its dim on a rank), and two steps give the DP run's losses,
    metrics and state."""
    res = ranks[0]
    cfg, tcfg, _ = R.cfgs()
    full = _np(R.vid_state(R.inputs()["vid_flat"]))
    local = res["fsdp_local_shapes"]
    halved = [k for k in full if local[k] != full[k].shape]
    assert any(k.startswith("params/img_generator") for k in halved)
    assert any(k.startswith("opt_d/mu/") for k in halved)
    for k in halved:
        assert np.prod(local[k]) * WORLD == full[k].size, k
    (ms, flat), (dms, dflat) = res["fsdp_steps"], res["dp_steps"]
    for got, w in zip(ms, dms):
        _close_trees(got, w, TOL)
    _close_trees(flat, dflat, TOL)


def test_image_dcgan_dp_step_matches_one_process(ranks):
    """The image DCGAN's step on 2 ranks, noise on, against the port's
    one-process step (which tests/test_torch_train_gan.py holds against the
    JAX package's)."""
    from gifgan_tpu_torch.core.config import DCGANConfig as TDCGAN

    x = R.inputs()
    _, tcfg, _ = R.cfgs()
    cfg = TDCGAN(**dict(R.IMG, noise_std=0.1))
    ts, m = gan.train_step(R.img_state(x["img_flat"]),
                           torch.from_numpy(x["images"]),
                           torch.from_numpy(x["img_z"]),
                           torch.Generator().manual_seed(6), cfg, tcfg)
    got_m, got = ranks[0]["img_step"]
    _close_trees(got_m, {k: v.numpy() for k, v in m.items()}, TOL)
    _close_trees(got, _np(ts), TOL)


def test_device_corpus_mesh_matches_jax(ranks):
    """DeviceCorpus(mesh=): the ranks' samples of (K, B) and (B,) ids,
    concatenated along the id axis, equal JAX DeviceCorpus(method="take",
    mesh=) byte for byte after the scale (K1 divides by 127.5 where
    PyTorch multiplies by its reciprocal: the floats part by up to 2^-23,
    tests/test_torch_gather.py); an id batch the axis does not divide is
    refused."""
    x = R.inputs()
    mesh = jmake_mesh(jax.devices()[:WORLD], data_parallel=WORLD)
    jcorpus = JDeviceCorpus(x["clips"], method="take", mesh=mesh)
    u8 = lambda a: np.rint((np.asarray(a, np.float64) + 1.0) * 127.5)
    got2, got1 = ranks[0]["corpus"]
    np.testing.assert_array_equal(
        u8(got2), u8(jcorpus.sample(x["ids"].astype(np.int32))))
    np.testing.assert_array_equal(
        u8(got1), u8(jcorpus.sample(x["ids"][0].astype(np.int32))))
    assert "must divide the id batch" in ranks[0]["corpus_refuses"]


def test_sharded_samplers_match_one_process(ranks):
    """make_sharded_sampler through vid_sample_fn(mesh=): the float sampler
    and the int8 one (dynamic scales, their max over the whole batch)
    equal one process's; a batch the axis does not divide is refused."""
    x = R.inputs()
    cfg, _, _ = R.cfgs()
    ts = R.vid_state(x["vid_flat"])
    zs = x["z"][0]
    _close(ranks[0]["sample"], vid_sample_fn(ts, cfg)(zs).numpy(), TOL)
    q, _ = vid.quantize_sampler(ts, cfg)
    _close(ranks[0]["sample_q"], vid_sample_fn_q(q, cfg)(zs).numpy(), TOL)
    assert "must divide the sampler batch" in ranks[0]["sampler_refuses"]


def test_sharded_inversion_matches_one_process(ranks):
    """invert(mesh=) from the JAX z0 against the one-process invert from
    the same z0: z, the loss history and the last progress frames within
    1e-4; an inversion batch the axis does not divide is refused."""
    cfg, params, state, targets, icfg = R.inversion_model()
    z0 = np.load(ranks[1] / "jax_inputs.npz")["inv_z0"]
    z, losses, frames = invert(image_problem(params, state, targets, cfg,
                                             icfg, "cpu"), icfg,
                               z0=torch.from_numpy(z0),
                               progress_sections=[(0, 2)])
    gz, glosses, gframes = ranks[0]["invert"]
    _close(gz, z.numpy(), 1e-4, "z")
    _close(glosses, losses, 1e-4, "losses")
    _close(gframes, frames[-1], 1e-4, "frames")
    assert "must divide the inversion batch" in ranks[0]["invert_refuses"]


def test_fsdp_checkpoint_restores_in_one_process_and_in_jax(ranks):
    """save_multihost under FSDP (AsyncCheckpointer(multihost=True) on the
    gathered state): one step directory, which restores in one process to
    the one-process run's state, and which JAX `restore` reads leaf for
    leaf."""
    ckpt_dir = str(ranks[1] / "fsdp_ckpt")
    assert ckpt.all_steps(ckpt_dir) == [R.K]
    _, want = _one_process_vid(R.inputs(), R.K)
    cfg, tcfg, _ = R.cfgs()
    fresh = vid.init_train_state(torch.Generator().manual_seed(9), cfg,
                                 tcfg, device="cpu")
    _close_trees(_np(ckpt.restore(ckpt_dir, fresh)), want, TOL)
    jc = VidGANConfig(image_gan=DCGANConfig(**R.IMG), **R.VID)
    shapes = jax.eval_shape(lambda: jvid.init_train_state(
        jax.random.PRNGKey(1), jc, TrainConfig(batch_size=R.B,
                                               gen_updates=2)))
    target = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                    shapes._asdict())
    got = jckpt._flatten_with_paths(jckpt.restore(ckpt_dir, target))
    files = ckpt.load_flat(ckpt_dir)
    assert sorted(got) == sorted(files)
    for k, v in files.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


def _records(run_dir):
    with open(os.path.join(run_dir, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_train_vid_data_parallel_fsdp(ranks, tmp_path):
    """train-vid --data-parallel 2 --fsdp --device-corpus --chunk 2
    --steps-limit 4 --device cpu in each rank: rank 0 alone writes (one
    metrics record a chunk, params.json, the checkpoints and grids), every
    chunk's images_std is one process's (the same clips in the same
    order), and the first chunk's losses are within 1e-4 of one process's
    (the gate of chip_smoke.py's mesh phase). The runs start from fresh
    Adam slots, whose first update moves a weight with a rounding-level
    gradient by a whole lr either way, so later chunks part as free GAN
    runs do (ROADMAP queue 3, DCGAN_TRAJ)."""
    run = ranks[1] / "cli_run"
    got = _records(run)
    assert [r["step"] for r in got] == [2, 4]
    assert os.path.exists(run / "params.json")
    assert ckpt.all_steps(str(run / "checkpoints")) == [2, 4]
    assert sorted(p for p in os.listdir(run) if p.endswith(".gif")) == [
        "cross_sample_00_000002.gif", "cross_sample_00_000004.gif",
        "sample_00_000002.gif", "sample_00_000004.gif"]
    cli.main(R.cli_argv(str(tmp_path / "one"), 1))
    want = _records(tmp_path / "one")
    assert [r["step"] for r in want] == [2, 4]
    for g, w in zip(got, want):
        assert abs(g["images_std"] - w["images_std"]) <= 1e-6, (g, w)
    for k in ("d_loss", "d_loss_real", "d_loss_fake", "g_loss",
              "first_frame_loss"):
        assert abs(got[0][k] - want[0][k]) <= 1e-4, (k, got[0], want[0])
