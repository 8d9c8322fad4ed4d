"""The ranks of tests/test_torch_parallel.py: one gloo process group on the
CPU runs every mesh case of the port and rank 0 writes the results.

    python tests/torch_parallel_ranks.py RANK WORLD PORT WORKDIR

The inputs are made here from numpy seeds (`inputs`), so the test process
builds the same ones for its references; WORKDIR/jax_inputs.npz holds what
only JAX can draw (inversion's z0). Imports no JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from gifgan_tpu_torch.core import checkpoint as ckpt  # noqa: E402
from gifgan_tpu_torch.core import config as tconfig  # noqa: E402
from gifgan_tpu_torch.core import interop  # noqa: E402
from gifgan_tpu_torch.core.tree import flatten  # noqa: E402

IMG = dict(output_size=32, c_dim=3, z_dim=16, gf_dim=8, df_dim=8,
           packed_c3=True)
VID = dict(z_input_size=20, z_output_size=16, vid_length=4, hidden_dim=32,
           d_filters=16, first_frame_loss_scalar=1.0)
B, K, CORPUS = 4, 2, 16
# FSDP's threshold at these widths: shards the convs, the linears and the
# larger Adam slots, leaves the BN vectors and biases replicated
FSDP_MIN = 256
# inversion: steps, rate, terms (tests/test_sharding.py's problem)
INV = dict(steps=4, learning_rate=0.1, pixel_l1=1.0, activation_l1=0.3,
           batch_size=B)
KNOB_NOISE = 0.1
CLI_STEPS = 4


def cfgs():
    img = tconfig.DCGANConfig(**IMG)
    return (tconfig.VidGANConfig(image_gan=img, **VID),
            tconfig.TrainConfig(batch_size=B, gen_updates=2), img)


def warm_flat(state, seed: int) -> dict:
    """A train state's JAX-layout flat dict with numpy values: weights of
    std 0.2 (the default init's gradients vanish at these widths), BN
    moments and Adam slots at count 3, so a step's update follows its
    gradient and not the first step's sign (tests/test_torch_train_vid.py
    builds its states alike)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in interop.to_jax_flat(state).items():
        leaf = k.rsplit("/", 1)[-1]
        if k.endswith("count"):
            x = np.full(v.shape, 3)
        elif "/mu/" in k:
            x = 1e-3 * rng.standard_normal(v.shape)
        elif "/nu/" in k:
            x = 1e-6 * (1 + rng.random(v.shape))
        elif leaf == "w":
            x = 0.2 * rng.standard_normal(v.shape)
        elif leaf in ("b", "bias", "mean"):
            x = 0.1 * rng.standard_normal(v.shape)
        elif leaf == "scale":
            x = 1 + 0.1 * rng.standard_normal(v.shape)
        elif leaf == "var":
            x = 1 + 0.2 * rng.random(v.shape)
        else:
            x = v
        out[k] = np.asarray(x, v.dtype)
    return out


def inputs() -> dict:
    """Every case's inputs, from numpy seeds."""
    from gifgan_tpu_torch.data.synthetic import synthetic_clips
    from gifgan_tpu_torch.train import gan, vid

    cfg, tcfg, img = cfgs()
    rng = np.random.default_rng(1)
    s = IMG["output_size"]
    return {
        "vid_flat": warm_flat(vid.init_train_state(
            torch.Generator().manual_seed(0), cfg, tcfg, device="cpu"), 0),
        "img_flat": warm_flat(gan.init_train_state(
            torch.Generator().manual_seed(0), img, tcfg, device="cpu"), 2),
        "frames": np.tanh(rng.standard_normal(
            (K, B * VID["vid_length"], s, s, 3))).astype(np.float32),
        "z": rng.uniform(-1, 1, (K, B, VID["z_input_size"])).astype(
            np.float32),
        "images": np.tanh(rng.standard_normal((B, s, s, 3))).astype(
            np.float32),
        "img_z": rng.uniform(-1, 1, (B, IMG["z_dim"])).astype(np.float32),
        "clips": synthetic_clips(CORPUS, length=VID["vid_length"], size=s),
        "ids": rng.integers(0, CORPUS, (K, B)).astype(np.int64),
    }


def knobs(cfg, noise: float = 0.0):
    """The collapse controller's knobs: `noise` on images and activations,
    the D update at half rate."""
    from gifgan_tpu_torch.train import vid

    return vid.make_knobs(cfg, noise, noise, 0.5, device="cpu")


def vid_state(flat):
    from gifgan_tpu_torch.train import vid

    return vid.VidTrainState.from_tree(interop.from_jax_flat(flat, "cpu"))


def img_state(flat):
    from gifgan_tpu_torch.train import gan

    return gan.TrainState.from_tree(interop.from_jax_flat(flat, "cpu"))


def inversion_model():
    """(cfg, params, state, targets, icfg): the image DCGAN at the JAX init
    scale x3 (tests/test_torch_invert.py), targets its own samples."""
    from gifgan_tpu_torch.models import dcgan

    cfg = tconfig.DCGANConfig(output_size=32, c_dim=1, z_dim=12, gf_dim=8,
                              df_dim=8)
    params, state = dcgan.init(torch.Generator().manual_seed(3), cfg, "cpu")
    params = {k: {n: {m: 3.0 * t for m, t in layer.items()}
                  for n, layer in net.items()} for k, net in params.items()}
    z_true = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (B, 12)).astype(np.float32))
    targets = dcgan.sample(params, state, z_true, cfg)
    return (cfg, params, state, targets,
            tconfig.InvertConfig(**INV))


def cli_argv(run_dir: str, data_parallel: int) -> list:
    argv = ["train-vid", "--device", "cpu", "--run-dir", run_dir,
            "--output-size", "32", "--z-dim", "16", "--gf-dim", "8",
            "--df-dim", "8", "--vid-z-dim", "20", "--vid-length", "4",
            "--dataset-size", str(CORPUS), "--batch-size", str(B),
            "--first-frame-loss-scalar", "1.0", "--device-corpus",
            "--chunk", "2", "--steps-limit", str(CLI_STEPS),
            "--sample-every", "2", "--checkpoint-every", "2"]
    if data_parallel != 1:
        argv += ["--data-parallel", str(data_parallel), "--fsdp"]
    return argv


def _flat_np(tree) -> dict:
    return {k: v.detach().numpy().copy() for k, v in flatten(tree).items()
            if isinstance(v, torch.Tensor)}


def _metrics(m) -> dict:
    return {k: v.detach().numpy().copy() for k, v in m.items()}


def run_cases(workdir: str) -> dict:
    from gifgan_tpu_torch import cli
    from gifgan_tpu_torch.core.mesh import make_mesh
    from gifgan_tpu_torch.data.device import DeviceCorpus
    from gifgan_tpu_torch.invert.optimize import image_problem, invert
    from gifgan_tpu_torch.parallel import fsdp
    from gifgan_tpu_torch.parallel.dp import (make_sharded_step,
                                              shard_train_state)
    from gifgan_tpu_torch.serve.sampler import vid_sample_fn, vid_sample_fn_q
    from gifgan_tpu_torch.train import gan, vid

    cfg, tcfg, img = cfgs()
    x = inputs()
    mesh = make_mesh()
    frames, z = torch.from_numpy(x["frames"]), torch.from_numpy(x["z"])
    out = {}

    # DP: two train_steps and one K-step chunk at noise 0 with the knobs'
    # D-lr scale (the JAX reference's), then the chunk with noise on (each
    # rank keeps its rows of the global draw)
    static = {"cfg": cfg, "tcfg": tcfg}
    quiet = knobs(cfg)
    step = make_sharded_step(vid.train_step, mesh, static_args=static,
                             pass_knobs=True)
    ts = shard_train_state(mesh, vid_state(x["vid_flat"]))
    steps = []
    for i in range(K):
        ts, m = step(ts, frames[i], z[i], None, quiet)
        steps.append(_metrics(m))
    out["dp_steps"] = (steps, _flat_np(ts))
    chunk = make_sharded_step(vid.train_chunk, mesh, static_args=static,
                              batch_axis=1, pass_knobs=True)
    ts, m = chunk(vid_state(x["vid_flat"]), frames, z, None, quiet)
    out["dp_chunk"] = (_metrics(m), _flat_np(ts))
    ts, m = chunk(vid_state(x["vid_flat"]), frames, z,
                  torch.Generator().manual_seed(5), knobs(cfg, KNOB_NOISE))
    out["dp_chunk_noise"] = (_metrics(m), _flat_np(ts))

    # FSDP: the same two steps from the sharded state
    ts, sh = fsdp.place_and_shardings(mesh, vid_state(x["vid_flat"]),
                                      min_size=FSDP_MIN)
    out["fsdp_local_shapes"] = {k: tuple(v.shape)
                                for k, v in flatten(ts).items()}
    step = make_sharded_step(vid.train_step, mesh, static_args=static,
                             state_shardings=sh, pass_knobs=True)
    steps = []
    for i in range(K):
        ts, m = step(ts, frames[i], z[i], None, quiet)
        steps.append(_metrics(m))
    full = fsdp.gather_state(ts, sh)
    out["fsdp_steps"] = (steps, _flat_np(full))
    ckpt.AsyncCheckpointer(multihost=True).save(
        os.path.join(workdir, "fsdp_ckpt"), K, full)

    # the image DCGAN, noise on
    img_noisy = tconfig.DCGANConfig(**dict(IMG, noise_std=0.1))
    step = make_sharded_step(gan.train_step, mesh,
                             static_args={"cfg": img_noisy, "tcfg": tcfg})
    ts, m = step(shard_train_state(mesh, img_state(x["img_flat"])),
                 torch.from_numpy(x["images"]), torch.from_numpy(x["img_z"]),
                 torch.Generator().manual_seed(6))
    out["img_step"] = (_metrics(m), _flat_np(ts))

    # the corpus: this rank's ids of (K, B) and of (B,), gathered by K1's
    # plain version
    corpus = DeviceCorpus(x["clips"], device="cpu", mesh=mesh)
    group = mesh.data_group
    out["corpus"] = (group.all_gather(corpus.sample(x["ids"]), 1).numpy(),
                     group.all_gather(corpus.sample(x["ids"][0]), 0).numpy())
    try:
        corpus.sample(x["ids"][:, :3])
        out["corpus_refuses"] = ""
    except ValueError as e:
        out["corpus_refuses"] = str(e)

    # samplers, float and int8 (dynamic scales: the max covers the batch)
    ts = vid_state(x["vid_flat"])
    zs = x["z"][0]
    out["sample"] = vid_sample_fn(ts, cfg, mesh)(zs).numpy()
    q, _ = vid.quantize_sampler(ts, cfg)
    out["sample_q"] = vid_sample_fn_q(q, cfg, mesh)(zs).numpy()
    try:
        vid_sample_fn(ts, cfg, mesh)(zs[:3])
        out["sampler_refuses"] = ""
    except ValueError as e:
        out["sampler_refuses"] = str(e)

    # inversion from the JAX z0
    icfg_cfg, params, state, targets, icfg = inversion_model()
    z0 = np.load(os.path.join(workdir, "jax_inputs.npz"))["inv_z0"]
    zi, losses, frames_ = invert(image_problem(params, state, targets,
                                               icfg_cfg, icfg, "cpu"),
                                 icfg, z0=torch.from_numpy(z0),
                                 progress_sections=[(0, 2)], mesh=mesh)
    out["invert"] = (zi.numpy(), losses, frames_[-1])
    try:
        invert(image_problem(params, state, targets[:3], icfg_cfg, icfg,
                             "cpu"), icfg, mesh=mesh)
        out["invert_refuses"] = ""
    except ValueError as e:
        out["invert_refuses"] = str(e)

    # the CLI in every rank: train-vid --data-parallel 2 --fsdp
    cli.main(cli_argv(os.path.join(workdir, "cli_run"), 2))
    return out


def main(rank: int, world: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = run_cases(workdir)
        if rank == 0:
            torch.save(out, os.path.join(workdir, "results.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
