"""The ranks of tests/test_torch_tp_sp.py: one gloo process group of four
ranks on the CPU runs every tensor- and sequence-parallel case of the port
and each rank writes its results.

    python tests/torch_tp_sp_ranks.py RANK WORLD PORT WORKDIR

The inputs are made here from numpy seeds (`inputs`, `layer_inputs`), so
the test process builds the same ones for its references. Imports no JAX.
"""

from __future__ import annotations

import functools
import os
import sys
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
for p in (REPO, TESTS):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch_parallel_ranks as P  # noqa: E402
from gifgan_tpu_torch.core import config as tconfig  # noqa: E402
from gifgan_tpu_torch.core.tree import flatten  # noqa: E402
from gifgan_tpu_torch.ops import nn  # noqa: E402

# 32 px, c 3, gf = df = 8, packed convs; z_dim 12 so that no activation
# a step gathers over `model` has the shape of a weight's block (the
# check of tests/test_torch_tp_sp.py test_tp_step_gathers_no_weight_over_
# model tells them apart by shape)
IMG = dict(P.IMG, z_dim=12)
VID = dict(P.VID, vid_length=16, z_output_size=12)
LONG_T = 64
B, K = 2, 2
# name: (data, seq, model, layout: the full tensor-parallel one or not, or
# "fsdp", the state over the data axis); every mesh has 4 ranks
MESHES = {"dp2_tp2": (2, 1, 2, False), "dp2_tp2_full": (2, 1, 2, True),
          "dp2_sp2": (2, 2, 1, False), "dp1_sp4": (1, 4, 1, False),
          "dp1_sp2_tp2": (1, 2, 2, True), "dp2_sp2_fsdp": (2, 2, 1, "fsdp")}
FSDP_MIN = P.FSDP_MIN
KNOB_NOISE = P.KNOB_NOISE
CORPUS, CLI_STEPS = 8, 4


def cfgs(t: int = VID["vid_length"], b: int = B):
    img = tconfig.DCGANConfig(**IMG)
    return (tconfig.VidGANConfig(image_gan=img, **dict(VID, vid_length=t)),
            tconfig.TrainConfig(batch_size=b, gen_updates=1))


def inputs(t: int = VID["vid_length"], b: int = B) -> dict:
    """A warm state and K batches of frames and z at clip length t."""
    from gifgan_tpu_torch.train import vid

    cfg, tcfg = cfgs(t, b)
    rng = np.random.default_rng(10 + t)
    s = IMG["output_size"]
    return {
        "vid_flat": P.warm_flat(vid.init_train_state(
            torch.Generator().manual_seed(0), cfg, tcfg, device="cpu"), t),
        "frames": np.tanh(rng.standard_normal(
            (K, b * t, s, s, 3))).astype(np.float32),
        "z": rng.uniform(-1, 1, (K, b, VID["z_input_size"])).astype(
            np.float32),
        "ids": rng.integers(0, CORPUS, (K, b)).astype(np.int64),
    }


def clips() -> np.ndarray:
    from gifgan_tpu_torch.data.synthetic import synthetic_clips

    return synthetic_clips(CORPUS, length=VID["vid_length"],
                           size=IMG["output_size"])


# the layer cases: name -> (layer, port weight shape, input shape, kw)
LAYERS = {
    "conv2d": ("conv2d", (8, 6, 5, 5), (3, 8, 8, 6), {}),
    "conv2d_sharded_in": ("conv2d", (8, 6, 5, 5), (3, 8, 8, 6), {}),
    "conv2d_s2d": ("conv2d", (8, 6, 5, 5), (3, 8, 8, 6), {"impl": "s2d"}),
    "deconv2d": ("deconv2d", (6, 4, 5, 5), (3, 4, 4, 6), {}),
    "deconv2d_subpixel": ("deconv2d", (6, 4, 5, 5), (3, 4, 4, 6),
                          {"impl": "subpixel"}),
    "linear": ("linear", (6, 8), (5, 6), {}),
    "linear_sharded_in": ("linear", (6, 8), (5, 6), {}),
    "conv3d": ("conv3d", (8, 6, 3, 3, 3), (2, 4, 4, 4, 6), {}),
    "batch_norm": ("batch_norm", (6,), (3, 4, 4, 6), {}),
}


def layer_inputs(name: str) -> dict:
    """A layer case's whole weight, bias, input and output cotangent."""
    layer, wshape, xshape, _ = LAYERS[name]
    rng = np.random.default_rng(sorted(LAYERS).index(name))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    out = {"x": f(*xshape)}
    if layer == "batch_norm":
        out.update(scale=1 + 0.1 * f(*wshape), bias=f(*wshape),
                   mean=0.1 * f(*wshape),
                   var=(1 + 0.2 * rng.random(wshape)).astype(np.float32))
        yshape = xshape
    else:
        out.update(w=0.2 * f(*wshape),
                   b=f(wshape[1] if layer in ("deconv2d", "linear")
                       else wshape[0]))
        yshape = {"conv2d": xshape[:1] + (4, 4, wshape[0]),
                  "deconv2d": xshape[:1] + (8, 8, wshape[1]),
                  "linear": (xshape[0], wshape[1]),
                  "conv3d": (2, 2, 2, 2, wshape[0])}[layer]
    out["r"] = f(*yshape)
    return out


def run_layer(name: str, tp: bool):
    """(y, dL/dx, {param: dL/dparam}) of L = sum(y * r), one-process or on
    the running step's model axis with this rank's weight block (ops/nn.py
    TP forms); in the second case y, dL/dx and the weight's gradient are
    this rank's blocks where the layer gives blocks."""
    from gifgan_tpu_torch.ops import nn
    from gifgan_tpu_torch.parallel import collectives as C

    layer, _, _, kw = LAYERS[name]
    a = {k: torch.from_numpy(v) for k, v in layer_inputs(name).items()}
    g = C.model_group() if tp else None
    block = (lambda t, d: g.rows(t, d).contiguous()) if g else (
        lambda t, d: t)
    x = a["x"]
    if g is not None and (name.endswith("sharded_in")
                          or layer == "batch_norm"):
        x = block(x, -1)
    x = x.clone().requires_grad_(True)
    if layer == "batch_norm":
        params = {"scale": a["scale"].clone().requires_grad_(True),
                  "bias": a["bias"].clone().requires_grad_(True)}
        y, state = nn.batch_norm(params, {"mean": a["mean"],
                                          "var": a["var"]}, x, True)
        extra = {k: v.numpy() for k, v in state.items()}
    else:
        wdim = 0 if layer in ("conv2d", "conv3d", "deconv2d") else 1
        params = {"w": block(a["w"], wdim).clone().requires_grad_(True),
                  "b": a["b"].clone().requires_grad_(True)}
        y = getattr(nn, layer)(params, x, **kw)
        extra = {}
    r = a["r"] if y.shape == a["r"].shape else block(a["r"], -1)
    loss = (y * r).sum()
    if y.shape != a["r"].shape:
        loss = C.reduce_model(loss)
    grads = torch.autograd.grad(loss, [x] + list(params.values()))
    return (y.detach().numpy(), grads[0].numpy(),
            {k: v.numpy() for k, v in zip(params, grads[1:])}, extra)


def dcgan_nets():
    """The image DCGAN's params, BN state and a z batch, from seeds."""
    from gifgan_tpu_torch.models import dcgan

    cfg = tconfig.DCGANConfig(**IMG)
    params, state = dcgan.init(torch.Generator().manual_seed(7), cfg, "cpu")
    z = np.random.default_rng(7).uniform(-1, 1, (4, IMG["z_dim"]))
    return cfg, params, state, torch.from_numpy(z.astype(np.float32))


def _unfolded_bn_after(layer, bn_params, bn_state, train, out_axis, reps=1):
    """nn.bn_after as the model axis runs it: the layer as it is, then
    nn.batch_norm."""
    return layer, functools.partial(nn.batch_norm, bn_params, bn_state,
                                    train=train)


def dcgan_tp(mesh=None):
    """The image generator's samples and the discriminator's logits and
    h2 tap on them, inference mode, with the params whole (mesh None) or
    placed by shard_dcgan_params_tp on the mesh's model axis."""
    from gifgan_tpu_torch.core.mesh import MODEL_AXIS
    from gifgan_tpu_torch.models import dcgan
    from gifgan_tpu_torch.parallel import collectives
    from gifgan_tpu_torch.parallel.tp import shard_dcgan_params_tp

    cfg, params, state, z = dcgan_nets()
    if mesh is not None:
        params = {k: shard_dcgan_params_tp(mesh, v)
                  for k, v in params.items()}
    # whole weights fold the inference BN into the layer before it
    # (ops/nn.py bn_after), and the fold sums in another order by ~1e-6
    # of a layer's largest value: the one-process nets keep the model
    # axis's layers, the BN unfolded (tests/test_torch_models.py holds the
    # fold to them)
    ctx = (collectives.use(mesh.group("data"), model=mesh.group(MODEL_AXIS))
           if mesh is not None else
           mock.patch.object(nn, "bn_after", _unfolded_bn_after))
    with ctx, torch.no_grad():
        x, _ = dcgan.generator(params["generator"], state["generator"], z,
                               cfg, train=False)
        logits, tap, _ = dcgan.discriminator(
            params["discriminator"], state["discriminator"], x, cfg,
            train=False)
    return x.numpy(), logits.numpy(), tap.numpy(), {
        k: tuple(v.shape) for k, v in flatten(params).items()}


def _flat_np(tree) -> dict:
    return {k: v.detach().numpy().copy() for k, v in flatten(tree).items()
            if isinstance(v, torch.Tensor)}


def _metrics(m) -> dict:
    return {k: v.detach().numpy().copy() for k, v in m.items()}


def knobs(cfg, noise: float = 0.0):
    return P.knobs(cfg, noise)


def vid_state(flat):
    return P.vid_state(flat)


def cli_argv(run_dir: str, extra: list, corpus: bool = True) -> list:
    """train-vid at small widths; tests/test_torch_tp_sp.py runs it under
    torch.distributed.run on 4 ranks with `extra` (the mesh flags)."""
    argv = ["train-vid", "--device", "cpu", "--run-dir", run_dir,
            "--output-size", "32", "--z-dim", "16", "--gf-dim", "8",
            "--df-dim", "8", "--vid-z-dim", "20", "--vid-length", "4",
            "--dataset-size", str(CORPUS), "--batch-size", "4",
            "--first-frame-loss-scalar", "1.0", "--chunk", "1",
            "--steps-limit", str(CLI_STEPS), "--sample-every", "2",
            "--checkpoint-every", "2", "--auto-intervene"]
    return argv + (["--device-corpus"] if corpus else []) + extra


# the CLI cases: name -> (mesh flags, device corpus)
CLI = {"cli_tp2": (["--tensor-parallel", "2"], True),
       "cli_sp2": (["--seq-parallel", "2"], False)}


def _mesh_case(name: str, x: dict, t: int, b: int) -> dict:
    from gifgan_tpu_torch.core.mesh import MODEL_AXIS, make_mesh
    from gifgan_tpu_torch.parallel import fsdp, tp
    from gifgan_tpu_torch.parallel.dp import (make_sharded_step,
                                              shard_train_state)
    from gifgan_tpu_torch.parallel.sp import make_sp_step
    from gifgan_tpu_torch.train import vid

    d, s, m, full = MESHES[name.split("_T")[0]]
    cfg, tcfg = cfgs(t, b)
    mesh = make_mesh(data_parallel=d, seq_parallel=s, model_parallel=m)
    ts0 = vid_state(x["vid_flat"])
    if full == "fsdp":
        sh = fsdp.fsdp_state_shardings(mesh, ts0, min_size=FSDP_MIN)
        place = lambda: fsdp.place_fsdp(mesh, ts0, min_size=FSDP_MIN)
    else:
        sh = tp.vid_state_tp_shardings(mesh, ts0, full) if m > 1 else None
        place = ((lambda: tp.place_vid_state_tp(mesh, ts0, full))
                 if sh is not None
                 else (lambda: shard_train_state(mesh, ts0)))
    whole = lambda ts: _flat_np(fsdp.gather_state(ts, sh))
    wrap = make_sp_step if s > 1 else make_sharded_step
    static = {"cfg": cfg, "tcfg": tcfg}
    frames, z = torch.from_numpy(x["frames"]), torch.from_numpy(x["z"])
    out = {}
    if s > 1:
        from gifgan_tpu_torch.parallel import collectives
        from gifgan_tpu_torch.parallel.sp import (shard_vid_batch,
                                                  vid_d_sharding)

        f_s, z_s = shard_vid_batch(mesh, frames[0], z[0])
        with collectives.use_mesh(mesh, seq=True):
            wall = collectives.gather_seq(f_s)
        out["placed"] = (f_s.numpy(), z_s.numpy(), torch.equal(
            wall, vid_d_sharding(mesh).place(frames[0])))
    placed = place()
    out["local_shapes"] = {k: tuple(v.shape)
                           for k, v in flatten(placed).items()}
    step = wrap(vid.train_step, mesh, static_args=static,
                state_shardings=sh, pass_knobs=True)
    model = mesh.group(MODEL_AXIS)
    model.shapes.clear()
    ts, mt = step(placed, frames[0], z[0], None, knobs(cfg))
    step_shapes = dict(model.shapes)
    out["step"] = (_metrics(mt), whole(ts))
    if t != VID["vid_length"]:
        return out
    chunk = wrap(vid.train_chunk, mesh, static_args=static, batch_axis=1,
                 state_shardings=sh, pass_knobs=True)
    model.shapes.clear()
    ts, mc = chunk(place(), frames, z, None, knobs(cfg))
    step_shapes.update(model.shapes)
    out["model_calls"] = step_shapes
    out["chunk"] = (_metrics(mc), whole(ts))
    out["bytes"] = mesh.collective_bytes()
    if name == "dp2_tp2_full":
        from gifgan_tpu_torch.core import checkpoint as ckpt

        ckpt.AsyncCheckpointer(multihost=True).save(
            os.path.join(os.environ["TP_SP_WORKDIR"], "tp_ckpt"), K,
            fsdp.gather_state(ts, sh))
    ts, mn = chunk(place(), frames, z, torch.Generator().manual_seed(5),
                   knobs(cfg, KNOB_NOISE))
    out["chunk_noise"] = (_metrics(mn), whole(ts))
    return out


def _corpus_case(x: dict) -> dict:
    """DeviceCorpus(mesh=) on the dp1 x sp2 x tp2 mesh: `sample` gives
    every rank the clips of its data index (all of them here), and in a
    sequence-parallel step `fold_sample_fn` its seq block of their frames;
    then train_chunk_ids through make_sp_step(folded=False)."""
    from gifgan_tpu_torch.core.mesh import DATA_AXIS, SEQ_AXIS, make_mesh
    from gifgan_tpu_torch.data.device import DeviceCorpus
    from gifgan_tpu_torch.parallel import collectives, fsdp, tp
    from gifgan_tpu_torch.parallel.sp import make_sp_step
    from gifgan_tpu_torch.train import vid

    mesh = make_mesh(data_parallel=1, seq_parallel=2, model_parallel=2)
    corpus = DeviceCorpus(clips(), device="cpu", mesh=mesh)
    ids = torch.from_numpy(x["ids"])
    out = {"sample": corpus.sample(ids).numpy()}
    with collectives.use_mesh(mesh, seq=True):
        rows = corpus.fold_sample_fn(corpus.data, ids[0])
    out["fold_rows"] = rows.shape[0]
    out["fold"] = mesh.group((DATA_AXIS, SEQ_AXIS)).all_gather(
        rows, 0).numpy()
    cfg, tcfg = cfgs()
    ts0 = vid_state(x["vid_flat"])
    sh = tp.vid_state_tp_shardings(mesh, ts0, True)
    step = make_sp_step(vid.train_chunk_ids, mesh,
                        static_args=dict(corpus_data=corpus.data, cfg=cfg,
                                         tcfg=tcfg,
                                         sample_fn=corpus.fold_sample_fn),
                        batch_axis=1, state_shardings=sh, pass_knobs=True,
                        folded=False)
    ts, m = step(fsdp.place_state(ts0, sh), ids, torch.from_numpy(x["z"]),
                 None, knobs(cfg))
    out["chunk_ids"] = (_metrics(m), _flat_np(fsdp.gather_state(ts, sh)))
    return out


def run_cases(workdir: str) -> dict:
    from gifgan_tpu_torch.core.mesh import MODEL_AXIS, make_mesh
    from gifgan_tpu_torch.parallel import collectives

    os.environ["TP_SP_WORKDIR"] = workdir
    out = {}
    # the layers on the model axis of a dp2 x tp2 mesh
    mesh = make_mesh(data_parallel=2, model_parallel=2)
    with collectives.use(mesh.group("data"), model=mesh.group(MODEL_AXIS)):
        out["layers"] = {n: run_layer(n, True) for n in LAYERS}
    out["model_index"] = mesh.group(MODEL_AXIS).index
    out["dcgan"] = dcgan_tp(mesh)

    x = inputs()
    for name in MESHES:
        out[name] = _mesh_case(name, x, VID["vid_length"], B)
    out["dp1_sp4_T64"] = _mesh_case("dp1_sp4_T64", inputs(LONG_T, 1),
                                    LONG_T, 1)
    out["corpus"] = _corpus_case(x)
    return out


def main(rank: int, world: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = run_cases(workdir)
        out["rank"] = rank
        torch.save(out, os.path.join(workdir, f"results{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
