"""The port's mesh arithmetic (gifgan_tpu_torch/core/mesh.py,
parallel/distributed.py, parallel/fsdp.py) against the JAX package's, with
no process group and no JAX compile: mesh shapes and errors, the process
sharding helpers, and the FSDP shard dim of every leaf of the image, small
video and flagship video train states."""

import jax
import numpy as np
import pytest
import torch

from gifgan_tpu.core import checkpoint as jckpt
from gifgan_tpu.core.config import DCGANConfig, TrainConfig, VidGANConfig
from gifgan_tpu.core.mesh import make_mesh as jmake_mesh
from gifgan_tpu.parallel import distributed as jdist
from gifgan_tpu.parallel.fsdp import fsdp_state_shardings as jfsdp
from gifgan_tpu.train import gan as jgan
from gifgan_tpu.train import vid as jvid
from gifgan_tpu_torch.core import config as tconfig
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core.mesh import (Sharding, make_mesh, replicate,
                                        shard_batch)
from gifgan_tpu_torch.core.tree import flatten
from gifgan_tpu_torch.parallel import distributed as tdist
from gifgan_tpu_torch.parallel.dp import shard_batch_arrays
from gifgan_tpu_torch.parallel.fsdp import (fsdp_state_shardings,
                                            place_and_shardings)
from gifgan_tpu_torch.train import gan, vid

# (data, model, seq) requests: the defaults, pinned axes, and ones that
# cannot tile the devices
REQUESTS = [(0, 1, 1), (1, 1, 1), (2, 1, 1), (0, 2, 1), (0, 1, 2),
            (2, 2, 1), (2, 1, 2), (3, 1, 1), (0, 3, 1), (4, 1, 1),
            (8, 1, 1), (0, 0, 0)]


def _mesh_or_error(fn):
    try:
        return dict(fn().shape)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_equals_jax(n):
    """Every request's mesh shape, or its ValueError text, equals the JAX
    make_mesh's on n of the conftest's virtual devices."""
    for dp, mp, sp in REQUESTS:
        want = _mesh_or_error(lambda: jmake_mesh(
            jax.devices()[:n], data_parallel=dp, model_parallel=mp,
            seq_parallel=sp))
        got = _mesh_or_error(lambda: make_mesh(
            list(range(n)), data_parallel=dp, model_parallel=mp,
            seq_parallel=sp))
        assert got == want, (n, dp, mp, sp)


def test_one_process_mesh_places_as_one_device():
    """Without a process group: make_mesh() is one rank, a data sharding
    keeps every row and a replica is the value itself."""
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "seq": 1, "model": 1}
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    np.testing.assert_array_equal(shard_batch_arrays(mesh, x).numpy(), x)
    tree = {"a": torch.ones(3), "b": {"c": x}}
    np.testing.assert_array_equal(shard_batch(mesh, tree)["b"]["c"].numpy(),
                                  x)
    assert torch.equal(replicate(mesh, tree)["a"], torch.ones(3))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_process_helpers_equal_jax(n):
    """process_shard and global_batch_to_local with an explicit index and
    count, the values and the error text."""
    items = list(range(11))
    for i in range(n):
        assert (tdist.process_shard(items, i, n)
                == jdist.process_shard(items, i, n))
    for batch in (8, 12, 7):
        try:
            want = jdist.global_batch_to_local(batch, n)
        except ValueError as e:
            want = str(e)
        try:
            got = tdist.global_batch_to_local(batch, n)
        except ValueError as e:
            got = str(e)
        assert got == want


def test_initialize_is_inert_in_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tdist.initialize() is False
    assert not torch.distributed.is_initialized()


_IMG = dict(output_size=32, c_dim=3, z_dim=16, gf_dim=8, df_dim=8)
# hidden 30: BN vectors of 30 floats, which 4 and 8 do not divide
_SMALL = dict(z_input_size=20, z_output_size=16, vid_length=4, hidden_dim=30,
              d_filters=16)
_FLAGSHIP_IMG = dict(output_size=64, c_dim=3, z_dim=100, gf_dim=64, df_dim=64)
_FLAGSHIP = dict(z_input_size=120, z_output_size=100, vid_length=16,
                 hidden_dim=512, d_filters=256)


def _states(name):
    """(port state, JAX state of ShapeDtypeStructs) of one model."""
    tcfg = dict(batch_size=8, gen_updates=2)
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    if name == "image":
        return (gan.init_train_state(gen, tconfig.DCGANConfig(**_IMG),
                                     tconfig.TrainConfig(**tcfg), "cpu"),
                jax.eval_shape(lambda: jgan.init_train_state(
                    key, DCGANConfig(**_IMG), TrainConfig(**tcfg))))
    img, v = (_IMG, _SMALL) if name == "small" else (_FLAGSHIP_IMG, _FLAGSHIP)
    return (vid.init_train_state(gen, tconfig.VidGANConfig(
        image_gan=tconfig.DCGANConfig(**img), **v),
        tconfig.TrainConfig(**tcfg), "cpu"),
        jax.eval_shape(lambda: jvid.init_train_state(
            key, VidGANConfig(image_gan=DCGANConfig(**img), **v),
            TrainConfig(**tcfg))))


def _jax_dims(mesh, jts, min_size):
    """{JAX key: sharded dim or None} of the JAX package's shardings."""
    flat = jax.tree_util.tree_flatten_with_path(
        jfsdp(mesh, jts._asdict(), min_size=min_size))[0]
    out = {}
    for path, sh in flat:
        key = "/".join(jckpt._path_str(p) for p in path)
        dims = [d for d, a in enumerate(sh.spec) if a is not None]
        out[key] = dims[0] if dims else None
    return out


def _port_key(jax_key):
    return (jax_key.replace("/0/", "/", 1) if jax_key.startswith("opt_")
            else jax_key)


def _port_dim_of(jax_key, ndim, jax_dim):
    """The port dim that holds JAX dim `jax_dim` of a leaf, read from the
    layout conversion itself: a probe whose dims all differ in size."""
    probe = np.zeros(tuple(range(2, 2 + ndim)), np.float32)
    leaf = interop.from_jax_flat({jax_key: probe}, "cpu")
    for part in _port_key(jax_key).split("/"):
        leaf = leaf[part]
    return tuple(leaf.shape).index(2 + jax_dim)


@pytest.mark.parametrize("model", ["image", "small", "flagship"])
def test_fsdp_shard_dims_equal_jax(model):
    """For 2, 4 and 8 ranks and two thresholds, every leaf's shard dim is
    the JAX package's (mapped through the layout conversion: the vid-D
    conv3d weight's tie goes to its in-channels in both packages), or both
    replicate it; the cases include leaves under min_size and (the small
    model's BN vectors of 30) leaves at or above it that no dim of
    divides."""
    ts, jts = _states(model)
    shapes = {_port_key(k): (k, leaf.shape) for k, leaf in (
        ("/".join(jckpt._path_str(p) for p in path), leaf) for path, leaf
        in jax.tree_util.tree_flatten_with_path(jts._asdict())[0])}
    seen = {"under": 0, "indivisible": 0, "sharded": 0}
    for n in (2, 4, 8):
        mesh = make_mesh(list(range(n)))
        jmesh = jmake_mesh(jax.devices()[:n], data_parallel=n)
        for min_size in (16, 2048):
            want = _jax_dims(jmesh, jts, min_size)
            got = flatten(fsdp_state_shardings(mesh, ts, min_size=min_size))
            assert sorted(got) == sorted(shapes)
            for k, sh in got.items():
                assert isinstance(sh, Sharding)
                jkey, jshape = shapes[k]
                wd = want[jkey]
                assert sh.dim == (None if wd is None else _port_dim_of(
                    jkey, len(jshape), wd)), (n, k)
                size = int(np.prod(jshape))
                if size < min_size:
                    seen["under"] += 1
                elif wd is None and jshape:
                    seen["indivisible"] += 1
                elif wd is not None:
                    seen["sharded"] += 1
    assert seen["under"] and seen["sharded"], seen
    if model == "small":
        assert seen["indivisible"], seen
    if model == "flagship":
        conv3d = flatten(fsdp_state_shardings(make_mesh([0, 1]), ts))
        assert conv3d["params/vid_discriminator/h2_conv/w"].dim == 1


def test_place_and_shardings_refuses_no_mesh():
    ts, _ = _states("image")
    with pytest.raises(ValueError, match="--fsdp requires a device mesh"):
        place_and_shardings(None, ts)


def test_save_multihost_writes_on_process_zero_between_barriers(tmp_path):
    """The JAX contract (gifgan_tpu/core/checkpoint.py save_multihost): a
    barrier before and after, process 0 writes, the others write nothing
    and return None."""
    from gifgan_tpu_torch.core import checkpoint as ckpt

    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    calls = []
    for index in (1, 0):
        path = ckpt.save_multihost(str(tmp_path / f"p{index}"), 7, tree,
                                   process_index=index,
                                   barrier=calls.append)
        assert (path is None) == (index != 0)
        assert ckpt.all_steps(str(tmp_path / f"p{index}")) == (
            [7] if index == 0 else [])
    assert calls == ["ckpt_pre_7", "ckpt_post_7"] * 2
    np.testing.assert_array_equal(
        ckpt.load_flat(str(tmp_path / "p0"))["w"], tree["w"])


def test_train_loops_refuse_what_the_port_does_not_shard(tmp_path):
    """fsdp without a mesh raises the JAX loops' error, and fsdp on a mesh
    with a model axis above 1 the JAX train-vid's (the two shard the state
    along different axes); a mesh with a model or seq axis above 1 needs
    the process group of its ranks. Nothing is written."""
    from gifgan_tpu_torch.train import loops

    cfg = tconfig.VidGANConfig(image_gan=tconfig.DCGANConfig(**_IMG),
                               **_SMALL)
    tcfg = tconfig.TrainConfig(batch_size=4, run_dir=str(tmp_path / "r"))
    with pytest.raises(ValueError, match="fsdp=True requires a device mesh"):
        loops.train_vid_dcgan(None, cfg, tcfg, fsdp=True, device="cpu")
    with pytest.raises(ValueError, match="--fsdp and --tensor-parallel"):
        loops.train_vid_dcgan(None, cfg, tcfg, fsdp=True, device="cpu",
                              mesh=make_mesh([0, 1], model_parallel=2))
    for kw in ({"model_parallel": 2}, {"seq_parallel": 2}):
        with pytest.raises(RuntimeError, match="initialized process group"):
            loops.train_vid_dcgan(None, cfg, tcfg, device="cpu",
                                  mesh=make_mesh([0, 1], **kw))
    assert not (tmp_path / "r").exists()


@pytest.mark.parametrize("data_parallel", [0, 1, 2])
def test_cli_mesh_arg_in_one_process(data_parallel):
    """--data-parallel in one process: 0 and 1 mean no mesh, 2 cannot tile
    one rank and raises the JAX make_mesh's error."""
    import argparse

    from gifgan_tpu_torch import cli

    args = argparse.Namespace(data_parallel=data_parallel)
    if data_parallel < 2:
        assert cli._mesh_arg(args) is None
    else:
        with pytest.raises(ValueError, match=r"mesh 2x1x1 != 1 devices"):
            cli._mesh_arg(args)
