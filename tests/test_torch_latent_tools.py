"""The port's latent-space tools against the JAX package's: the expression
path library and its derivation from trajectories (demo/, numpy only:
identical results), the z-text parser (serve/explorer.py parse_z_text),
the trajectory renderer (serve/sampler.py render_z_trajectory), the z-sweep
grids (eval/visualize.py modes 0-4) and the h2-tap distance analysis
(eval/activation_analyzer.py).

The visualize and render cases feed both packages the same numpy sample
function, so their grids and GIF frames differ only by the float32
rounding of the grid arithmetic (at most 1 grey level); the GIF frames are
compared as handed to the encoder (both packages use one native encoder).
activation_distances runs each package's discriminator on the same frames
and weights: within 1e-4 of the largest distance (float32 convs summed in
another order).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gifgan_tpu import demo as jdemo
from gifgan_tpu.core.checkpoint import _flatten_with_paths
from gifgan_tpu.core.config import DCGANConfig as JDCGANConfig
from gifgan_tpu.data import video as jvideo
from gifgan_tpu.eval import activation_analyzer as jaa
from gifgan_tpu.eval import visualize as jvis
from gifgan_tpu.models import dcgan as jdcgan
from gifgan_tpu.serve import explorer as jexplorer
from gifgan_tpu.serve import sampler as jsampler
from gifgan_tpu_torch import demo as tdemo
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core.config import DCGANConfig
from gifgan_tpu_torch.eval import activation_analyzer as taa
from gifgan_tpu_torch.eval import visualize as tvis
from gifgan_tpu_torch.serve import explorer as texplorer
from gifgan_tpu_torch.serve import sampler as tsampler


def _trajs(n=6, t=8, z=10, seed=0):
    rng = np.random.default_rng(seed)
    return {f"clip{i}": np.cumsum(rng.normal(0, 0.1 * (i + 1), (t, z)),
                                  axis=0).astype(np.float32)
            for i in range(n)}


def _equal_dicts(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kw", [dict(), dict(frames=5, magnitude=1.3,
                                             seed=4)])
def test_expression_paths_equal_the_jax_package(kw, tmp_path):
    _equal_dicts(tdemo.make_expression_paths(12, **kw),
                 jdemo.make_expression_paths(12, **kw))
    dirs = np.random.default_rng(1).normal(size=(8, 12))
    _equal_dicts(tdemo.make_expression_paths(12, directions=dirs, **kw),
                 jdemo.make_expression_paths(12, directions=dirs, **kw))
    assert tdemo.EXPRESSIONS.keys() == jdemo.EXPRESSIONS.keys()
    paths = tdemo.make_expression_paths(12, **kw)
    tdemo.write_paths(str(tmp_path / "t"), paths)
    jdemo.write_paths(str(tmp_path / "j"), paths)
    for name in paths:
        t = (tmp_path / "t" / f"{name}.txt").read_text()
        assert t == (tmp_path / "j" / f"{name}.txt").read_text()
        # both parsers read the file back alike, to the path within the
        # 8 significant digits the repr keeps
        np.testing.assert_array_equal(texplorer.parse_z_text(t),
                                      jexplorer.parse_z_text(t))
        np.testing.assert_allclose(texplorer.parse_z_text(t), paths[name],
                                   rtol=0, atol=1e-7)


def test_derived_paths_equal_the_jax_package(tmp_path):
    trajs = _trajs()
    for i, (name, t) in enumerate(trajs.items()):
        np.save(tmp_path / f"{name}.npy", t)
    np.save(tmp_path / "clip0_comparison.npy", trajs["clip0"])
    np.save(tmp_path / "flat.npy", np.zeros(5))
    np.save(tmp_path / "short.npy", np.zeros((1, 10)))
    (tmp_path / "bad.npy").write_bytes(b"not an array")
    got = tdemo.load_trajectories(str(tmp_path))
    _equal_dicts(got, jdemo.load_trajectories(str(tmp_path)))
    assert sorted(got) == sorted(trajs)
    for name, t in trajs.items():
        assert tdemo.score_trajectory(t) == jdemo.score_trajectory(t)
        assert (tdemo.score_trajectory(t, jerk_weight=0.5)
                == jdemo.score_trajectory(t, jerk_weight=0.5))
        for w in (1, 3, 4):
            np.testing.assert_array_equal(tdemo.smooth_path(t, w),
                                          jdemo.smooth_path(t, w))
    for kw in (dict(), dict(top_k=2, smooth_window=5, magnitude=0.7,
                            jerk_weight=0.0)):
        _equal_dicts(tdemo.derive_paths(trajs, **kw),
                     jdemo.derive_paths(trajs, **kw))
    np.testing.assert_array_equal(tdemo.pca_directions(trajs, 7),
                                  jdemo.pca_directions(trajs, 7))


@pytest.mark.parametrize("text", [
    "[[0.1, 0.2], [0.3, -0.4]]",
    "array([[ 0.1,  0.2],\n       [ 0.3, -0.4]], dtype=float32)",
    "[array([0.5, 1.0]), array([0.25, -2.0])]",
    json.dumps(np.linspace(-1, 1, 12).reshape(3, 4).tolist()),
])
def test_parse_z_text_json_and_repr(text):
    got = texplorer.parse_z_text(text)
    want = jexplorer.parse_z_text(text)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_parse_z_text_evaluates_nothing():
    with pytest.raises((ValueError, SyntaxError)):
        texplorer.parse_z_text("__import__('os').system('true')")


def _sample_fn(c_dim=3, size=16):
    """A fixed numpy 'generator': z (B, z_dim) -> (B, size, size, c) in
    [-1, 1], smooth in z, so sweeps move the pixels."""
    rng = np.random.default_rng(5)
    proj = rng.normal(size=(100, size * size * c_dim)).astype(np.float32)

    def fn(z):
        z = np.asarray(z, np.float32)
        return np.tanh(z @ proj[:z.shape[1]]).reshape(
            z.shape[0], size, size, c_dim)
    return fn


def _read_png(path):
    import cv2

    im = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    return im[..., ::-1] if im.ndim == 3 else im


@pytest.mark.parametrize("option", [0, 1, 2, 3, 4])
def test_visualize_modes_equal_the_jax_package(option, tmp_path,
                                               monkeypatch):
    gifs = {"t": {}, "j": {}}
    monkeypatch.setattr(tvis, "write_gif", lambda p, f, fps=8.0:
                        gifs["t"].__setitem__(os.path.basename(p), f))
    monkeypatch.setattr(jvideo, "write_gif", lambda p, f, fps=8.0:
                        gifs["j"].__setitem__(os.path.basename(p), f))
    fn = _sample_fn()
    kw = dict(num_dims=5, seed=3)
    got = tvis.visualize(fn, 20, 12, option, str(tmp_path / "t"), **kw)
    want = jvis.visualize(fn, 20, 12, option, str(tmp_path / "j"), **kw)
    names = [os.path.basename(p) for p in got]
    assert names == [os.path.basename(p) for p in want]
    pngs = [n for n in names if n.endswith(".png")]
    # mode 2 may draw a dim twice, writing its file twice
    assert sorted(gifs["t"]) == sorted(gifs["j"]) == sorted(
        {n for n in names if n.endswith(".gif")})
    assert pngs or gifs["t"]
    for n in pngs:
        a, b = _read_png(tmp_path / "t" / n), _read_png(tmp_path / "j" / n)
        assert a.shape == b.shape, n
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, n
    for n, frames in gifs["t"].items():
        want_f = np.asarray(gifs["j"][n])
        assert frames.dtype == np.uint8 and frames.shape == want_f.shape, n
        assert np.abs(frames.astype(int) - want_f.astype(int)).max() <= 1, n


def test_visualize_takes_a_tensor_sample_fn(tmp_path):
    fn = _sample_fn(c_dim=1)
    t = lambda z: torch.from_numpy(fn(z))
    got = tvis.visualize(t, 20, 12, 1, str(tmp_path), num_dims=2)
    assert [os.path.basename(p) for p in got] == ["test_arange_0.png",
                                                  "test_arange_1.png"]
    assert _read_png(got[0]).shape[:2] == (2 * 16, 8 * 16)


def test_render_z_trajectory_equals_the_jax_package(tmp_path, monkeypatch):
    frames = {}
    monkeypatch.setattr(tsampler, "write_gif", lambda p, f, fps=8.0:
                        frames.__setitem__("t", (p, f, fps)))
    monkeypatch.setattr(jvideo, "encode_mp4", lambda p, f, fps=25.0:
                        frames.__setitem__("j", (p, f, fps)))
    z = np.random.default_rng(0).uniform(-1, 1, (5, 20)).astype(np.float32)
    np.save(tmp_path / "traj.npy", z)
    fn = _sample_fn()
    out = tsampler.render_z_trajectory(fn, str(tmp_path / "traj.npy"),
                                       str(tmp_path / "t.gif"), scale=3)
    jsampler.render_z_trajectory(fn, str(tmp_path / "traj.npy"),
                                 str(tmp_path / "j.mp4"), scale=3)
    assert out == str(tmp_path / "t.gif") == frames["t"][0]
    assert frames["t"][1].shape == (5, 48, 48, 3)
    np.testing.assert_array_equal(frames["t"][1], frames["j"][1])
    assert frames["t"][2] == frames["j"][2] == 8.0


def test_activation_distances_equal_the_jax_package(tmp_path):
    img = dict(output_size=32, c_dim=3, z_dim=12, gf_dim=8, df_dim=8)
    jcfg = JDCGANConfig(**img)
    params, state = jax.jit(jdcgan.init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tree = interop.from_jax_flat(_flatten_with_paths(
        {"params": params, "state": state}), "cpu")
    rng = np.random.default_rng(2)
    videos = [rng.uniform(-1, 1, (6, 32, 32, 3)).astype(np.float32)
              for _ in range(3)]
    videos[1][3] = videos[1][1]                  # a duplicate frame
    want = jaa.activation_distances(params, state, jcfg, videos,
                                    frames_per_video=6, seed=1)
    got = taa.activation_distances(tree["params"], tree["state"],
                                   DCGANConfig(**img), videos,
                                   frames_per_video=6, seed=1, device="cpu")
    assert got["summary"]["n_frames"] == want["summary"]["n_frames"] == 17
    scale = max(want["intra"].max(), want["inter"].max())
    for k in ("intra", "inter"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
    for k in ("intra_mean", "inter_mean", "separation"):
        np.testing.assert_allclose(got["summary"][k], want["summary"][k],
                                   rtol=1e-4, err_msg=k)
    taa.write_distance_lists(got, str(tmp_path / "t"))
    jaa.write_distance_lists(want, str(tmp_path / "j"))
    for k in ("intra", "inter"):
        a = np.loadtxt(tmp_path / f"t_{k}.txt")
        b = np.loadtxt(tmp_path / f"j_{k}.txt")
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale)
