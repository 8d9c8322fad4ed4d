"""The port's image-DCGAN step on the JAX package's pinned DCGAN_TRAJ
(tests/test_trajectory_golden.py): the JAX init of PRNGKey(7), the golden
test's images and z, noise 0, float32 on the CPU.

Each step is taken by the port from the JAX package's state at that step
(the `jax_traj` fixture: the JAX package's own jitted train_step, the one
JAX train program of this file), and its losses must equal DCGAN_TRAJ at
that test's rtol and atol 2e-3, its weights after the step the JAX ones
at atol 3 x lr (Adam's step is ~lr whatever the gradient's size, so a
gradient at float32 noise level may move the two apart by up to ~lr).

Why from the JAX state at each step and not one free run: a run of 8
steps from a fresh Adam state is chaotic at float32 noise level. On the
first step Adam moves every weight by lr x g / (|g| + 1e-8), so a weight
whose gradient is rounding noise near 1e-8 (two of h1_deconv's 51,200
here) moves by a different fraction of lr in each package, and the GAN
amplifies it: the port's own run, 1e-6 from the JAX one at steps 0-1,
reads g_loss 0.60279 at step 6 against the golden 0.598467 (allowed
0.00320, off 0.00432). The JAX package's jit and op-by-op runs of the same
step differ by 0.0029 at step 7 for the same reason. Steps 0-1 of the
free run are held at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gifgan_tpu.core.checkpoint import _flatten_with_paths
from gifgan_tpu.core.config import TrainConfig
from gifgan_tpu.data.synthetic import synthetic_stills
from gifgan_tpu.train import gan as jgan
from gifgan_tpu_torch.core import config as tconfig
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.train import gan as tgan
from tests.test_trajectory_golden import DCGAN_TRAJ, IMG

TC = tconfig.DCGANConfig(output_size=32, c_dim=3, z_dim=16, gf_dim=8,
                         df_dim=8)
TT = tconfig.TrainConfig(batch_size=16, gen_updates=2)


def _inputs(i, data):
    imgs = data[(i * 16) % 64:(i * 16) % 64 + 16]
    z = np.array(jax.random.uniform(jax.random.PRNGKey(100 + i),
                                    (16, IMG.z_dim), minval=-1, maxval=1))
    return imgs, z


def _port_state(flat):
    return tgan.TrainState.from_tree(interop.from_jax_flat(flat, "cpu"))


@pytest.fixture(scope="module")
def jax_traj():
    """The golden test's run: [(flat state before step i, metrics)]."""
    tcfg = TrainConfig(batch_size=16, gen_updates=2)
    ts = jgan.init_train_state(jax.random.PRNGKey(7), IMG, tcfg)
    data = synthetic_stills(64, size=32).astype(np.float32) / 127.5 - 1.0
    out = []
    for i in range(len(DCGAN_TRAJ)):
        flat = _flatten_with_paths(ts._asdict())
        imgs, z = _inputs(i, data)
        ts, m = jgan.train_step(ts, jnp.asarray(imgs), jnp.asarray(z),
                                jax.random.PRNGKey(200 + i), IMG, tcfg)
        out.append((flat, {k: float(v) for k, v in m.items()}))
    out.append((_flatten_with_paths(ts._asdict()), None))
    return data, out


def test_dcgan_loss_trajectory_golden(jax_traj):
    data, traj = jax_traj
    got = []
    for i in range(len(DCGAN_TRAJ)):
        imgs, z = _inputs(i, data)
        tts, m = tgan.train_step(_port_state(traj[i][0]),
                                 torch.from_numpy(imgs), torch.from_numpy(z),
                                 None, TC, TT)
        got.append((float(m["d_loss"]), float(m["g_loss"])))
        after = interop.to_jax_flat(tts)
        for k, w in traj[i + 1][0].items():
            if k.startswith("params/"):
                np.testing.assert_allclose(after[k], w, rtol=0,
                                           atol=3 * TT.learning_rate,
                                           err_msg=f"step {i} {k}")
            elif k.endswith("count") or k == "step":
                np.testing.assert_array_equal(after[k], w,
                                              err_msg=f"step {i} {k}")
    np.testing.assert_allclose(got, DCGAN_TRAJ, rtol=2e-3, atol=2e-3)


def test_free_run_tracks_jax_over_the_first_steps(jax_traj):
    """From the JAX init, the port's own run: steps 0 and 1 (Adam counts 0
    and 1, both bias corrections) equal the JAX package's at 1e-5."""
    data, traj = jax_traj
    tts = _port_state(traj[0][0])
    for i in range(2):
        imgs, z = _inputs(i, data)
        tts, m = tgan.train_step(tts, torch.from_numpy(imgs),
                                 torch.from_numpy(z), None, TC, TT)
        for k in ("d_loss", "d_loss_real", "d_loss_fake", "g_loss"):
            np.testing.assert_allclose(float(m[k]), traj[i][1][k],
                                       rtol=1e-5, err_msg=f"step {i} {k}")
