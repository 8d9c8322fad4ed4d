"""The port's image-DCGAN step with the flagship's numerics, bf16
activations and the packed c-dim end layers (packed_c3), against the JAX
package's jitted train_step (the one JAX train program of this file) from
the same converted state, one step (one D and two G updates), noise 0, on
the CPU.

Tolerances, each with its reason: losses rtol 3e-2, since bf16 rounds
every activation to 8 bits of mantissa (2^-8 relative) through ten layers,
at each package's own rounding points (XLA may keep a fused chain in
float32 where the port rounds after each layer); weights atol 4 x lr,
since each of a net's (at most two) updates moves a weight by about lr at
most, and a bf16 gradient near zero may take either sign in either package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gifgan_tpu.core.checkpoint import _flatten_with_paths
from gifgan_tpu.train import gan as jgan
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.train import gan as tgan
from tests.test_torch_train_gan import (_cfgs, _images, _inputs,
                                        _jax_state, _port_state, _state_flat)


def test_bf16_packed_c3_step_matches_jax():
    jc, jt, tc, tt = _cfgs(compute_dtype="bfloat16", packed_c3=True)
    flat = _state_flat(*_cfgs()[:2])       # the init does not see the dtype
    stills, ids, z = _inputs()
    images = _images(stills, ids[0])
    jts, want = jgan.train_step(_jax_state(flat), jnp.asarray(images),
                                jnp.asarray(z[0]), jax.random.PRNGKey(0), jc,
                                jt)
    tts, got = tgan.train_step(_port_state(flat), torch.from_numpy(images),
                               torch.from_numpy(z[0]), None, tc, tt)
    for k in ("d_loss", "d_loss_real", "d_loss_fake", "g_loss",
              "images_std", "g_std"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=3e-2,
                                   err_msg=k)
    got_flat = interop.to_jax_flat(tts)
    for k, w in _flatten_with_paths(jts._asdict()).items():
        if k.startswith("params/"):
            np.testing.assert_allclose(got_flat[k], w, rtol=0,
                                       atol=4 * tt.learning_rate, err_msg=k)
        elif k.endswith("count") or k == "step":
            np.testing.assert_array_equal(got_flat[k], w, err_msg=k)
