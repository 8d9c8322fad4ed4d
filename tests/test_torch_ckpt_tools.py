"""The port's checkpoint tools (gifgan_tpu_torch/core/ckpt_tools.py),
counterparts of the checkpoint cases of tests/test_profile_ckpt_tools.py,
and the port against the JAX package's tools on the same files.

The TF readers and the V1 writer are numpy and struct code in both
packages: they read the committed genuine TF V2 bundle
(tests/fixtures/tf_ref_dcgan, written by TensorFlow) bit-exactly and write
byte-equal V1 files. `import_reference_dcgan` returns port tensors in the
port's layouts; its generator and discriminator agree with the JAX
package's on one z within 1e-5 (float32 accumulation order). The flat
.npz and the step directories are one format, so each package imports
what the other exports.
"""

import os
import shutil
import struct
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gifgan_tpu.core import checkpoint as jckpt
from gifgan_tpu.core import ckpt_tools as jtools
from gifgan_tpu.core.config import DCGANConfig as JDCGANConfig
from gifgan_tpu.models import dcgan as jdcgan
from gifgan_tpu_torch.core import checkpoint as tckpt
from gifgan_tpu_torch.core import ckpt_tools as ttools
from gifgan_tpu_torch.core.config import DCGANConfig
from gifgan_tpu_torch.models import dcgan as tdcgan

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "tf_ref_dcgan")
REF = os.path.join(FIXDIR, "ref.ckpt")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread per worker process (tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _expected():
    with np.load(os.path.join(FIXDIR, "expected.npz")) as z:
        return {k: z[k] for k in z.files}


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_read_tf_checkpoint_v2_genuine_fixture():
    got = ttools.read_tf_checkpoint(REF)
    _assert_same(got, _expected())
    _assert_same(got, jtools.read_tf_checkpoint(REF))
    assert len(got) == 48
    with pytest.raises(FileNotFoundError):
        ttools.read_tf_checkpoint(os.path.join(FIXDIR, "missing.ckpt"))


def test_tensorproto_typed_fields_decode():
    """V1 TensorProto typed scalars: double_val is fixed64 bits, negative
    int varints are two's complement."""
    buf = bytes([0x08, 0x02, 0x31]) + struct.pack("<d", 1.5)
    np.testing.assert_allclose(ttools._tensorproto_to_array(buf), [1.5])
    buf = bytes([0x08, 0x03, 0x38]) + ttools._emit_varint((1 << 64) - 1)
    arr = ttools._tensorproto_to_array(buf)
    assert arr.dtype == np.int32 and arr[0] == -1
    # packed floats (field 5, wire 2) and a shape
    buf = (ttools._field_varint(1, 1)
           + ttools._field_bytes(2, ttools._shape_proto((2, 2)))
           + ttools._field_bytes(5, np.arange(4, dtype="<f4").tobytes()))
    np.testing.assert_array_equal(ttools._tensorproto_to_array(buf),
                                  np.arange(4, dtype=np.float32).reshape(2, 2))
    assert ttools._crc32c(b"123456789") == jtools._crc32c(b"123456789") \
        == 0xE3069283


def test_write_v1_roundtrip_and_downgrade_genuine_v2(tmp_path):
    """The V1 writer round-trips through the reader, writes the JAX
    writer's bytes, and downgrade_checkpoint of the genuine V2 fixture
    reads back bit-exactly in both packages."""
    arrays = {
        "g_h0_lin/Matrix": np.random.default_rng(0)
        .standard_normal((7, 5)).astype(np.float32),
        "d_bn1/moving_mean": np.arange(6, dtype=np.float64),
        "global_step": np.asarray([1234], np.int64),
        "mask": np.asarray([[True, False], [False, True]]),
    }
    p, jpath = str(tmp_path / "synth.ckpt"), str(tmp_path / "j.ckpt")
    ttools.write_tf_checkpoint_v1(arrays, p)
    jtools.write_tf_checkpoint_v1(arrays, jpath)
    _assert_same(ttools.read_tf_checkpoint(p), arrays)
    with open(p, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()

    out, jout = str(tmp_path / "ref_v1.ckpt"), str(tmp_path / "jref.ckpt")
    ttools.downgrade_checkpoint(REF, out)
    jtools.downgrade_checkpoint(REF, jout)
    _assert_same(ttools.read_tf_checkpoint(out), _expected())
    _assert_same(jtools.read_tf_checkpoint(out), _expected())
    with open(out, "rb") as a, open(jout, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match="dtype"):
        ttools.write_tf_checkpoint_v1({"c": np.zeros(2, np.complex64)},
                                      str(tmp_path / "c.ckpt"))


def _mutated(data: bytes, rng) -> list:
    """Fuzz corpus for one file (tests/test_profile_ckpt_tools.py):
    truncations, byte flips, garbage splices, bad magic, a varint flood,
    zeros and a footer alone."""
    out = []
    n = len(data)
    for frac in (0.0, 0.1, 0.5, 0.9, 0.99):
        out.append(data[:int(n * frac)])
    for _ in range(40):
        b = bytearray(data)
        i = int(rng.integers(0, n))
        b[i] ^= int(rng.integers(1, 256))
        out.append(bytes(b))
    for _ in range(10):
        b = bytearray(data)
        i = int(rng.integers(0, max(1, n - 64)))
        b[i:i + 64] = rng.integers(0, 256, 64, np.uint8).tobytes()
        out.append(bytes(b))
    out.append(data[:-8] + b"\xff" * 8)
    out.append(b"\x80" * 64)
    out.append(b"\x00" * n)
    out.append(data[-48:])
    return out


def test_read_tf_checkpoint_fuzz_no_crash(tmp_path):
    """Corrupted V1/V2 files give a result or a clean Python exception,
    fast: the JAX test's seed (7) and counts (59 V1 files, 59 V2 indexes,
    20 V2 data shards)."""
    rng = np.random.default_rng(7)
    arrays = {"w": np.arange(24, dtype=np.float32).reshape(4, 6),
              "step": np.asarray([3], np.int64)}
    v1_path = str(tmp_path / "v1.ckpt")
    ttools.write_tf_checkpoint_v1(arrays, v1_path)
    with open(v1_path, "rb") as f:
        v1_bytes = f.read()
    t0 = time.monotonic()
    tried = 0
    for i, blob in enumerate(_mutated(v1_bytes, rng)):
        p = str(tmp_path / f"f{i}.ckpt")
        with open(p, "wb") as f:
            f.write(blob)
        tried += 1
        try:
            got = ttools.read_tf_checkpoint(p)
            assert isinstance(got, dict)
            assert all(isinstance(v, np.ndarray) for v in got.values())
        except Exception:
            pass  # any clean exception is acceptable for corrupt input
    with open(REF + ".index", "rb") as f:
        idx = f.read()
    dat_name = next(f for f in os.listdir(FIXDIR) if ".data-" in f)
    for i, blob in enumerate(_mutated(idx, rng)):
        pref = str(tmp_path / f"v2i_{i}" / "ref.ckpt")
        os.makedirs(os.path.dirname(pref))
        with open(pref + ".index", "wb") as f:
            f.write(blob)
        shutil.copy(os.path.join(FIXDIR, dat_name), os.path.dirname(pref))
        tried += 1
        try:
            ttools.read_tf_checkpoint(pref)
        except Exception:
            pass
    with open(os.path.join(FIXDIR, dat_name), "rb") as f:
        dat = f.read()
    for i, blob in enumerate(_mutated(dat, rng)[:20]):
        pref = str(tmp_path / f"v2d_{i}" / "ref.ckpt")
        os.makedirs(os.path.dirname(pref))
        shutil.copy(REF + ".index", os.path.dirname(pref))
        with open(os.path.join(os.path.dirname(pref), dat_name), "wb") as f:
            f.write(blob)
        tried += 1
        try:
            ttools.read_tf_checkpoint(pref)
        except Exception:
            pass
    assert tried == 59 + 59 + 20
    assert time.monotonic() - t0 < 60, "fuzz pass must stay fast (no hangs)"
    assert set(ttools.read_tf_checkpoint(v1_path)) == set(arrays)
    assert ttools.read_tf_checkpoint(REF)


def test_import_reference_dcgan_forward_equals_jax():
    """The fixture's weights in the port's layouts drive the port's
    generator and discriminator to the JAX package's outputs on one z
    (within 1e-5); leaves without a permutation are the file's values."""
    cfg = dict(output_size=32, c_dim=3, z_dim=16, gf_dim=8, df_dim=8)
    jcfg, tcfg = JDCGANConfig(**cfg), DCGANConfig(**cfg)
    jp, js = jtools.import_reference_dcgan(REF, jcfg)
    tp, ts = ttools.import_reference_dcgan(REF, tcfg, device="cpu")
    expected = _expected()
    np.testing.assert_array_equal(tp["generator"]["h0_lin"]["w"].numpy(),
                                  expected["g_h0_lin/Matrix"])
    np.testing.assert_array_equal(ts["discriminator"]["bn2"]["var"].numpy(),
                                  expected["d_bn2/moving_variance"])
    np.testing.assert_array_equal(
        tp["generator"]["h1_deconv"]["w"].numpy(),
        expected["g_h1/w"].transpose(3, 2, 0, 1))
    z = np.array(jax.random.uniform(jax.random.PRNGKey(0), (4, 16),
                                    minval=-1.0, maxval=1.0))
    jimg = jax.jit(lambda z: jdcgan.generator(
        jp.generator, js.generator, z, jcfg, train=False)[0])(jnp.asarray(z))
    jlogits = jax.jit(lambda x: jdcgan.discriminator(
        jp.discriminator, js.discriminator, x, jcfg, train=False)[0])(jimg)
    with torch.no_grad():
        timg, _ = tdcgan.generator(tp["generator"], ts["generator"],
                                   torch.from_numpy(z), tcfg, train=False)
        tlogits = tdcgan.discriminator(tp["discriminator"],
                                       ts["discriminator"],
                                       torch.from_numpy(np.array(jimg)),
                                       tcfg, train=False)[0]
    assert timg.shape == (4, 32, 32, 3) and tlogits.shape == (4, 1)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(KeyError, match="missing variable"):
        ttools.import_reference_dcgan(REF, tcfg, scope="image_gan",
                                      device="cpu")


def _tree():
    rng = np.random.default_rng(1)
    return {"params": {"w": rng.standard_normal((2, 3)).astype(np.float32),
                       "conv": {"w": rng.standard_normal(
                           (5, 5, 3, 4)).astype(np.float32)},
                       "b": np.zeros(3, np.float32)},
            "step": np.asarray(7)}


@pytest.mark.parametrize("exporter", ["port", "jax"])
def test_flat_npz_crosses_packages(exporter, tmp_path):
    """A step that one package saved, exported flat by `exporter` and
    imported by the other, holds the same arrays (bit-equal, same
    dtypes) and the same step."""
    (src_save, src_tools), (dst_ckpt, dst_tools) = (
        ((tckpt.save, ttools), (jckpt, jtools)) if exporter == "port"
        else ((jckpt.save, jtools), (tckpt, ttools)))
    src_save(str(tmp_path / "ck"), 7, _tree())
    npz = src_tools.export_flat(str(tmp_path / "ck"),
                                str(tmp_path / "flat.npz"))
    path = dst_tools.import_flat(npz, str(tmp_path / "ck2"))
    assert path.endswith("step_0000000007")
    _assert_same(dst_ckpt.load_flat(str(tmp_path / "ck2")),
                 jckpt.load_flat(str(tmp_path / "ck")))
    ttools.import_flat(npz, str(tmp_path / "ck3"), step=3)
    assert tckpt.all_steps(str(tmp_path / "ck3")) == [3]


def test_inspect_prints_the_jax_text(tmp_path):
    tckpt.save(str(tmp_path / "ck"), 7, _tree())
    text = ttools.inspect(str(tmp_path / "ck"))
    assert text == jtools.inspect(str(tmp_path / "ck"))
    assert "params/conv/w  (5, 5, 3, 4)  float32" in text
    assert text.splitlines()[-1] == "total parameters: 310"
