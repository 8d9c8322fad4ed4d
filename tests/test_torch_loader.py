"""The port's clip feed (gifgan_tpu_torch/data/loader.py, data/video.py,
data/native_gif.py decode) against the JAX package's on the same files.

Tolerances: decode is bit-exact (one shared C++ codec); same-size batches
1e-6 (one float32 scale); where a clip is resized, the JAX package resizes
with cv2 (fixed-point rounding to uint8) and the port with K2's arithmetic:
uint8 results within 1 grey level, normalized batches within 1.5 / 127.5
(the port does not round to uint8 between resize and scale).
"""

import threading
import time

import numpy as np
import pytest
import torch

from gifgan_tpu_torch.data import loader as tloader
from gifgan_tpu_torch.data import native_gif as tgif
from gifgan_tpu_torch.data import video as tvideo


def _clip(seed, t=6, h=24, w=24):
    """A moving random clip in the encoder's colour cube (six levels per
    channel, multiples of 51, no pure greys, which have a finer ramp of
    their own), so a GIF round-trips it exactly."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 6, (h, w, 3)) * 51
    base[..., 2] = (base[..., 0] + 51) % 306
    return np.stack([np.roll(base, i, axis=1) for i in range(t)]).astype(
        np.uint8)


@pytest.fixture
def gif_dir(tmp_path):
    """Five 24x24 GIFs, one 40x32 GIF, one short GIF and one broken file."""
    paths = []
    for i in range(5):
        p = str(tmp_path / f"c{i}.gif")
        tvideo.write_gif(p, _clip(i))
        paths.append(p)
    big = str(tmp_path / "big.gif")
    tvideo.write_gif(big, _clip(10, h=40, w=32))
    short = str(tmp_path / "short.gif")
    tvideo.write_gif(short, _clip(11, t=3))
    bad = str(tmp_path / "bad.gif")
    with open(bad, "wb") as f:
        f.write(b"GIF89a-not-really")
    return dict(same=paths, big=big, short=short, bad=bad)


def test_decode_gif_roundtrip_and_equals_jax(gif_dir):
    from gifgan_tpu.data import native_gif as jgif

    clip = _clip(0)
    got = tgif.decode_gif(gif_dir["same"][0])
    assert got.dtype == np.uint8 and got.shape == clip.shape
    assert np.array_equal(got, clip)
    for path in gif_dir["same"][:2] + [gif_dir["big"], gif_dir["short"]]:
        assert np.array_equal(tgif.decode_gif(path), jgif.decode_gif(path))
    assert tgif.decode_gif(gif_dir["big"], max_frames=2).shape == (2, 40, 32,
                                                                   3)
    data = tgif.encode_gif_bytes(clip)
    assert np.array_equal(tgif.decode_gif_bytes(data), clip)
    assert data == jgif.encode_gif_bytes(clip)
    with pytest.raises(ValueError):
        tgif.decode_gif(gif_dir["bad"])


def test_read_gif_resize_within_one_level_of_jax(gif_dir):
    """read_gif(size): the port resizes through K2's arithmetic, rounded to
    nearest; the JAX package through cv2. Same-size reads are identical."""
    pytest.importorskip("cv2")
    from gifgan_tpu.data import video as jvideo

    same = tvideo.read_gif(gif_dir["same"][1], device="cpu")
    assert np.array_equal(same, jvideo.read_gif(gif_dir["same"][1]))
    assert np.array_equal(tvideo.read_gif(gif_dir["same"][1], 24,
                                          device="cpu"), same)
    got = tvideo.read_gif(gif_dir["big"], 16, device="cpu")
    want = jvideo.read_gif(gif_dir["big"], 16)
    assert got.shape == want.shape == (6, 16, 16, 3)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_default_clip_decode_matches_jax(gif_dir):
    pytest.importorskip("cv2")
    from gifgan_tpu.data import loader as jloader

    # same size, longer than `length`: cut; shorter: padded with the last
    for path, length in ((gif_dir["same"][2], 4), (gif_dir["short"], 5)):
        got = tloader.default_clip_decode(path, length, 24, device="cpu")
        want = jloader.default_clip_decode(path, length, 24)
        assert got.shape == (length, 24, 24, 3) and got.dtype == np.uint8
        assert np.array_equal(got, want)
    assert np.array_equal(tloader.decode_clip_source(gif_dir["short"], 5)[2],
                          tloader.decode_clip_source(gif_dir["short"], 5)[4])
    # another size: resized, within 1 grey level of the cv2 result
    got = tloader.default_clip_decode(gif_dir["big"], 4, 16, device="cpu")
    want = jloader.default_clip_decode(gif_dir["big"], 4, 16)
    assert got.shape == want.shape == (4, 16, 16, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # the workers' decode keeps the source size
    assert tloader.decode_clip_source(gif_dir["big"], 4).shape == (4, 40, 32,
                                                                   3)


def test_mp4_functions_roundtrip(tmp_path):
    pytest.importorskip("cv2")
    from gifgan_tpu.data import video as jvideo

    clip = np.repeat(np.repeat(_clip(3, t=5, h=8, w=8), 4, 1), 4, 2)
    path = str(tmp_path / "a.mp4")
    tvideo.encode_mp4(path, clip)
    got = tvideo.decode_clip(path, 4, 16)
    assert got.shape == (4, 16, 16, 3)
    assert np.array_equal(got, jvideo.decode_clip(path, 4, 16))
    assert tvideo.decode_clip(path, 4, None).shape == (4, 32, 32, 3)
    assert tvideo.decode_clip_batch([path, path], 3, 16).shape == (
        2, 3, 16, 16, 3)
    with pytest.raises(tvideo.ClipTooShortError):
        tvideo.decode_clip(path, 9, 16)
    assert tvideo.decode_clip(path, 9, 16, strict=False).shape[0] == 9
    assert tloader.decode_clip_source(path, 7).shape == (7, 32, 32, 3)
    out = str(tmp_path / "a.gif")
    tvideo.video_to_gif(path, out)
    assert tvideo.read_gif(out, device="cpu").shape == (5, 32, 32, 3)


@pytest.mark.parametrize("fold_time", [True, False], ids=["fold", "clips"])
def test_clip_batches_match_jax(gif_dir, fold_time):
    """Same seed: the same shuffle order, shapes and values, with the broken
    file skipped and reported and the batch backfilled."""
    from gifgan_tpu.data import loader as jloader

    paths = gif_dir["same"][:2] + [gif_dir["bad"]] + gif_dir["same"][2:]
    kw = dict(batch_size=2, length=4, size=24, epochs=2, seed=3, workers=2,
              fold_time=fold_time)
    jerr, terr = [], []
    want = list(jloader.clip_batches_from_files(
        paths, on_error=lambda p, e: jerr.append(p), **kw))
    got = list(tloader.clip_batches_from_files(
        paths, on_error=lambda p, e: terr.append(p), device="cpu", **kw))
    assert len(got) == len(want) == 4          # 5 good files -> 2 per epoch
    assert terr == jerr == [gif_dir["bad"]] * 2
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        assert g.shape == w.shape == ((8, 24, 24, 3) if fold_time
                                      else (2, 4, 24, 24, 3))
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6)
        assert float(g.min()) >= -1.0 and float(g.max()) <= 1.0


def test_clip_batches_always_go_through_resize_normalize(gif_dir,
                                                        monkeypatch):
    """One path for every dataset: clips already at `size` take K2's wrapper
    too (identity taps), once per batch, so the launch count on the card
    does not depend on the files' size."""
    from gifgan_tpu_torch.kernels import resize as tresize

    calls = []
    real = tresize.resize_normalize

    def spy(frames, *a, **kw):
        calls.append(tuple(frames.shape))
        return real(frames, *a, **kw)

    monkeypatch.setattr(tresize, "resize_normalize", spy)
    got = list(tloader.clip_batches_from_files(
        gif_dir["same"][:4], batch_size=2, length=4, size=24, shuffle=False,
        workers=2, device="cpu"))
    assert len(got) == 2 and calls == [(8, 24, 24, 3)] * 2
    want = tloader.decode_clip_source(gif_dir["same"][0], 4) / 127.5 - 1.0
    np.testing.assert_allclose(got[0][:4].numpy(), want, atol=1e-6)


def test_clip_batches_resize_mixed_sizes(gif_dir):
    """A batch that mixes sizes: one resize per size group, clips stay in
    order; against the JAX feed (cv2 resize) within 1.5 / 127.5; raw
    (normalize=False) batches are the float32 of the uint8 path."""
    pytest.importorskip("cv2")
    from gifgan_tpu.data import loader as jloader

    paths = [gif_dir["same"][0], gif_dir["big"], gif_dir["same"][1],
             gif_dir["short"]]
    kw = dict(batch_size=4, length=4, size=16, shuffle=False, workers=2)
    (want,) = jloader.clip_batches_from_files(paths, **kw)
    (got,) = tloader.clip_batches_from_files(paths, device="cpu", **kw)
    assert got.shape == want.shape == (16, 16, 16, 3)
    assert np.abs(got.numpy() - want).max() <= 1.5 / 127.5
    (raw,) = tloader.clip_batches_from_files(paths, normalize=False,
                                             fold_time=False, device="cpu",
                                             **kw)
    assert raw.shape == (4, 4, 16, 16, 3) and float(raw.max()) > 1.0
    np.testing.assert_allclose(raw.reshape(16, 16, 16, 3) / 127.5 - 1.0, got,
                               atol=1e-6)
    for i, p in enumerate(paths):
        one = tloader.default_clip_decode(p, 4, 16, device="cpu")
        assert np.abs(raw[i].numpy() - one).max() <= 0.5


def test_decode_workers_get_no_device_and_errors_propagate(gif_dir):
    """A custom decode_fn runs on the worker threads with the path alone;
    without on_error a failed file is still skipped."""
    seen = []

    def decode_fn(path):
        seen.append(threading.current_thread().name)
        if path.endswith("c1.gif"):
            raise OSError("unreadable")
        return tloader.decode_clip_source(path, 3)

    batches = list(tloader.clip_batches_from_files(
        gif_dir["same"], batch_size=2, length=3, size=24, shuffle=False,
        workers=2, decode_fn=decode_fn, device="cpu"))
    assert len(batches) == 2 and len(seen) == 5
    assert all(n != threading.main_thread().name for n in seen)
    want = tloader.decode_clip_source(gif_dir["same"][2], 3) / 127.5 - 1.0
    np.testing.assert_allclose(batches[0][3:].numpy(), want, atol=1e-6)


def test_batches_from_array_matches_jax():
    from gifgan_tpu.data import loader as jloader

    data = np.arange(22 * 3).reshape(22, 3)
    for kw in (dict(shuffle=True, seed=5, epochs=2),
               dict(shuffle=False, drop_remainder=False)):
        got = list(tloader.batches_from_array(data, 4, **kw))
        want = list(jloader.batches_from_array(data, 4, **kw))
        assert len(got) == len(want)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_prefetch_loader_yields_in_order_and_releases_its_thread():
    def source():
        for i in range(1000):
            yield np.full((2,), i)

    loader = tloader.PrefetchLoader(source(), depth=2,
                                    device_put=torch.from_numpy)
    first = [next(loader) for _ in range(3)]
    assert [int(b[0]) for b in first] == [0, 1, 2]
    assert isinstance(first[0], torch.Tensor)
    thread = loader._thread
    assert thread.is_alive()
    loader.close()
    thread.join(timeout=5.0)
    assert not thread.is_alive()
    loader.close()                               # idempotent

    done = tloader.PrefetchLoader(iter([1, 2]))
    assert list(done) == [1, 2]

    def failing():
        yield 1
        raise RuntimeError("decode blew up")

    bad = tloader.PrefetchLoader(failing())
    assert next(bad) == 1
    with pytest.raises(RuntimeError, match="blew up"):
        next(bad)
    deadline = time.time() + 5.0
    while bad._thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    assert not bad._thread.is_alive()
