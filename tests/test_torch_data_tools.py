"""The port's data-collection tools against the JAX package's, on the same
seeded inputs: frame sampling, re-encoding and frame extraction
(gifgan_tpu_torch/data/video.py sample_frames_from_video, bulk_resize,
video_to_gif, video_to_frames), the dataset downloaders (data/download.py)
and the keyword scraper (data/scrape.py), both with a stubbed fetch: no
test touches the network.

Tolerances: the mp4 paths make the same cv2 calls as the JAX package, so
their frames are equal; a GIF's sampled frames are resized by K2's plain
version in the port and by cv2.INTER_LINEAR in the JAX package, within one
grey level (K2's contract). The host code (downloaders, scraper) gives the
same files, trees and counts.
"""

import gzip
import io
import os
import zipfile

import cv2
import numpy as np
import pytest
import torch

from gifgan_tpu.data import download as jdownload
from gifgan_tpu.data import scrape as jscrape
from gifgan_tpu.data import video as jvideo
from gifgan_tpu_torch.data import download as tdownload
from gifgan_tpu_torch.data import scrape as tscrape
from gifgan_tpu_torch.data import video as tvideo
from gifgan_tpu_torch.data.synthetic import synthetic_clip
from gifgan_tpu_torch.track.boxes import Detection


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    in each keeps this file's many small tensor ops from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(seed, length, h, w):
    """A seeded (length, h, w, 3) uint8 clip with texture and motion."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, 3)).astype(np.uint8)
    big = cv2.resize(base, (w + 8 * length, h + 8),
                     interpolation=cv2.INTER_LINEAR)
    return np.stack([big[4:4 + h, 3 * t:3 * t + w] for t in range(length)])


def _write_mp4(path, frames, fps=25.0):
    tvideo.encode_mp4(path, frames, fps=fps)
    return path


def _read_png(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


def test_sample_frames_from_a_gif_within_one_grey_level(tmp_path):
    path = str(tmp_path / "c.gif")
    tvideo.write_gif(path, _clip(0, 12, 48, 40))
    cap = cv2.VideoCapture(path)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 12   # counts agree
    cap.release()
    rt, rj = np.random.default_rng(5), np.random.default_rng(5)
    for n, size in ((5, 16), (20, 24)):
        got = tvideo.sample_frames_from_video(path, n, size, rt,
                                              device="cpu")
        want = jvideo.sample_frames_from_video(path, n, size, rj)
        assert len(got) == len(want) == min(n, 12)
        for g, w in zip(got, want):
            assert g.shape == w.shape == (size, size, 3)
            assert g.dtype == np.uint8
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
    # the two generators drew alike
    assert rt.integers(1 << 30) == rj.integers(1 << 30)


def test_sample_frames_from_an_mp4_equal(tmp_path):
    path = _write_mp4(str(tmp_path / "c.mp4"), _clip(1, 9, 40, 56))
    rt, rj = np.random.default_rng(2), np.random.default_rng(2)
    got = tvideo.sample_frames_from_video(path, 4, 32, rt, device="cpu")
    want = jvideo.sample_frames_from_video(path, 4, 32, rj)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_bulk_resize_and_video_to_gif_equal(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    _write_mp4(str(src / "long.mp4"), _clip(2, 10, 40, 48))
    _write_mp4(str(src / "short.mp4"), _clip(3, 4, 40, 48))
    (src / "notes.txt").write_text("skipped: not an mp4")
    got = tvideo.bulk_resize(str(src), str(tmp_path / "t"), 24, 8)
    want = jvideo.bulk_resize(str(src), str(tmp_path / "j"), 24, 8)
    assert got == want == {"written": 1, "skipped_short": 1, "errors": 0}
    assert os.listdir(tmp_path / "t") == os.listdir(tmp_path / "j") \
        == ["long.mp4"]
    np.testing.assert_array_equal(
        tvideo.decode_clip(str(tmp_path / "t" / "long.mp4"), 8, None),
        tvideo.decode_clip(str(tmp_path / "j" / "long.mp4"), 8, None))

    tvideo.video_to_gif(str(src / "long.mp4"), str(tmp_path / "t.gif"),
                        fps=5.0)
    jvideo.video_to_gif(str(src / "long.mp4"), str(tmp_path / "j.gif"),
                        fps=5.0)
    np.testing.assert_array_equal(tvideo.read_gif(str(tmp_path / "t.gif")),
                                  tvideo.read_gif(str(tmp_path / "j.gif")))


def test_video_to_frames_with_an_injected_detector_equal(tmp_path):
    from gifgan_tpu.track.boxes import Detection as JDetection

    vp = _write_mp4(str(tmp_path / "v.mp4"), synthetic_clip(0, length=25,
                                                            size=96), fps=25)

    def detector(cls):
        def det(frame, i):
            if i >= 10:
                return []
            # two faces: the biggest decides the crop
            return [cls(5, 5, 20, 20, i), cls(30 + i, 20, 80 + i, 70, i)]
        return det

    for name, kw in (("plain", dict(rate=5)),
                     ("faces", dict(rate=25, crop_size=40))):
        got = tvideo.video_to_frames(vp, str(tmp_path / f"t_{name}"),
                                     detector=detector(Detection)
                                     if name == "faces" else None, **kw)
        want = jvideo.video_to_frames(vp, str(tmp_path / f"j_{name}"),
                                      detector=detector(JDetection)
                                      if name == "faces" else None, **kw)
        assert got == want, name
        files = sorted(os.listdir(tmp_path / f"t_{name}"))
        assert files == sorted(os.listdir(tmp_path / f"j_{name}"))
        assert len(files) == got["kept"] > 0
        for f in files:
            np.testing.assert_array_equal(
                _read_png(tmp_path / f"t_{name}" / f),
                _read_png(tmp_path / f"j_{name}" / f))
    assert got["no_face"] == 15 and got["kept"] == 10
    assert _read_png(tmp_path / "t_faces" / files[0]).shape == (40, 40, 3)


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_downloaders_with_a_stubbed_fetch_write_the_same_files(tmp_path):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("celebA/0001.jpg", b"fake")
    urls = {"t": [], "j": []}

    def fetch(side):
        def f(url):
            urls[side].append(url)
            if url.endswith(".gz"):
                return gzip.compress(url.encode() * 3)
            if "celebA" in url:
                return buf.getvalue()
            return url.encode()
        return f

    for side, mod in (("t", tdownload), ("j", jdownload)):
        d = str(tmp_path / side)
        written = mod.download_mnist(d, fetch(side))
        assert [os.path.relpath(p, d) for p in written] == [
            os.path.join("mnist", n[:-3]) for n in mod.MNIST_FILES]
        assert mod.download_mnist(d, fetch(side)) == []     # resumes
        out = mod.download_celeb_a(d, "http://x/celebA.zip", fetch(side))
        assert os.path.relpath(out, d) == "celebA"
        assert len(mod.download_lsun(d, ["bedroom", "tower"],
                                     fetch_fn=fetch(side))) == 2
        assert len(mod.download_lsun(d, fetch_fn=fetch(side))) == 8
    assert urls["t"] == urls["j"]
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    assert tdownload.MNIST_BASE == jdownload.MNIST_BASE
    assert tdownload.LSUN_CATEGORIES == jdownload.LSUN_CATEGORIES


_PAYLOAD = ('{"data":[{"images":{"original":{'
            '"mp4":"https:\\/\\/media.giphy.com\\/media\\/abc123\\/giphy.mp4"'
            '}}},{"images":{"original":{'
            '"mp4":"https:\\/\\/media.giphy.com\\/media\\/def456\\/giphy.mp4"'
            '}}}]}')


def _fetch(url):
    if "search" in url:
        return _PAYLOAD.encode()
    return b"MP4:" + url.encode()


def _stats(s):
    return s.new_total, dict(s.per_keyword), s.errors


@pytest.mark.parametrize("keywords", [["face"], ["face", "smile face"],
                                      ["../escape", "a/b", "  "]])
def test_scraper_gives_the_same_tree_and_stats(tmp_path, keywords):
    text = "tried\n# keywords not tried yet\n" + "\n\n".join(keywords) + "\n"
    assert tscrape.parse_keywords(text) == jscrape.parse_keywords(text)
    assert tscrape.extract_mp4_urls(_PAYLOAD) == \
        jscrape.extract_mp4_urls(_PAYLOAD)
    for side, mod in (("t", tscrape), ("j", jscrape)):
        out = tmp_path / side / "out"
        out.mkdir(parents=True)
        s = mod.Scraper(str(out), _fetch, num_threads=2,
                        items_per_thread=200)
        stats = s.scrape(keywords)
        # a second scraper seeds its dedup set from the tree: nothing new
        again = mod.Scraper(str(out), _fetch, num_threads=1,
                            items_per_thread=100).scrape(keywords)
        if side == "t":
            got = (_stats(stats), _stats(again), _tree(tmp_path / side))
        else:
            want = (_stats(stats), _stats(again), _tree(tmp_path / side))
    assert got == want
    assert got[0][0] == 2 and got[1][0] == 0
    # nothing escaped the output directory
    assert all(p.startswith("out" + os.sep) for p in got[2])


def test_scraper_failures_and_duplicates_as_the_jax_package(tmp_path):
    def always_fail(url):
        raise IOError("net down")

    for mod in (tscrape, jscrape):
        s = mod.Scraper(str(tmp_path / mod.__name__), always_fail,
                        num_threads=2, items_per_thread=10000,
                        max_consecutive_failures=3)
        assert _stats(s.scrape(["x"])) == (0, {}, 6)
    (tmp_path / "d" / "a").mkdir(parents=True)
    (tmp_path / "d" / "b").mkdir()
    (tmp_path / "d" / "a" / "x1.mp4").write_bytes(b"")
    (tmp_path / "d" / "b" / "x1.mp4").write_bytes(b"")
    for mod in (tscrape, jscrape):
        with pytest.raises(RuntimeError, match="duplicate"):
            mod.scan_existing(str(tmp_path / "d"))
