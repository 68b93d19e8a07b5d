"""PyTorch port: the predictor's video, stream, camera, screenshot, PIL and
HEIC sources against the JAX package's `load_source`, on the CPU.

A clip is written with `cv2.VideoWriter` (MJPG in an `.avi`); both packages
decode it with `cv2.VideoCapture`, so names and arrays must be equal
exactly, for 4-, 3- and 1-channel models (the 3-channel BGR frames are
widened with their mean, or cut). Neither machine has a camera, a display,
a network stream or `pillow_heif`: those routes run against stubs set into
`sys.modules` (`cv2`, `mss`) for both packages' calls, and by their errors.
The Predictor over the clip is held to the JAX Predictor at
`test_torch_port_predictor.py`'s tolerances.
"""

import sys
import types

import cv2
import numpy as np
import pytest
from PIL import Image, ImageGrab

from yolou_tpu.engine import predictor as jpred
from yolou_tpu_torch.engine import predictor as tpred

from .test_torch_port_slice import IMGSZ, models  # noqa: F401
from .torch_threads import one_torch_thread  # noqa: F401

FRAMES = 6


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("video") / "clip.avi")
    rng = np.random.default_rng(0)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (56, 40))
    assert writer.isOpened()
    for _ in range(FRAMES):
        writer.write(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8))
    writer.release()
    return path


def _same(got, want):
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("channels", [4, 3, 1])
def test_video_matches_jax(clip, channels):
    want = jpred.load_source(clip, channels=channels)
    got = tpred.load_source(clip, channels=channels)
    assert len(got) == FRAMES and got[0][1].shape == (40, 56, channels)
    assert got[-1][0] == f"{clip}#frame{FRAMES - 1}"
    _same(got, want)


@pytest.mark.parametrize("stride", [2, 4])
def test_video_stride_matches_jax(clip, stride):
    want = jpred._read_video_frames(clip, stride=stride)
    got = tpred._read_video_frames(clip, stride=stride)
    assert [p for p, _ in got] == [f"{clip}#frame{i}"
                                   for i in range(0, FRAMES, stride)]
    _same(got, want)


def _pil(mode, seed):
    arr = np.random.default_rng(seed).integers(
        0, 256, (24, 32, len(mode)), dtype=np.uint8)
    return Image.fromarray(arr[..., 0] if mode == "L" else arr)


@pytest.mark.parametrize("kind", ["single", "list", "mixed"])
@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L"])
@pytest.mark.parametrize("channels", [4, 3, 1])
def test_pil_matches_jax(clip, kind, mode, channels):
    if kind == "single":
        source = _pil(mode, 1)
    elif kind == "list":
        source = [_pil(mode, 1), _pil(mode, 2)]
    else:
        arr = np.random.default_rng(3).integers(0, 256, (24, 32, 4),
                                                dtype=np.uint8)
        source = [arr, _pil(mode, 2), clip.replace("clip.avi", "x.png")]
        cv2.imwrite(source[2], arr)
    want = jpred.load_source(source, channels=channels)
    got = tpred.load_source(source, channels=channels)
    names = {"single": ["pil_0"], "list": ["pil_0", "pil_1"],
             "mixed": ["array_0", "pil_1", "png"]}[kind]
    assert [p if p.startswith(("pil", "array")) else "png"
            for p, _ in got] == names
    _same(got, want)


# ---------------------------------------------------------------- stubs

def fake_cv2(frames, opens=True):
    """A `cv2` module whose VideoCapture gives `frames` in turn (for any
    source) and records the sources it was asked for."""
    asked = []

    class VideoCapture:
        def __init__(self, source):
            asked.append(source)
            self._left = list(frames) if opens else []
            self._open = opens

        def isOpened(self):
            return self._open

        def read(self):
            if not self._left:
                return False, None
            return True, self._left.pop(0)

        def release(self):
            self._open = False

    return types.SimpleNamespace(VideoCapture=VideoCapture, asked=asked)


def fake_mss(shot):
    class Screen:
        monitors = [{"all": 1}, {"first": 1}, {"second": 1}]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def grab(self, mon):
            return shot + 10 * (mon == self.monitors[2])

    return types.SimpleNamespace(mss=Screen)


def _both(source, **kw):
    return (jpred.load_source(source, **kw), tpred.load_source(source, **kw))


def _frames(n, shape=(16, 20, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]


def test_stream_matches_jax_through_a_stub(monkeypatch):
    """At most 32 frames of a stream, `url#frameN`; `stride` on the reader."""
    cv = fake_cv2(_frames(40))
    monkeypatch.setitem(sys.modules, "cv2", cv)
    url = "rtsp://camera.local/live"
    want, got = _both(url)
    assert len(got) == 32 and got[31][0] == f"{url}#frame31"
    _same(got, want)
    assert cv.asked == [url, url]
    want = jpred._read_stream_frames(url, max_frames=5, stride=3)
    got = tpred._read_stream_frames(url, max_frames=5, stride=3)
    assert [p for p, _ in got] == [f"{url}#frame{i}" for i in range(0, 15, 3)]
    _same(got, want)


@pytest.mark.parametrize("source", [0, "1"])
@pytest.mark.parametrize("shape", [(16, 20, 3), (16, 20)])
def test_camera_matches_jax_through_a_stub(monkeypatch, source, shape):
    cv = fake_cv2(_frames(3, shape))
    monkeypatch.setitem(sys.modules, "cv2", cv)
    want, got = _both(source, channels=3)
    assert [p for p, _ in got] == [f"webcam{int(source)}#frame0"]
    _same(got, want)
    assert cv.asked == [int(source)] * 2


@pytest.mark.parametrize("spec", ["screen", "screen1"])
def test_screenshot_matches_jax_through_a_stub(monkeypatch, spec):
    shot = np.random.default_rng(4).integers(0, 200, (12, 18, 4),
                                             dtype=np.uint8)
    monkeypatch.setitem(sys.modules, "mss", fake_mss(shot))
    want, got = _both(spec)
    assert [p for p, _ in got] == [spec] and got[0][1].shape == (12, 18, 4)
    _same(got, want)


def _no_display(*args, **kwargs):
    raise OSError("X connection failed")


@pytest.mark.parametrize("source,error", [
    ("rtsp://camera.local/live", IOError), ("http://h/v.mjpg", IOError),
    (0, RuntimeError), ("3", RuntimeError), ("screen", RuntimeError)])
def test_routes_that_do_not_open_raise_as_jax(monkeypatch, source, error):
    """A stream that does not open: IOError; a camera: RuntimeError; a
    screenshot without `mss` or a display: RuntimeError."""
    monkeypatch.setitem(sys.modules, "cv2", fake_cv2([], opens=False))
    monkeypatch.setitem(sys.modules, "mss", None)
    monkeypatch.setattr(ImageGrab, "grab", _no_display)
    for load in (jpred.load_source, tpred.load_source):
        with pytest.raises(error):
            load(source)


def test_camera_without_frames_raises_as_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", fake_cv2([]))
    for load in (jpred.load_source, tpred.load_source):
        with pytest.raises(RuntimeError, match="produced no frames"):
            load(0)


def test_heic_without_the_plugin_raises_as_jax(tmp_path, monkeypatch):
    path = str(tmp_path / "scan.heic")
    with open(path, "wb") as f:
        f.write(b"\x00\x00\x00\x18ftypheic" + bytes(64))
    monkeypatch.setitem(sys.modules, "pillow_heif", None)
    for load in (jpred.load_source, tpred.load_source):
        with pytest.raises(IOError, match="pillow-heif"):
            load(path)
        with pytest.raises(IOError, match="pillow-heif"):
            load([path])


def test_predictor_over_a_clip_matches_jax(models, clip):
    """Every frame of the clip through both predictors at 64^2: the same
    names in order, boxes within 1e-3 px, masks equal on all but 1e-3 of
    the pixels."""
    jmod, variables, tmod = models
    want = jpred.Predictor(jmod, variables, imgsz=IMGSZ, batch_size=4)(clip)
    got = tpred.Predictor(tmod, imgsz=IMGSZ, batch_size=4)(clip)
    assert [r.path for r in got] == [r.path for r in want] == [
        f"{clip}#frame{i}" for i in range(FRAMES)]
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        np.testing.assert_allclose(g.boxes.data, w.boxes.data, atol=1e-3,
                                   rtol=0)
        assert g.masks.data.shape == w.masks.data.shape
        assert g.masks.data.shape[1:] == (40, 56)
        assert np.mean(g.masks.data != w.masks.data) <= 1e-3
