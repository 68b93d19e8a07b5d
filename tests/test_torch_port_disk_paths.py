"""PyTorch port: the disk paths against the JAX package's, which reads and
writes through cv2, on one synthetic directory at 64^2.

The port's side runs with `cv2` blocked (`sys.modules["cv2"] = None`, so
any import of it raises). `YoloSegDataset.item`, `item_idmap` and
`item_rect` (at a down-scale, an up-scale and the stored size, two images
cropped to other aspects) and `DecoderDataset.item_u8` must equal JAX's
byte for byte. The generators' files are compared with the models stubbed
out on both sides by the same numpy functions of the images they are
given, so that the comparison is of what was read and written: the
objectmap `.npy` files byte for byte, the heatmap PNGs pixel for pixel
(the two encoders' zlib streams differ). `load_source` must route a
directory, a glob, a `.txt` list and a mixed list of paths and arrays to
JAX's (path, array) list, and raise what JAX raises where a stream, a
camera or a screen cannot be read (`test_torch_port_sources.py` has the
rest of the routes). `Predictor(retina_masks=True)` must give the
JAX predictor's Results on the same JAX-written `.ckpt`, at
`test_torch_port_predictor.py`'s tolerances (boxes within 1e-3 px, masks
equal on all but 1e-3 of the pixels).
"""

import os
import sys
import types

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.data import decoder_dataset as jdd
from yolou_tpu.data import synthetic as jax_synthetic
from yolou_tpu.data import yolo_dataset as jds
from yolou_tpu.engine import generate as jgen
from yolou_tpu.engine import predictor as jpred
from yolou_tpu.utils.model_io import save_model as jax_save_model
from yolou_tpu_torch.data import decoder_dataset as tdd
from yolou_tpu_torch.data import yolo_dataset as tds
from yolou_tpu_torch.engine import generate as tgen
from yolou_tpu_torch.engine import predictor as tpred
from yolou_tpu_torch.utils.model_io import load_model

from .test_torch_port_slice import IMGSZ, models  # noqa: F401
from .torch_threads import one_torch_thread  # noqa: F401

SPLITS = {"train": 6, "val": 5}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A synthetic directory at 64^2; two val images cropped to 48x64 and
    64x40 (labels renormalised) for the resize and rect paths."""
    r = str(tmp_path_factory.mktemp("disk"))
    jax_synthetic.generate(r, SPLITS, size=IMGSZ, seed=3)
    img_dir = os.path.join(r, "images", "val")
    for name, (h, w) in (("val_0001", (48, 64)), ("val_0003", (64, 40))):
        path = os.path.join(img_dir, name + ".png")
        cv2.imwrite(path, cv2.imread(path, cv2.IMREAD_UNCHANGED)[:h, :w])
        label = jds.img2label_path(path)
        rows = [f"{c} " + " ".join(
            f"{v:.6f}" for v in np.clip(p * IMGSZ / np.array([w, h]), 0, 1
                                        ).reshape(-1))
            for c, p in jds.parse_label_file(label)]
        with open(label, "w") as f:
            f.write("\n".join(rows) + "\n")
    return r


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("imgsz", [48, 64, 96])
def test_yolo_dataset_items_are_jax_byte_for_byte(root, imgsz, monkeypatch):
    img_dir = os.path.join(root, "images", "val")
    theirs = jds.YoloSegDataset(img_dir, imgsz=imgsz, channels=4, cache=False)
    want = [(theirs.item(i), theirs.item_idmap(i),
             theirs.item_rect(i, (imgsz, imgsz + 32)))
            for i in range(len(theirs))]
    monkeypatch.setitem(sys.modules, "cv2", None)
    ours = tds.YoloSegDataset(img_dir, imgsz=imgsz, channels=4, cache=False)
    got = [(ours.item(i), ours.item_idmap(i),
            ours.item_rect(i, (imgsz, imgsz + 32)))
           for i in range(len(ours))]
    _equal(got, want)
    assert sum(len(it[0]["cls"]) for it in got) >= 2


@pytest.mark.parametrize("size", [48, 64])
def test_decoder_dataset_items_are_jax_byte_for_byte(root, size,
                                                     monkeypatch):
    args = (root, "images/train", "masks/train", size)
    theirs = jdd.DecoderDataset(*args, cache_images=False)
    want = [theirs.item_u8(i)[:2] for i in range(len(theirs))]
    monkeypatch.setitem(sys.modules, "cv2", None)
    ours = tdd.DecoderDataset(*args, cache_images=False)
    got = [ours.item_u8(i)[:2] for i in range(len(ours))]
    _equal(got, want)


def _stub_map(imgs):
    """A stride-8 'logit map' from the uint8 images, in float32."""
    x = np.asarray(imgs, np.float32)
    b, h, w, _ = x.shape
    return (x.reshape(b, h // 8, 8, w // 8, 8, -1).mean((2, 4, 5)) / 37.0
            - 1.3).astype(np.float32)


def _stub_boxes(img):
    """Boxes (xywh, conf) from an image's content."""
    rng = np.random.default_rng(int(np.asarray(img, np.int64).sum()))
    n = int(rng.integers(0, 4))
    xywh = rng.uniform(8, 56, (n, 4)).astype(np.float32)
    return xywh, rng.uniform(0.3, 1.0, n).astype(np.float32)


def _stub_splat(bxywh, conf, valid, size):
    b = np.asarray(bxywh, np.float32)
    c = np.asarray(conf, np.float32) * np.asarray(valid, np.float32)
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    d = ((xx[None, None] - b[..., 0, None, None]) ** 2
         + (yy[None, None] - b[..., 1, None, None]) ** 2)
    return (c[..., None, None] * np.exp(-d / 90.0)).max(1)


def test_generated_files_match_jax(root, tmp_path, monkeypatch):
    seen = {"jax": [], "port": []}

    def results(side, imgs):
        out = []
        for img in imgs:
            if isinstance(img, str):
                img = cv2.imread(img, cv2.IMREAD_UNCHANGED)
            seen[side].append(np.asarray(img))
            out.append(types.SimpleNamespace(boxes=_Boxes(*_stub_boxes(img))))
        return out

    jp = types.SimpleNamespace(
        raw_forward=lambda imgs: types.SimpleNamespace(
            raw=[_stub_map(imgs)[..., None]]),
        channels=4)
    jp_call = lambda imgs: results("jax", imgs)
    tp = types.SimpleNamespace(
        raw_forward=lambda imgs: types.SimpleNamespace(
            raw=[torch.from_numpy(_stub_map(imgs))[:, None]]),
        channels=4, device=torch.device("cpu"))
    monkeypatch.setattr(jgen, "splat_heatmaps", lambda b, c, v, size:
                        jnp.asarray(_stub_splat(b, c, v, size)))
    monkeypatch.setattr(tgen, "splat_heatmaps", lambda b, c, v, size:
                        torch.from_numpy(_stub_splat(b, c, v, size)))
    splits = ("train",)            # one image size a batch, as the generators need
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = (jgen.generate_objectmaps(jp, root, jax_dir, splits, 4),
            jgen.generate_heatmaps(_Callable(jp_call, jp), root, jax_dir,
                                   splits, IMGSZ, 4))
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = (tgen.generate_objectmaps(tp, root, port_dir, splits, 4),
           tgen.generate_heatmaps(_Callable(lambda imgs: results("port",
                                                                 imgs), tp),
                                  root, port_dir, splits, IMGSZ, 4))
    monkeypatch.undo()
    counts = {"train": SPLITS["train"]}
    assert got == want == (counts, counts)
    _equal(seen["port"], seen["jax"])
    n = 0
    for split in splits:
        for kind in ("objectmap", "heatmap"):
            names = sorted(os.listdir(os.path.join(jax_dir, kind, split)))
            assert names == sorted(os.listdir(os.path.join(port_dir, kind,
                                                           split)))
            for name in names:
                a, b = (os.path.join(d, kind, split, name)
                        for d in (jax_dir, port_dir))
                if kind == "objectmap":
                    with open(a, "rb") as fa, open(b, "rb") as fb:
                        assert fa.read() == fb.read(), name
                else:
                    _equal(cv2.imread(b, cv2.IMREAD_UNCHANGED),
                           cv2.imread(a, cv2.IMREAD_UNCHANGED))
                n += 1
    assert n == 2 * SPLITS["train"]


class _Boxes:
    def __init__(self, xywh, conf):
        self.xywh, self.conf = xywh, conf

    def __len__(self):
        return len(self.conf)


class _Callable:
    """A predictor stand-in: called with a batch, with the stub's other
    attributes."""

    def __init__(self, fn, base):
        self.fn, self.base = fn, base

    def __call__(self, imgs):
        return self.fn(imgs)

    def __getattr__(self, name):
        return getattr(self.base, name)


def _sources(root, tmp_path):
    img_dir = os.path.join(root, "images", "train")
    files = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))
    txt = tmp_path / "list.txt"
    txt.write_text("\n".join(files[:3]) + "\n\n")
    arr = np.random.default_rng(0).integers(0, 256, (40, 56, 3), np.uint8)
    return {"dir": img_dir, "glob": os.path.join(img_dir, "*_000[1-3].png"),
            "txt": str(txt), "mixed": [files[2], arr, files[0]],
            "file": files[4]}


@pytest.mark.parametrize("kind", ["dir", "glob", "txt", "mixed", "file"])
@pytest.mark.parametrize("channels", [4, 1])
def test_load_source_matches_jax(root, tmp_path, kind, channels,
                                 monkeypatch):
    src = _sources(root, tmp_path)[kind]
    want = jpred.load_source(src, channels)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = tpred.load_source(src, channels)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert len(got) >= 1
    for (_, g), (_, w) in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("source", ["rtsp://cam/1", "0", "screen", "a.mp4"])
def test_load_source_unported_routes_raise_by_name(source, monkeypatch):
    """The stream, camera, screenshot and video routes where nothing can
    feed them (a `cv2.VideoCapture` that never opens, no `mss`, no display):
    the port raises what the JAX package raises (IOError for the stream,
    RuntimeError for the camera and the screenshot), and a video that does
    not open gives no frame in both."""
    from .test_torch_port_sources import _no_display, fake_cv2
    from PIL import ImageGrab
    monkeypatch.setitem(sys.modules, "cv2", fake_cv2([], opens=False))
    monkeypatch.setitem(sys.modules, "mss", None)
    monkeypatch.setattr(ImageGrab, "grab", _no_display)
    try:
        want = jpred.load_source(source)
    except Exception as e:      # noqa: BLE001 - the type is compared
        with pytest.raises(type(e)) as got:
            tpred.load_source(source)
        assert type(got.value) is type(e) and type(e) in (OSError,
                                                          RuntimeError)
        assert not isinstance(got.value, NotImplementedError)
    else:
        assert want == [] and tpred.load_source(source) == []


def test_retina_predictor_matches_jax_on_a_jax_ckpt(models, root, tmp_path,
                                                    monkeypatch):
    """The val directory (64^2 and the two cropped images) through both
    predictors with `retina_masks=True`, the port's weights read from the
    `.ckpt` the JAX package wrote."""
    jmod, variables, _ = models
    path = str(tmp_path / "det.ckpt")
    jax_save_model(path, variables, nc=1, ch=4, task="segment")
    src = os.path.join(root, "images", "val")
    want = jpred.Predictor(jmod, variables, imgsz=IMGSZ, batch_size=2,
                           retina_masks=True)(src)
    monkeypatch.setitem(sys.modules, "cv2", None)
    tmod = load_model(path, device="cpu")
    got = tpred.Predictor(tmod, imgsz=IMGSZ, batch_size=2,
                          retina_masks=True)(src)
    assert len(got) == len(want) == SPLITS["val"]
    shapes = set()
    for g, w in zip(got, want):
        assert g.path == w.path
        assert len(g) == len(w) > 0
        np.testing.assert_allclose(g.boxes.data, w.boxes.data, atol=1e-3,
                                   rtol=0)
        assert g.masks.data.shape == w.masks.data.shape
        assert g.masks.data.shape[1:] == g.orig_img.shape[:2]
        assert np.mean(g.masks.data != w.masks.data) <= 1e-3
        shapes.add(g.orig_img.shape[:2])
    assert shapes == {(64, 64), (48, 64), (64, 40)}
