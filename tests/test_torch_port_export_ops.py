"""PyTorch port: the kernels as `torch.library` operators, and `export
--kind segpp`, f32 on the CPU.

`torch.library.opcheck` on each of the five kernel operators (schema,
autograd registration, the fake version against the real one, AOT dispatch
with dynamic shapes). The YOLO-Seg++ end-to-end program exported from a
seeded YOLO-Seg++ `.ckpt` at 64^2: its mask uint8 (1, 64, 64, 1) in
{0, 1}, equal to the live `YOLOSegPP`'s sigmoid thresholded at 0.5, and
its graph's kernel operators, 8 of kernel A and 1 of kernel B. The yolo
program against the JAX package's is in `test_torch_port_export.py`.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from yolou_tpu_torch import __main__ as port_main
from yolou_tpu_torch.engine.exporter import ExportedModel
from yolou_tpu_torch.kernels.a2c2f import a2c2f_op
from yolou_tpu_torch.kernels.attention import (band_attention_op,
                                               band_attention_qkv_op,
                                               band_attention_single_op)
from yolou_tpu_torch.kernels.nms import greedy_nms_op
from yolou_tpu_torch.models.segpp import build_segpp
from yolou_tpu_torch.utils.model_io import load_model, save_model

from .test_torch_port_export import CPU, KERNEL_OPS
from .test_torch_port_slice import IMGSZ
from .torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def imgs():
    return np.random.default_rng(5).integers(0, 256, (1, IMGSZ, IMGSZ, 4),
                                             dtype=np.uint8)


@pytest.fixture(scope="module")
def segpp_ckpt(tmp_path_factory, imgs):
    """A YOLO-Seg++ file of weights drawn with numpy as `_draw` draws JAX
    variables (conv kernels N(0, 1/fan_in), BatchNorm scale 1 + N(0, .1),
    running variance in [0.5, 1)), its decoder's output bias centred on the
    seeded image (random weights give mask logits of one sign otherwise)."""
    model = build_segpp("yolov12", "n", nc=1, ch=4, device="cpu")
    rng = np.random.default_rng(11)
    sd = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked") or ".dfl." in name:
            sd[name] = t
            continue
        if name.endswith("running_var"):
            a = rng.random(t.shape) * 0.5 + 0.5
        elif t.dim() == 4:
            a = rng.normal(0, t[0].numel() ** -0.5, t.shape)
        elif name.endswith(".weight"):             # BatchNorm scale
            a = 1.0 + rng.normal(0, 0.1, t.shape)
        else:                                     # biases, running means
            a = rng.normal(0, 0.1, t.shape)
        sd[name] = torch.from_numpy(a.astype(np.float32))
    model.load_state_dict(sd, strict=True)
    x = torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        model.output.bias -= model(x)[0].median()
    path = str(tmp_path_factory.mktemp("export_segpp") / "segpp.ckpt")
    save_model(path, model)
    return path


def test_export_segpp_mask_matches_the_live_model(segpp_ckpt, imgs,
                                                  tmp_path):
    out = str(tmp_path / "segpp")
    meta = port_main.main(["export", "--kind", "segpp", "--model",
                           segpp_ckpt, "--out", out, "--imgsz", str(IMGSZ),
                           "--batch", "1", *CPU])
    assert meta["kind"] == "segpp" and meta["platforms"] == ["cpu"]
    ex = ExportedModel(out)
    mask, boxes, conf, valid = ex(imgs)
    assert mask.shape == (1, IMGSZ, IMGSZ, 1) and mask.dtype == torch.uint8
    assert set(mask.unique().tolist()) == {0, 1}
    model = load_model(segpp_ckpt, device="cpu")
    x = torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        logits, _ = model(x)
    want = (torch.sigmoid(logits) > 0.5).to(torch.uint8).permute(0, 2, 3, 1)
    assert torch.equal(mask, want)
    assert boxes.shape == (1, 300, 4) and valid.dtype == torch.bool
    ops = Counter(str(n.target) for n in ex.program.graph.nodes
                  if str(n.target).startswith("yolou."))
    assert dict(ops) == KERNEL_OPS


def _opcheck_cases():
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32))

    ws = [t(*sh, scale=0.1) for sh in
          [(8, 32), (32,)] + [(32, 96), (96,), (7, 7, 32), (32,), (32, 32),
                              (32,), (32, 64), (64,), (64, 32), (32,)] * 2
          + [(64, 16), (16,)]]
    boxes = torch.tensor([[[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30],
                           [21, 21, 31, 31]]], dtype=torch.float32)
    return {
        "band_attention_qkv": (band_attention_qkv_op,
                               [t(2, 9, 64).requires_grad_(),
                                t(64, 192, scale=0.1), t(192), 2]),
        "band_attention": (band_attention_op,
                           [t(2, 9, 64).requires_grad_(), t(2, 9, 64),
                            t(2, 9, 64), 2]),
        "band_attention_single": (band_attention_single_op,
                                  [t(2, 9, 32).requires_grad_(),
                                   t(2, 9, 32), t(2, 9, 32)]),
        "greedy_nms": (greedy_nms_op,
                       [boxes, torch.tensor([[True, True, True, False]]),
                        0.45]),
        "a2c2f": (a2c2f_op, [t(1, 4, 4, 8), ws, 1, 1, 1]),
    }


@pytest.mark.parametrize("name", ["band_attention_qkv", "band_attention",
                                  "band_attention_single", "greedy_nms",
                                  "a2c2f"])
def test_kernel_operator_passes_opcheck(name):
    """Schema, autograd registration (the attention operators' backward
    with an input that requires grad), the fake version against the real
    one, and AOT dispatch with dynamic shapes, on CPU tensors."""
    op, args = _opcheck_cases()[name]
    res = torch.library.opcheck(op, args)
    assert set(res.values()) == {"SUCCESS"}, res
