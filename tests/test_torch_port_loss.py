"""PyTorch port: box ops, the Task-Aligned Assigner and the v8 det/seg loss
against the JAX package, f32 on the CPU, on seeded batches at 64^2 (84
anchors over strides 8, 16, 32).

The assignment is integer work: every `AssignResult` field must be equal
(float fields within 1e-6). Loss parts within 1e-5 relative, the gradient
with respect to the raw head maps within 1e-4 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.losses.tal import task_aligned_assign as jax_assign
from yolou_tpu.losses.v8 import LossHyp as JaxLossHyp
from yolou_tpu.losses.v8 import v8_loss as jax_v8_loss
from yolou_tpu.ops import boxes as jax_boxes
from yolou_tpu_torch.losses.dice import bce_with_logits
from yolou_tpu_torch.losses.tal import task_aligned_assign
from yolou_tpu_torch.losses.v8 import LossHyp, v8_loss
from yolou_tpu_torch.ops import boxes

from .torch_threads import one_torch_thread  # noqa: F401

IMGSZ, STRIDES, REG_MAX, NM = 64, (8, 16, 32), 16, 32


def _xyxy(rng, shape, lo=4.0, hi=60.0):
    a = rng.uniform(lo, hi, shape + (2, 2)).astype(np.float32)
    return np.concatenate([a.min(-2), a.max(-2) + 2.0], -1)


def test_bbox_iou_aligned_and_bbox2dist_match_jax():
    rng = np.random.default_rng(0)
    b1, b2 = _xyxy(rng, (3, 40)), _xyxy(rng, (3, 40))
    for ciou in (False, True):
        want = jax_boxes.bbox_iou_aligned(b1, b2, ciou=ciou)
        got = boxes.bbox_iou_aligned(torch.from_numpy(b1),
                                     torch.from_numpy(b2), ciou=ciou)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # broadcast (B, G, 1, 4) x (B, 1, A, 4), as the assigner calls it
    want = jax_boxes.bbox_iou_aligned(b1[:, :5, None], b2[:, None], ciou=True)
    got = boxes.bbox_iou_aligned(torch.from_numpy(b1[:, :5, None]),
                                 torch.from_numpy(b2[:, None]), ciou=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    pts = rng.uniform(0, 8, (40, 2)).astype(np.float32)
    want = jax_boxes.bbox2dist(pts[None], b1 / 8, REG_MAX)
    got = boxes.bbox2dist(torch.from_numpy(pts)[None],
                          torch.from_numpy(b1 / 8), REG_MAX)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(
        boxes.xyxy2xywh(torch.from_numpy(b1)).numpy(),
        np.asarray(jax_boxes.xyxy2xywh(b1)), atol=1e-6)


def test_ciou_gradient_matches_jax():
    rng = np.random.default_rng(1)
    b1, b2 = _xyxy(rng, (30,)), _xyxy(rng, (30,))
    want = jax.grad(lambda a: jax_boxes.bbox_iou_aligned(
        a, b2, ciou=True).sum())(jnp.asarray(b1))
    t1 = torch.from_numpy(b1).requires_grad_()
    boxes.bbox_iou_aligned(t1, torch.from_numpy(b2), ciou=True).sum().backward()
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(want), atol=1e-5)


def _anchors():
    pts, strs = jax_boxes.make_anchors(
        [(IMGSZ // s, IMGSZ // s) for s in STRIDES], STRIDES)
    return np.array(pts * strs)


def _assign_inputs(seed, tied):
    rng = np.random.default_rng(seed)
    b, g, nc = 3, 5, 2
    anchors = _anchors()
    a = len(anchors)
    scores = rng.uniform(0.05, 0.95, (b, a, nc)).astype(np.float32)
    centre = np.repeat(anchors[None], b, 0)
    wh = rng.uniform(6, 30, (b, a, 2)).astype(np.float32)
    pred = np.concatenate([centre - wh / 2, centre + wh / 2], -1)
    gt = _xyxy(rng, (b, g))
    labels = rng.integers(0, nc, (b, g)).astype(np.int32)
    mask = rng.random((b, g)) < 0.8
    mask[:, 0] = True
    if tied:
        # a GT no anchor centre lies in (all metrics exactly 0: top-k falls
        # back to index order), two identical GTs (equal overlaps: the
        # collision argmax takes the first), and predictions far away
        gt[0, 0] = [1.0, 1.0, 3.0, 3.0]
        gt[1, 1] = gt[1, 0]
        mask[1, :2] = True
        pred[2] += 200.0
    return scores, pred.astype(np.float32), anchors, labels, gt, mask


@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied-zeros"])
def test_task_aligned_assign_matches_jax(tied):
    args = _assign_inputs(2 + tied, tied)
    want = jax_assign(*(jnp.asarray(a) for a in args))
    got = task_aligned_assign(*(torch.from_numpy(a) for a in args))
    assert int(got.fg_mask.sum()) > 0
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.shape == w.shape, f
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


def _loss_inputs(seed, nc=1, g=4, b=2):
    """Raw head maps (NHWC, the JAX layout), mask coefficients, protos and
    targets with rectangular instance masks."""
    rng = np.random.default_rng(seed)
    no = 4 * REG_MAX + nc
    raw = [rng.normal(0, 1, (b, IMGSZ // s, IMGSZ // s, no)).astype(np.float32)
           for s in STRIDES]
    a = sum(r.shape[1] * r.shape[2] for r in raw)
    mc = rng.normal(0, 0.5, (b, a, NM)).astype(np.float32)
    hm = IMGSZ // 4
    protos = rng.normal(0, 0.5, (b, hm, hm, NM)).astype(np.float32)
    xyxy = _xyxy(rng, (b, g), 6.0, 50.0).clip(0, IMGSZ)
    masks = np.zeros((b, g, hm, hm), np.float32)
    for i in range(b):
        for j in range(g):
            x1, y1, x2, y2 = (xyxy[i, j] / 4).round().astype(int)
            masks[i, j, y1:y2, x1:x2] = 1.0
    valid = np.ones((b, g), bool)
    valid[0, -1] = False
    targets = {"cls": rng.integers(0, nc, (b, g)).astype(np.int32),
               "bboxes": np.asarray(jax_boxes.xyxy2xywh(xyxy)) / IMGSZ,
               "valid": valid, "masks": masks}
    return raw, mc, protos, targets


def _torch_loss(raw, mc, protos, targets, **kw):
    traw = [torch.from_numpy(r.transpose(0, 3, 1, 2).copy()).requires_grad_()
            for r in raw]
    out = v8_loss(traw, torch.from_numpy(mc),
                  torch.from_numpy(protos.transpose(0, 3, 1, 2).copy()),
                  {k: torch.from_numpy(v) for k, v in targets.items()}, **kw)
    return traw, out


@pytest.mark.parametrize("nc,use_tversky", [(1, True), (3, True), (1, False)])
def test_v8_loss_and_gradient_match_jax(nc, use_tversky):
    raw, mc, protos, targets = _loss_inputs(5 + nc, nc=nc)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    def jloss(r):
        return jax_v8_loss(tuple(r), jnp.asarray(mc), jnp.asarray(protos), jt,
                           nc=nc, strides=STRIDES, reg_max=REG_MAX,
                           hyp=JaxLossHyp(use_tversky=use_tversky))

    want = jloss([jnp.asarray(r) for r in raw])
    wgrad = jax.grad(lambda r: jloss(r).total)([jnp.asarray(r) for r in raw])
    traw, got = _torch_loss(raw, mc, protos, targets, nc=nc, strides=STRIDES,
                            reg_max=REG_MAX,
                            hyp=LossHyp(use_tversky=use_tversky))
    for k in ("box", "cls", "dfl", "seg"):
        assert float(want.parts[k]) > 0, k
        np.testing.assert_allclose(got.parts[k].item(), float(want.parts[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got.total.item(), float(want.total), rtol=1e-5)
    got.total.backward()
    for t, w in zip(traw, wgrad):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(t.grad.numpy(), w,
                                   atol=1e-4 * np.abs(w).max(), rtol=0)


def test_v8_loss_detect_only_and_max_pos_cap_match_jax():
    raw, mc, protos, targets = _loss_inputs(11)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    jraw = tuple(jnp.asarray(r) for r in raw)
    want = jax_v8_loss(jraw, None, None, jt, nc=1, strides=STRIDES,
                       reg_max=REG_MAX, with_masks=False)
    traw = [torch.from_numpy(r.transpose(0, 3, 1, 2).copy()) for r in raw]
    tt = {k: torch.from_numpy(v) for k, v in targets.items()}
    got = v8_loss(traw, None, None, tt, nc=1, strides=STRIDES,
                  reg_max=REG_MAX, with_masks=False)
    assert got.parts["seg"].item() == 0.0
    np.testing.assert_allclose(got.total.item(), float(want.total), rtol=1e-5)
    want = jax_v8_loss(jraw, jnp.asarray(mc), jnp.asarray(protos), jt, nc=1,
                       strides=STRIDES, reg_max=REG_MAX, max_pos=3)
    _, got = _torch_loss(raw, mc, protos, targets, nc=1, strides=STRIDES,
                         reg_max=REG_MAX, max_pos=3)
    np.testing.assert_allclose(got.parts["seg"].item(),
                               float(want.parts["seg"]), rtol=1e-5)


def test_bce_with_logits_matches_torch():
    z = torch.linspace(-30, 30, 61)
    g = torch.rand(61, generator=torch.Generator().manual_seed(0))
    want = torch.nn.functional.binary_cross_entropy_with_logits(
        z, g, reduction="none")
    np.testing.assert_allclose(bce_with_logits(z, g).numpy(), want.numpy(),
                               atol=1e-6)
