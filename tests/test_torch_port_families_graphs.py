"""PyTorch port: the yolov8 and yolo11 graphs whole, and the Predictor,
against the JAX package, f32 on the CPU.

Both families for both tasks at nc=1, 4 channels, 64^2 and batch 2, on JAX
weights drawn with numpy (`test_torch_port_slice.py`'s draw: random BN
statistics, the warm-started head bias) and carried across by
`state_dict_from_jax`: raw maps, decoded predictions, mask coefficients
and protos within 1e-5 absolute plus 1e-4 relative (the JAX package's own
golden tolerance for these graphs), NMS keep-sets identical; the Predictor
end to end against the JAX predictor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.engine.predictor import Predictor as JaxPredictor
from yolou_tpu.models.yolo import build_yolo as build_yolo_jax
from yolou_tpu.ops.nms import non_max_suppression as jax_nms
from yolou_tpu_torch.engine.predictor import Predictor
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.ops.nms import non_max_suppression
from yolou_tpu_torch.tools.convert import state_dict_from_jax

from .test_torch_port_slice import IMGSZ
from .test_torch_port_slice import jax_variables as draw_variables
from .torch_threads import one_torch_thread  # noqa: F401

FAMILIES = ("yolov8", "yolo11")


@pytest.fixture(scope="module", params=[(a, t) for a in FAMILIES
                                        for t in ("segment", "detect")],
                ids=lambda p: "-".join(p))
def graph(request):
    """(arch, task, JAX module, variables, port model) at nc=1, 4 ch."""
    arch, task = request.param
    jmod = build_yolo_jax(arch, "n", nc=1, ch=4, task=task)
    variables = draw_variables(jmod, seed=len(arch))
    tmod = build_yolo(arch, "n", nc=1, ch=4, task=task, device="cpu")
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    return arch, task, jmod, variables, tmod


def _graph_close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)


def test_whole_graph_matches_jax(graph):
    """Raw maps, decoded predictions, mask coefficients and protos; NMS
    over the port's predictions keeps the same boxes as over JAX's."""
    arch, task, jmod, variables, tmod = graph
    x = np.random.default_rng(1).random((2, IMGSZ, IMGSZ, 4), np.float32)
    ref = jax.device_get(jax.jit(
        lambda v, a: jmod.apply(v, a, train=False))(variables, x))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert len(out.raw) == 3
    for rt, rj in zip(out.raw, ref.raw):
        _graph_close(rt.permute(0, 2, 3, 1), rj)
    # boxes are pixels: compare them in grid units, as the head test does
    stride = torch.cat([torch.full((r.shape[2] * r.shape[3],), float(s))
                        for r, s in zip(out.raw, (8, 16, 32))])
    got, want = out.preds.clone(), torch.from_numpy(np.array(ref.preds))
    got[..., :4] /= stride[None, :, None]
    want[..., :4] /= stride[None, :, None]
    _graph_close(got, want.numpy())
    if task == "segment":
        _graph_close(out.mask_coefs, ref.mask_coefs)
        _graph_close(out.protos.permute(0, 2, 3, 1), ref.protos)
    else:
        assert out.mask_coefs is None and ref.mask_coefs is None
    dets = non_max_suppression(out.preds, nc=1)
    jdets = jax_nms(jnp.asarray(ref.preds), nc=1)
    np.testing.assert_array_equal(dets.valid.numpy(), np.asarray(jdets.valid))
    assert int(dets.valid.sum()) > 0
    np.testing.assert_allclose(dets.boxes.numpy(), np.asarray(jdets.boxes),
                               atol=1e-3, rtol=0)


def test_predictor_matches_jax(graph):
    """The Predictor end to end on two uint8 images of one size (one
    bucket, up-scaled to 64^2): the same detections, boxes within 1e-3 px,
    scores within 1e-5; masks equal on all but 1e-3 of the pixels."""
    arch, task, jmod, variables, tmod = graph
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (48, 40, 4), dtype=np.uint8)
            for _ in range(2)]
    want = JaxPredictor(jmod, variables, imgsz=IMGSZ, batch_size=2)(imgs)
    got = Predictor(tmod, imgsz=IMGSZ, batch_size=2)(imgs)
    assert len(got) == len(want) == len(imgs)
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        np.testing.assert_allclose(g.boxes.data[:, :4], w.boxes.data[:, :4],
                                   atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.boxes.data[:, 4:], w.boxes.data[:, 4:],
                                   atol=1e-5, rtol=0)
        if task == "segment":
            assert g.masks.data.shape == w.masks.data.shape
            assert np.mean(g.masks.data != w.masks.data) <= 1e-3
