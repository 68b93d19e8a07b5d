"""PyTorch port: the Evaluator on two gloo ranks against the JAX package's
`Evaluator(mesh=make_mesh(8))` (the conftest's virtual CPU devices), f32 on
the CPU.

A synthetic directory of 12 images in batches of 8 (the last padded, 4
real), random YOLO-Seg++ variables carried across by `state_dict_from_jax`:
the four metrics at `test_torch_port_evaluator.py`'s tolerances (Dice,
precision and recall 2e-3, HD95 0.25 px), the image count exact. The two
ranks run while the JAX program compiles.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.data import synthetic
from yolou_tpu.data.decoder_dataset import DecoderDataset
from yolou_tpu.engine.evaluator import Evaluator as JaxEvaluator
from yolou_tpu.models import segpp as jsegpp
from yolou_tpu.models.yolo import parse_model_spec as jax_spec
from yolou_tpu.parallel import mesh as jmesh
from yolou_tpu_torch.models.segpp import build_segpp
from yolou_tpu_torch.parallel import mesh as meshlib
from yolou_tpu_torch.tools.convert import state_dict_from_jax

from . import torch_parallel_ranks as ranks
from .test_torch_port_segpp import _draw
from .torch_threads import one_torch_thread  # noqa: F401

S, BATCH, IMAGES = 64, 8, 12


def _segpp_variables(root):
    """Random YOLO-Seg++ variables whose mask logits are centred on the
    first batch (as in `test_torch_port_evaluator.py`)."""
    jmod = jsegpp.YOLOSegPP(spec=jax_spec("yolov12", "n", 1, 4, "detect"))
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.key(0), jnp.zeros((1, S, S, 4)), train=False))
    v = _draw(shapes, seed=11)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.5 if p[-1].key == "var" else a, v["batch_stats"])
    tmod = build_segpp("yolov12", "n", nc=1, ch=4, device="cpu")
    tmod.load_state_dict(state_dict_from_jax(v), strict=True)
    ds = DecoderDataset(root, "images/test", "masks/test", S)
    with torch.no_grad():
        x = torch.from_numpy(next(ds.batches(BATCH))[0]).permute(0, 3, 1, 2)
        median = float(tmod(x)[0].median())
    bias = v["params"]["decoder"]["output"]["bias"]
    v["params"]["decoder"]["output"]["bias"] = bias - np.float32(median)
    return jmod, v


def test_evaluator_matches_the_jax_mesh_evaluator(tmp_path):
    root = str(tmp_path)
    synthetic.generate(root, {"test": IMAGES}, size=S, seed=5)
    jseg, v = _segpp_variables(root)
    spec = {"state_dict": ranks.numpy_state(state_dict_from_jax(v)),
            "root": root, "split": "test", "size": S, "batch_size": BATCH,
            "hd95": True}
    out = {}
    port = threading.Thread(target=lambda: out.update(meshlib.launch(
        ranks.in_ranks, 2, ["cpu", "cpu"], [("evaluate", spec)],
        timeout=300)))
    port.start()
    try:
        jev = JaxEvaluator(jseg, v, root, image_size=S, batch_size=BATCH,
                           mesh=jmesh.make_mesh(n_data=8))
        want = jev.evaluate("test", with_hd95=True)
    finally:
        port.join()
    assert out.get("ranks") == 2, "the ranks failed (see the traceback)"
    got = out["evaluate"]
    assert got["n_images"] == want["n_images"] == IMAGES
    for k in ("dice", "precision", "recall"):
        assert abs(got[k] - want[k]) <= 2e-3, (k, got[k], want[k])
        assert 0.0 < got[k] < 1.0
    assert abs(got["hd95"] - want["hd95"]) <= 0.25, (got, want)
