"""PyTorch port: every scale (n s m l x) of yolov8, yolo11 and yolov12,
checked without a forward pass.

For each of the 15 models the port's module tree is built on the CPU and
the JAX model's variables are shaped by `jax.eval_shape` of its init (no
array is computed on the JAX side). Carried through
`tools/convert.py::state_dict_from_jax`'s name and layout rules, the JAX
shapes must give the port's `state_dict` exactly: the same names and the
same shapes. The training-state files follow the same rules
(`utils/train_state.py`), so this holds them for every scale too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yolou_tpu.models.yolo import build_yolo as build_yolo_jax
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.tools.convert import state_dict_from_jax

from .torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("arch", ["yolov8", "yolo11", "yolov12"])
@pytest.mark.parametrize("scale", ["n", "s", "m", "l", "x"])
def test_state_dict_names_and_shapes_match_the_jax_init(arch, scale):
    jmod = build_yolo_jax(arch, scale, nc=1, ch=4, task="segment")
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 4)), train=False))
    # zero-stride stand-ins: the converter sees each shape, no memory
    stand_in = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax(
        {"params": stand_in["params"],
         "batch_stats": stand_in["batch_stats"]}).items()}
    model = build_yolo(arch, scale, nc=1, ch=4, task="segment",
                       device="cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sorted(got) == sorted(want)
    assert got == want
