"""PyTorch port: the training commands on the CPU (`--device cpu`), read
back by the JAX package.

`train-detector` and `train-decoder` take one epoch at 64^2 over the
synthetic directory of `test_torch_port_cli.py` (the decoder after
`generate-objectmaps`): their files are written, and the `.ckpt` each
writes is read by the JAX package's `load_model`, whose forward must agree
with the port's reading of it within 1e-5 (trajectories are held against
JAX at the trainer level, not here). `train-detector --resume` takes a
JAX-written training state in the JAX command's default flat form."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from yolou_tpu.utils.model_io import load_model as jax_load_model
from yolou_tpu_torch import __main__ as port_main
from yolou_tpu_torch.utils.model_io import load_model

from .test_torch_port_cli import CPU, data, det_ckpt  # noqa: F401
from .test_torch_port_slice import IMGSZ
from .torch_threads import one_torch_thread  # noqa: F401


def _forwards_agree(path, x):
    """The JAX package's model from the port-written `path` against the
    port's reading of it, on NHWC `x` in [0, 1]."""
    jmod, variables = jax_load_model(path)
    tmod = load_model(path, device="cpu")
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    return got, want


def test_train_commands_write_files_jax_reads(data, det_ckpt, tmp_path):
    root, yaml = data
    out = str(tmp_path / "det.ckpt")
    hist = port_main.main([
        "train-detector", "--data", yaml, "--model", det_ckpt, "--imgsz",
        str(IMGSZ), "--batch", "2", "--epochs", "1", "--close-mosaic", "1",
        "--val-every", "1", "--run-dir", str(tmp_path / "rd"), "--out", out,
        "--dtype", "float32", "--pallas", *CPU])
    assert len(hist["loss"]) == len(hist["map50"]) == 1
    run = os.listdir(tmp_path / "rd")
    assert len(run) == 1 and sorted(os.listdir(
        tmp_path / "rd" / run[0] / "weights")) == ["best.ckpt", "last.ckpt"]
    x = np.random.default_rng(0).random((2, IMGSZ, IMGSZ, 4), np.float32)
    got, want = _forwards_agree(out, x)
    np.testing.assert_allclose(got.preds.numpy(),
                               np.asarray(want.preds).transpose(0, 2, 1)
                               if got.preds.shape[1] != want.preds.shape[1]
                               else np.asarray(want.preds),
                               atol=1e-5 * 64, rtol=1e-5)

    assert port_main.main(["generate-objectmaps", "--data_dir", root,
                           "--yolo_dir", out, "--image_size", str(IMGSZ),
                           *CPU]) == {"test": 6, "train": 4, "val": 4}
    hist = port_main.main([
        "train-decoder", "--model", out, "--data", root, "--imgsz",
        str(IMGSZ), "--batch", "2", "--epochs", "1", "--run-dir",
        str(tmp_path / "runs"), *CPU])
    assert len(hist["train_loss"]) == 1 and np.isfinite(hist["train_loss"])
    final = str(tmp_path / "runs" / "segpp_final.ckpt")
    assert os.path.exists(final)
    got, want = _forwards_agree(final, x)
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(),
                               np.asarray(want[0]), atol=1e-5, rtol=0)


def test_train_detector_resumes_the_jax_default_state(data, det_ckpt,
                                                      tmp_path):
    """`train-detector --resume` of a JAX-written `last.ckpt` in the JAX
    command's default flat form: the state of `det_ckpt`'s weights after
    one epoch of 2 steps (4 images, batch 2), written by the JAX package's
    own trainer and checkpoint code. The port's command reads it and runs
    the one epoch left of two; its run writes the port's tree form."""
    from yolou_tpu.engine import trainer_detector as jtd
    from yolou_tpu.utils.checkpoint import save_checkpoint
    from yolou_tpu.utils.model_io import load_model as jload
    from yolou_tpu_torch.utils.checkpoint import load_checkpoint
    from yolou_tpu_torch.utils.train_state import state_form
    _, yaml = data
    jmod, variables = jload(det_ckpt)
    jtr = jtd.DetectorTrainer(jmod, jax.device_get(variables),
                              type("D", (), {"channels": 4})(),
                              jtd.DetectorTrainConfig(imgsz=IMGSZ,
                                                      batch_size=2))
    jtr.ensure_ready(steps_per_epoch=2)
    two = jnp.asarray(2, jnp.int32)
    state = jtr.state._replace(step=two, opt_state=jtr.state.opt_state
                               ._replace(count=two))
    last = str(tmp_path / "jax_last.ckpt")
    save_checkpoint(last, jax.device_get(state._asdict()))
    assert state_form(load_checkpoint(last)) == "flat"

    hist = port_main.main([
        "train-detector", "--data", yaml, "--model", det_ckpt, "--imgsz",
        str(IMGSZ), "--batch", "2", "--epochs", "2", "--close-mosaic", "1",
        "--run-dir", str(tmp_path / "rd"), "--out", str(tmp_path / "o.ckpt"),
        "--resume", last, *CPU])
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"]).all()
    run = os.listdir(tmp_path / "rd")[0]
    mine = load_checkpoint(str(tmp_path / "rd" / run / "weights" /
                               "last.ckpt"))
    assert state_form(mine) == "sgd" and int(mine["step"]) == 4
