"""PyTorch port: `tools/dryrun.py::dryrun_multichip(4)` on four gloo ranks
on the CPU, the counterpart of the JAX package's dry run: phase 1
over four data ranks (every loss part positive), phase 2 on a 2 x 2 data x
model mesh from phase 1's snapshot, its loss within 3e-4 of phase 1's, and
the JAX function's three result lines. Then `DetectorTrainer.train()` on a
2 x 2 mesh (two epochs at 64^2 with validation each, 99 weights cut)
against one process: the losses within 3e-4, the validation's metrics,
whole tensors in `best.ckpt` and `last.ckpt`."""

import os

import numpy as np

from yolou_tpu_torch.data import synthetic
from yolou_tpu_torch.parallel import mesh as meshlib
from yolou_tpu_torch.tools import dryrun
from yolou_tpu_torch.utils.checkpoint import load_checkpoint

from . import torch_parallel_ranks as ranks
from .torch_threads import one_torch_thread  # noqa: F401


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    out = dryrun.dryrun_multichip(4, ["cpu"] * 4, timeout=300)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3, lines
    assert lines[0].startswith("dryrun_multichip(4): ok after 2 steps, loss=")
    assert lines[1].startswith(
        "dryrun_multichip(4): dp x tp mesh (2x2) ok, 99 kernels sharded over "
        "'model', loss=")
    assert lines[2].startswith("dryrun_multichip(4): wall=")
    loss, parts = out["phase1"]
    assert all(parts[k] > 0 for k in ("box", "cls", "dfl", "seg"))
    np.testing.assert_allclose(out["phase2"][0], loss, rtol=3e-4)
    assert out["rel_diff"] <= dryrun.DRYRUN_RTOL and out["n_cut"] == 99


def test_train_on_a_2x2_mesh_equals_one_process(tmp_path):
    root = str(tmp_path / "data")
    synthetic.generate(root, {"train": 4, "val": 4}, size=64, seed=13)
    spec = {"yaml": os.path.join(root, "data.yaml"), "min_size": 2 ** 12,
            "cfg": dict(imgsz=64, batch_size=4, epochs=2, close_mosaic=1,
                        max_instances=8, warmup_epochs=1.0, val_every=1)}
    mesh_spec = dict(spec, cfg=dict(spec["cfg"], run_dir=str(tmp_path / "m")))
    got = meshlib.launch(ranks.in_mesh, 4, ["cpu"] * 4,
                         [("detector_train", mesh_spec)], 2, 2,
                         timeout=300)["detector_train"]
    want = ranks.detector_train(
        dict(spec, cfg=dict(spec["cfg"], run_dir=str(tmp_path / "one"))))
    for k in ("loss", "box", "cls", "dfl", "seg"):
        np.testing.assert_allclose(got["history"][k], want["history"][k],
                                   rtol=3e-4, err_msg=k)
    for k in ("map50", "map"):
        assert len(got["history"][k]) == 2
        np.testing.assert_allclose(got["history"][k], want["history"][k],
                                   atol=1e-3, err_msg=k)
    ranks.close(got["state_dict"], want["state_dict"], 1e-3, 5e-5, "params")
    for name in ("best.ckpt", "last.ckpt"):
        a = load_checkpoint(os.path.join(got["weights"], name))
        b = load_checkpoint(os.path.join(want["weights"], name))
        shapes = lambda t: [np.shape(x) for x in _leaves(t)]
        assert shapes(a) == shapes(b), name


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree
