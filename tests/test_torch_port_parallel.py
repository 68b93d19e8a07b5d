"""PyTorch port: data parallel (`parallel/mesh.py` and the mesh paths of
both trainers and the Evaluator) on two gloo ranks on the CPU, against one
process over the same global batch.

The shards are the JAX `NamedSharding(P("data"))` shards (checked against
the JAX module at 2 and 4 devices). One `launch` of two ranks, each on one
torch thread, runs every job of this file (`torch_parallel_ranks.py`); the
test process runs the same jobs without a mesh. Tolerances:
- BatchNorm's output, input gradient and running statistics 1e-6 (flax's
  E[x^2] - E[x]^2 over the two ranks' sums against torch's variance), its
  parameter gradients 1e-6 relative;
- the detector's two steps (mosaic, mixup and cutmix on, global batch 4):
  `tests/test_trainer_detector.py`'s mesh test, loss rtol 3e-4,
  parameters, EMA and BatchNorm statistics rtol 1e-3 / atol 5e-5;
- the decoder's update: loss and Dice 1e-5 relative, decoder parameters
  3e-5 absolute (AdamW's per-element normalisation, as in
  `test_torch_port_decoder_trainer.py`), the encoder bit-identical;
- the validation and Evaluator metrics 1e-6, with the last batch padded
  (`n_real` below the batch size).
"""

import jax
import numpy as np
import pytest
import torch

from yolou_tpu.parallel import mesh as jmesh
from yolou_tpu_torch.models.segpp import build_segpp
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.parallel import mesh as meshlib

from . import torch_parallel_ranks as ranks
from .torch_threads import one_torch_thread  # noqa: F401

S = 64
LAUNCH_TIMEOUT = 240


def _det_batch(seed, b=4, g=4):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (b, S, S, 4), dtype=np.uint8)
    idmap = np.zeros((b, S, S), np.uint8)
    idmap[:, 8:40, 12:52] = 1
    idmap[1::2, 30:60, 4:30] = 2
    cls = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    valid[:, 0] = True
    valid[1::2, 1] = True
    return img, idmap, cls, valid


def _segpp_state(seed):
    """A YOLO-Seg++ with seeded weights and BatchNorm statistics, its output
    bias centred so that half the mask logits are positive."""
    torch.manual_seed(seed)
    model = build_segpp("yolov12", "n", nc=1, ch=4, device="cpu", seed=seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(1.0, 1.5)
        x = torch.from_numpy(_seg_data(seed, 4)[0]).float() / 255
        logits = model.eval()(x.permute(0, 3, 1, 2))[0]
        model.output.bias -= logits.median()
    return ranks.numpy_state(model.state_dict())


def _seg_data(seed, n):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (n, S, S, 4), dtype=np.uint8)
    yy, xx = np.mgrid[:S, :S]
    mask = np.zeros((n, S, S, 1), np.uint8)
    for i in range(n):
        cy, cx, ry, rx = rng.integers(16, 48, 2).tolist() + \
            rng.integers(5, 15, 2).tolist()
        mask[i, ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = 255
        img[i, mask[i, ..., 0] > 0] //= 2
    om = rng.normal(0, 1, (n, S // 8, S // 8, 1)).astype(np.float32)
    return img, mask, om


def _val_batches(seed, n, b):
    """`DecoderDataset.batches`' form: f32 NHWC, the last batch padded by
    repeating its first row."""
    img, mask, om = _seg_data(seed, n)
    out = []
    for s in range(0, n, b):
        idx = np.arange(s, min(s + b, n))
        n_real = len(idx)
        idx = np.concatenate([idx, np.full(b - n_real, idx[0])])
        out.append((img[idx] / np.float32(255), mask[idx] / np.float32(255),
                    om[idx], n_real))
    return out


@pytest.fixture(scope="module")
def jobs():
    x = np.random.default_rng(1).normal(0.5, 2.0, (8, 6, 5, 5)).astype(
        np.float32)
    bn = {"x": x, "g": np.random.default_rng(2).normal(size=x.shape).astype(
              np.float32),
          "weight": np.linspace(0.5, 1.5, 6, dtype=np.float32),
          "bias": np.linspace(-0.2, 0.3, 6, dtype=np.float32)}
    det = {"state_dict": ranks.numpy_state(build_yolo(
               "yolov12", "n", nc=1, ch=4, task="segment", device="cpu",
               seed=3).state_dict()),
           "cfg": dict(imgsz=S, batch_size=4, epochs=1, close_mosaic=0,
                       max_instances=4, warmup_epochs=1.0),
           "aug": dict(mixup=0.5, cutmix=0.5), "steps_per_epoch": 2,
           "seed": 0, "use_mosaic": True,
           "batches": [_det_batch(10), _det_batch(11)]}
    seg = _segpp_state(5)
    img, mask, om = _seg_data(7, 8)
    dec = {"state_dict": seg, "cfg": dict(image_size=S, batch_size=8),
           "batch": (img, mask, om), "val_batches": _val_batches(8, 14, 8)}
    ev = {"state_dict": seg, "size": S, "batch_size": 8, "hd95": True,
          "batches": [(b[0], b[1], None, b[3])
                      for b in _val_batches(9, 10, 8)]}
    return [("replicated", 4), ("batchnorm", bn), ("detector_step", det),
            ("decoder_update", dec), ("evaluate", ev)]


@pytest.fixture(scope="module")
def two_ranks(jobs):
    return meshlib.launch(ranks.in_ranks, 2, ["cpu", "cpu"], jobs,
                          timeout=LAUNCH_TIMEOUT)


@pytest.fixture(scope="module")
def one_process(jobs):
    return {name: getattr(ranks, name)(spec) for name, spec in jobs}


@pytest.mark.parametrize("n", [2, 4])
def test_shards_are_the_jax_shards(n):
    """Rank r's rows are device r's shard of `shard_batch` on a JAX mesh of
    n devices, for every leaf of a nested batch."""
    batch = (np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
             {"m": np.arange(8, dtype=np.int32)})
    placed = jmesh.shard_batch(jmesh.make_mesh(n_data=n), batch)
    for r in range(n):
        mesh = meshlib.Mesh(rank=r, size=n, device=torch.device("cpu"),
                            backend="gloo")
        got = meshlib.shard_batch(mesh, batch)
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(placed)):
            shards = sorted(w.addressable_shards, key=lambda s: s.device.id)
            assert len(shards) == n
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(shards[r].data))
    with pytest.raises(ValueError, match="does not split"):
        meshlib.shard_batch(mesh, np.zeros((7, 2)))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("b", [5, 8])
def test_pad_batch_to_multiple_matches_jax(n, b):
    batch = (np.arange(b * 2, dtype=np.float32).reshape(b, 2),
             np.arange(b, dtype=np.int64))
    want, want_n = jmesh.pad_batch_to_multiple(batch, n)
    got, got_n = meshlib.pad_batch_to_multiple(batch, n)
    assert got_n == want_n == b
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_two_gloo_ranks_ran(two_ranks, one_process):
    """Two ranks over gloo; `replicate` gave rank 1 rank 0's weights."""
    assert two_ranks["ranks"] == 2 and two_ranks["backend"] == "gloo"
    rows = two_ranks["replicated"]
    assert rows.shape == (2, 6)
    assert torch.equal(rows[0], rows[1])
    assert torch.equal(rows[:1], one_process["replicated"])


def test_batchnorm_statistics_are_global(jobs, two_ranks, one_process):
    got, want = two_ranks["batchnorm"], one_process["batchnorm"]
    for k in ("y", "x_grad", "running_mean", "running_var"):
        ranks.close(got[k], want[k], 0, 1e-6, k)
    # sums of 200 products of order 1, summed over the ranks
    for k in ("weight_grad", "bias_grad"):
        ranks.close(got[k], want[k], 1e-6, 0, k)
    assert got["num_batches_tracked"] == want["num_batches_tracked"] == 2
    # the global batch's biased variance went into the running variance
    x = torch.from_numpy(dict(jobs)["batchnorm"]["x"])
    var_b = x.var((0, 2, 3), unbiased=False)
    ranks.close(got["running_var"], 0.97 ** 2 + (1 - 0.97 ** 2) * var_b,
                1e-6, 0, "running_var")


def test_detector_steps_equal_one_process(two_ranks, one_process):
    got, want = two_ranks["detector_step"], one_process["detector_step"]
    assert got["counts"] == want["counts"] == (2, 2, 0)
    for (gl, gp), (wl, wp) in zip(got["losses"], want["losses"]):
        np.testing.assert_allclose(gl, wl, rtol=3e-4)
        for k in ("box", "cls", "dfl", "seg"):
            assert wp[k] > 0
            np.testing.assert_allclose(gp[k], wp[k], rtol=3e-4, err_msg=k)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-3)
    ranks.close(got["state_dict"], want["state_dict"], 1e-3, 5e-5, "params")
    ranks.close(got["ema"], want["ema"], 1e-3, 5e-5, "ema")


def test_decoder_update_equals_one_process(two_ranks, one_process):
    got, want = two_ranks["decoder_update"], one_process["decoder_update"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["dice"], want["dice"], rtol=1e-5)
    for k, w in want["state_dict"].items():
        g = got["state_dict"][k]
        if k.startswith("yolo."):
            assert torch.equal(g, w), k         # the frozen encoder
        else:
            ranks.close(g, w, 0, 3e-5, k)
    assert set(got["val"]) == set(want["val"])
    for k, w in want["val"].items():
        np.testing.assert_allclose(got["val"][k], w, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert 0.0 < want["val"]["val_precision"] < 1.0


def test_evaluator_equals_one_process(two_ranks, one_process):
    got, want = two_ranks["evaluate"], one_process["evaluate"]
    assert got["n_images"] == want["n_images"] == 10
    for k in ("dice", "hd95", "precision", "recall"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert np.isfinite(want["hd95"]) and 0.0 < want["dice"] < 1.0


def test_launch_reraises_a_ranks_exception():
    with pytest.raises(KeyError, match="rank 1 stops here") as info:
        meshlib.launch(ranks.uneven, 2, ["cpu", "cpu"], 1,
                       timeout=LAUNCH_TIMEOUT)
    assert "raised in rank 1 of 2" in info.value.__notes__[0]


def test_make_mesh_of_one_and_its_refusals():
    """A mesh of one in this process (its own gloo group, closed after);
    more ranks need launch, and so does a model axis; no card, no GPU
    mesh."""
    mesh = meshlib.make_mesh(1, devices=["cpu"])
    try:
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        assert mesh.shape == {"data": 1, "model": 1}
        x = torch.ones(3, requires_grad=True)
        with mesh:
            assert meshlib.global_sum(x) is x and meshlib.world_size() == 1
        assert meshlib.active_mesh() is None
        with pytest.raises(ValueError, match="group of 1"):
            meshlib.make_mesh(2)
    finally:
        mesh.close()
    with pytest.raises(RuntimeError, match="launch"):
        meshlib.make_mesh(2)
    with pytest.raises(RuntimeError, match="launch"):
        meshlib.make_mesh(n_model=2)
    assert meshlib.backend_for([torch.device("cuda:0")] * 2) == "gloo"
    assert meshlib.backend_for([torch.device(f"cuda:{i}")
                                for i in range(2)]) == "nccl"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA devices"):
            meshlib.launch(ranks.uneven, 2, None, 0)
