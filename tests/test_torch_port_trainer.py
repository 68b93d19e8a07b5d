"""PyTorch port: the detector training step against the JAX package, f32 on
the CPU, yolov12n-seg (4 ch, nc=1) at 64^2 and batch 2.

Weights are random JAX variables carried across by `state_dict_from_jax`;
what the port has after its steps is carried back by
`variables_from_state_dict`. Tolerances: train-mode layers 1e-5; schedules
1e-5 relative (an f32 cosine there, doubles here); the 3-step trajectory 1e-4 relative
on the loss and 1e-4 absolute on parameters, EMA and running statistics
(f32 sums in another order through 22 layers, three optimizer updates).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.data import synthetic
from yolou_tpu.data.augment import AugHyp as JaxAugHyp
from yolou_tpu.data.config import load_data_yaml as jax_load_data_yaml
from yolou_tpu.engine import trainer_detector as jtd
from yolou_tpu.models.yolo import build_yolo as build_yolo_jax
from yolou_tpu.nn import attention as jattn
from yolou_tpu_torch.data.augment import AugHyp
from yolou_tpu_torch.data.config import load_data_yaml
from yolou_tpu_torch.engine.trainer_detector import (
    DetectorTrainConfig, DetectorTrainer, detector_schedules,
    epoch_index_batches, make_detector_tx, parameter_groups)
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.nn import attention, blocks
from yolou_tpu_torch.tools.convert import (state_dict_from_jax,
                                           variables_from_state_dict)

from .test_torch_port_layers import _init, _nchw
from .test_torch_port_slice import jax_variables

IMGSZ = 64
OFF = dict(mosaic=0.0, degrees=0.0, translate=0.0, scale=0.0, shear=0.0,
           flipud=0.0, fliplr=0.0, mixup=0.0, cutmix=0.0, copy_paste=0.0,
           hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, noise_p=0.0, blur_p=0.0,
           bias_p=0.0)


def _leaves_close(got, want, atol, what):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), atol=atol, rtol=0,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


# ------------------------------------------------------------ BatchNorm

def test_batchnorm_running_variance_takes_the_biased_batch_variance():
    """flax folds the biased batch variance into the running one, torch the
    unbiased; the port's BatchNorm2d follows flax. n = 2*2*2 = 8 values per
    channel, so the two differ by 8/7."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        1.0, 2.0, (2, 5, 2, 2)).astype(np.float32))
    ours = blocks.BatchNorm2d(5, eps=1e-3, momentum=0.03)
    theirs = torch.nn.BatchNorm2d(5, eps=1e-3, momentum=0.03)
    for _ in range(3):
        y, y_ref = ours(x), theirs(x)
    assert torch.equal(y, y_ref)
    assert torch.equal(ours.running_mean, theirs.running_mean)
    var_b = x.var((0, 2, 3), unbiased=False)
    want = torch.ones(5)
    for _ in range(3):
        want = 0.97 * want + 0.03 * var_b
    np.testing.assert_allclose(ours.running_var.numpy(), want.numpy(),
                               rtol=1e-6)
    assert not np.allclose(theirs.running_var.numpy(), want.numpy(),
                           rtol=1e-3)
    ours.eval()
    before = ours.running_var.clone()
    ours(x)
    assert torch.equal(ours.running_var, before)


# ------------------------------------------------------------ train-mode layers

def _train_pair(jmod, tmod, x, seed):
    v = _init(jmod, jnp.asarray(x), seed=seed)
    ref, upd = jmod.apply(v, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    missing, unexpected = tmod.load_state_dict(state_dict_from_jax(v),
                                               strict=False)
    assert not unexpected and not missing
    tmod.train()
    out = tmod(_nchw(x))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-5, rtol=0)
    got = variables_from_state_dict(tmod.state_dict(), v)
    _leaves_close(got["batch_stats"], upd["batch_stats"], 1e-6, "batch_stats")
    _leaves_close(got["params"], v["params"], 0, "params")
    return out


@pytest.mark.parametrize("area,heads", [(4, 2), (1, 4)])
def test_aattn_train_mode_matches_jax(area, heads):
    """AAttn inside its ABlock (the converter finds qkv convs under `attn`):
    unfolded qkv conv + BatchNorm on batch statistics, the conv's output
    channels permuted to role-major, attention, pe on v, proj; outputs and
    the Convs' updated running statistics."""
    dim = 32 * heads
    x = np.random.default_rng(3).normal(0, 1, (2, 8, 8, dim)).astype(np.float32)
    out = _train_pair(jattn.ABlock(dim, heads, area=area),
                      attention.ABlock(dim, heads, area=area), x, seed=area)
    out.sum().backward()        # the backward runs through the Function


def test_a2c2f_train_mode_matches_jax():
    x = np.random.default_rng(4).normal(0, 0.5, (2, 8, 8, 64)).astype(np.float32)
    _train_pair(jattn.A2C2f(128, n=1, a2=True, area=4),
                attention.A2C2f(64, 128, n=1, a2=True, area=4), x, seed=7)


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_schedules_and_parameter_groups_match_make_detector_tx(optimizer):
    kw = dict(epochs=10, warmup_epochs=2.0, lr0=0.01, lrf=0.01,
              skip_nonfinite=False, clip_grad_norm=0.0, optimizer=optimizer)
    jcfg = jtd.DetectorTrainConfig(**kw)
    _, jlr, jlrb, jmom = jtd.make_detector_tx(jcfg, steps_per_epoch=10)
    cfg = DetectorTrainConfig(**kw)
    lr, lrb, mom = detector_schedules(cfg, 10)
    for step in (0, 1, 7, 19, 20, 21, 55, 99, 100, 140):
        np.testing.assert_allclose(lr(step), float(jlr(step)), rtol=1e-5,
                                   atol=1e-10)
        np.testing.assert_allclose(lrb(step), float(jlrb(step)), rtol=1e-5)
        np.testing.assert_allclose(mom(step), float(jmom(step)), rtol=1e-5)
    assert lrb(0) == cfg.warmup_bias_lr and lr(0) == 0.0
    assert mom(0) == cfg.warmup_momentum and mom(20) == cfg.momentum

    # groups: decay reaches conv weights only; the frozen DFL is in none
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       device="cpu")
    groups = parameter_groups(model)
    names = {id(p): n for n, p in model.named_parameters()}
    assert all(names[id(p)].endswith(".bias") for p in groups["bias"])
    assert all(names[id(p)].endswith(".bn.weight") for p in groups["nodecay"])
    assert all(names[id(p)].endswith((".conv.weight", ".upsample.weight",
                                      ".2.weight")) for p in groups["decay"])
    n_grouped = sum(len(g) for g in groups.values())
    assert n_grouped == len(list(model.parameters())) - 1   # all but the DFL
    opt, *_ = make_detector_tx(model, cfg, 10)
    assert [g["weight_decay"] for g in opt.param_groups] == [
        0.0, 0.0, cfg.weight_decay]


def _tiny():
    m = torch.nn.Sequential(torch.nn.Conv2d(2, 3, 1), blocks.BatchNorm2d(3))
    with torch.no_grad():
        m[0].weight.copy_(torch.linspace(-1, 1, 6).view(3, 2, 1, 1))
        m[0].bias.fill_(0.1)
        m[1].weight.fill_(0.9)
    return m


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_optimizer_updates_match_optax_chain(optimizer):
    """Six updates through the warmup (per-step lr and momentum), the clip
    active at step 2, a non-finite step skipped at step 4: parameters equal
    to the optax chain's within 2e-5 relative; for AdamW within 2e-6
    absolute as well (optax takes 1 - b2^t in f32, 7e-6 relative on updates
    of up to 0.1)."""
    import optax
    kw = dict(epochs=4, warmup_epochs=1.0, lr0=0.01, clip_grad_norm=10.0,
              weight_decay=5e-4, optimizer=optimizer)
    tx, *_ = jtd.make_detector_tx(jtd.DetectorTrainConfig(**kw), 3)
    model = _tiny()
    params = {"conv": {"kernel": jnp.asarray(
                  model[0].weight.detach().numpy().transpose(2, 3, 1, 0)),
                       "bias": jnp.asarray(model[0].bias.detach().numpy())},
              "bn": {"scale": jnp.asarray(model[1].weight.detach().numpy()),
                     "bias": jnp.asarray(model[1].bias.detach().numpy())}}
    opt = tx.init(params)

    class _Spec:
        nc, strides, reg_max, task = 1, (8,), 16, "detect"
    model.spec = _Spec()
    tr = DetectorTrainer(model, None, DetectorTrainConfig(**kw), device="cpu")
    tr.ensure_ready(3)
    rng = np.random.default_rng(7)
    tparams = {"conv": {"kernel": model[0].weight, "bias": model[0].bias},
               "bn": {"scale": model[1].weight, "bias": model[1].bias}}
    for i in range(6):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(0, 10.0 if i == 2 else 0.5,
                                 p.shape).astype(np.float32), params)
        if i == 4:
            grads["conv"]["kernel"][0, 0, 0, 0] = np.nan
        updates, opt = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                 opt, params)
        params = optax.apply_updates(params, updates)
        for mod, leaves in tparams.items():
            for leaf, p in leaves.items():
                g = grads[mod][leaf]
                p.grad = torch.from_numpy(
                    g.transpose(3, 2, 0, 1).copy() if g.ndim == 4 else g)
        tr.apply_gradients()
        assert tr.notfinite_count() == (1 if i == 4 else 0)
        for mod, leaves in tparams.items():
            for leaf, p in leaves.items():
                w = np.asarray(params[mod][leaf])
                w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w
                np.testing.assert_allclose(
                    p.detach().numpy(), w, rtol=2e-5,
                    atol=2e-6 if optimizer == "adamw" else 1e-7,
                    err_msg=f"{i} {leaf}")
    assert tr.opt_count == 5    # the nan step did not advance the schedules


def test_nonfinite_steps_are_applied_after_100_in_a_row():
    model = _tiny()

    class _Spec:
        nc, strides, reg_max, task = 1, (8,), 16, "detect"
    model.spec = _Spec()
    cfg = DetectorTrainConfig(epochs=2, warmup_epochs=0.0, clip_grad_norm=0.0)
    tr = DetectorTrainer(model, None, cfg, device="cpu")
    tr.ensure_ready(4)
    for i in range(101):
        for p in tr.params:
            p.grad = torch.full_like(p, float("nan"))
        tr.apply_gradients()
        finite = all(bool(torch.isfinite(p).all()) for p in tr.params)
        assert finite == (i < 100), i
    assert tr.notfinite_count() == 101 and tr.opt_count == 1


def test_trainer_defaults_to_the_gpu_and_refuses_validation():
    model = _tiny()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            DetectorTrainer(model, None)
    with pytest.raises(NotImplementedError, match="validator"):
        DetectorTrainer(model, None, DetectorTrainConfig(val_every=1),
                        device="cpu")


# ------------------------------------------------------------ trajectory

def _raw_batch(seed, b=2, g=4):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (b, IMGSZ, IMGSZ, 4), dtype=np.uint8)
    idmap = np.zeros((b, IMGSZ, IMGSZ), np.uint8)
    idmap[:, 8:40, 12:52] = 1
    idmap[1, 30:60, 4:30] = 2
    cls = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    valid[:, 0] = True
    valid[1, 1] = True
    return img, idmap, cls, valid


def test_three_step_trajectory_matches_jax():
    """Three steps from one converted init, augmentation off. lr0 and the
    bias warmup rate are a fifth of their defaults: the loss (IoU^6 target
    scores, BatchNorms over the 8 values of the 2x2 level) turns a 1e-6
    difference in the parameters into 1e-5 in the loss, and at the default
    rates that noise grows past 1e-4 by the third step."""
    jmod = build_yolo_jax("yolov12", "n", nc=1, ch=4, task="segment")
    variables = jax_variables(jmod, seed=3)
    kw = dict(imgsz=IMGSZ, batch_size=2, epochs=3, close_mosaic=0,
              max_instances=4, warmup_epochs=1.0, lr0=0.002,
              warmup_bias_lr=0.02)
    jcfg = jtd.DetectorTrainConfig(flat_opt=False, device_data=False,
                                   packed_upload=False, **kw)
    jtr = jtd.DetectorTrainer(jmod, variables, None, jcfg,
                              aug=JaxAugHyp(**OFF))
    jtr.data_cfg = type("D", (), {"channels": 4})()
    jtr.ensure_ready(steps_per_epoch=2)

    tmod = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                      device="cpu")
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    tr = DetectorTrainer(tmod, None, DetectorTrainConfig(**kw),
                         aug=AugHyp(**OFF), device="cpu")
    tr.ensure_ready(steps_per_epoch=2)
    gen = torch.Generator().manual_seed(0)

    state = jtr.state
    for i in range(3):
        batch = _raw_batch(10 + i)
        state, jloss, jparts = jtr._step[False](
            state, tuple(jnp.asarray(a) for a in batch), jax.random.key(i))
        loss, parts = tr.step(batch, gen, use_mosaic=False)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4,
                                   err_msg=f"step {i}")
        for k in ("box", "cls", "dfl", "seg"):
            assert float(jparts[k]) > 0, k
            np.testing.assert_allclose(parts[k].item(), float(jparts[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    assert tr.step_count == tr.opt_count == 3 and tr.notfinite_count() == 0
    want = jax.device_get(state)
    assert int(want.step) == 3
    got = variables_from_state_dict(tmod.state_dict(), variables)
    _leaves_close(got["params"], want.params, 1e-4, "params")
    _leaves_close(got["batch_stats"], want.batch_stats, 1e-4, "batch_stats")
    ema = variables_from_state_dict(tr.ema_variables(), variables)
    _leaves_close(ema["params"], want.ema_params, 1e-4, "ema")
    # the EMA moved off the initial weights, towards the trained ones
    k = ("model_0", "conv", "kernel")
    first = lambda t: np.asarray(t[k[0]][k[1]][k[2]])
    assert not np.array_equal(first(ema["params"]), first(variables["params"]))


# ------------------------------------------------------------ data and train()

def test_epoch_index_batches_wrap_fills_like_jax():
    for n, bs in ((65, 16), (64, 16), (5, 8)):
        idx = np.random.default_rng(n).permutation(n)
        want = list(jtd.epoch_index_batches(idx, bs))
        got = list(epoch_index_batches(idx, bs))
        assert len(got) == len(want) == -(-n // bs)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("det_torch"))
    synthetic.generate(r, {"train": 6, "val": 2, "test": 2}, size=IMGSZ,
                       seed=11)
    return r


def test_dataset_and_collate_match_jax(root):
    from yolou_tpu.data import yolo_dataset as jds
    from yolou_tpu_torch.data import yolo_dataset as tds
    cfg, jcfg = (f(os.path.join(root, "data.yaml"))
                 for f in (load_data_yaml, jax_load_data_yaml))
    assert cfg == type(cfg)(**vars(jcfg))
    d = cfg.split_dir("train")
    ours = tds.YoloSegDataset(d, imgsz=IMGSZ, channels=4, cache_images=True)
    theirs = jds.YoloSegDataset(d, imgsz=IMGSZ, channels=4, cache_images=True)
    sel = [3, 0, 5, 1]
    want = jds.collate_idmap_cached(theirs, sel, 8)
    got = tds.collate_idmap_cached(ours, sel, 8)
    slow = tds.collate_idmap([ours.item(j) for j in sel], 8)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(slow[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype


def test_train_one_epoch_writes_last_pt_and_resumes(root, tmp_path):
    data_cfg = load_data_yaml(os.path.join(root, "data.yaml"))

    def trainer(epochs):
        model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                           device="cpu", seed=1)
        cfg = DetectorTrainConfig(imgsz=IMGSZ, batch_size=4, epochs=epochs,
                                  close_mosaic=1, max_instances=8,
                                  warmup_epochs=1.0,
                                  run_dir=str(tmp_path / "runs"))
        return DetectorTrainer(model, data_cfg, cfg,
                               aug=AugHyp(scale=0.3, translate=0.05),
                               device="cpu")

    tr = trainer(1)
    history = tr.train()
    assert len(history["loss"]) == 1 and np.isfinite(history["loss"]).all()
    assert history["seg"][0] > 0 and tr.step_count == 2      # ceil(6 / 4)
    run = os.listdir(tmp_path / "runs")[0]
    last = tmp_path / "runs" / run / "weights" / "last.pt"
    assert last.exists()

    tr2 = trainer(2)
    history2 = tr2.train(resume_from=str(last))
    assert tr2.step_count == 4 and len(history2["loss"]) == 1  # epoch 2 only
    sd, sd2 = tr.model.state_dict(), tr2.model.state_dict()
    assert any(not torch.equal(sd[k], sd2[k]) for k in sd)
    ema = tr2.ema_variables()
    assert set(ema) == set(sd2)
