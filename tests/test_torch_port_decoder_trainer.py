"""PyTorch port: the decoder trainer against the JAX package's, f32 on the
CPU, YOLO-Seg++ over yolov12n (4 ch, nc=1) at 64^2 and batch 2.

Random JAX variables cross through `state_dict_from_jax`, with the decoder's
output bias centred on the first training batch so that the masks have
shape. One module-scoped JAX trainer takes the 3-step trajectory and then a
2-epoch `train()` from the same init (its train step compiles once).
Tolerances: the losses 1e-6 absolute; the 3-step trajectory 1e-5 relative
on the loss, and on the decoder's parameters and running statistics every
element within half of one update (5e-5 at lr 1e-4) and all but 0.5 %
within 1e-6. AdamW moves an element by lr g / (|g| + 1e-8) an update, about
lr whatever the size of its gradient, so an element whose gradient is a
cancelling sum within f32 noise of 0 moves by a share of lr that depends on
the summation order (ROADMAP's note on noise-limited trajectories;
measured here: 94 of 63763 parameters past 1e-6, the largest 1.7e-5,
against a median move of 1.7e-4 over the three updates). The 2-epoch
histories 1e-4 absolute on the losses and the training Dice, and on the
thresholded validation metrics what a few flipped pixels allow (a 1e-6
change of a logit near 0 flips a pixel, as in the evaluator's test): Dice,
precision and recall 2e-3 absolute, HD95 0.25 px.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yolou_tpu.engine import trainer_decoder as jtd
from yolou_tpu.losses import dice as jdice
from yolou_tpu.models import segpp as jsegpp
from yolou_tpu.models.yolo import parse_model_spec as jax_spec
from yolou_tpu_torch.data import synthetic
from yolou_tpu_torch.data.decoder_dataset import DecoderDataset
from yolou_tpu_torch.engine.trainer_decoder import (
    HISTORY_KEYS, DecoderTrainConfig, DecoderTrainer, cosine_decay)
from yolou_tpu_torch.losses import dice
from yolou_tpu_torch.models.segpp import build_segpp
from yolou_tpu_torch.tools.convert import (state_dict_from_jax,
                                           variables_from_state_dict)

from .test_torch_port_segpp import _draw

SIZE, BATCH, EPOCHS = 64, 2, 2
CFG = dict(image_size=SIZE, batch_size=BATCH, epochs=EPOCHS,
           early_stopping=False)


# ------------------------------------------------------------------ losses

LOSSES = {
    "dice": ("soft_dice_loss", {}),
    "dice-per-sample": ("soft_dice_loss", {"batch": False}),
    "dice-hard-label": ("soft_dice_loss", {"soft_label": False}),
    "dice-squared": ("soft_dice_loss", {"squared_pred": True}),
    "dice-probabilities": ("soft_dice_loss", {"sigmoid": False}),
    "dice-smooth": ("soft_dice_loss", {"smooth_nr": 0.0, "smooth_dr": 1.0,
                                       "batch": False, "soft_label": False}),
    "tversky": ("tversky_loss", {}),
    "tversky-weights": ("tversky_loss", {"alpha": 0.7, "beta": 0.3,
                                         "smooth": 0.5}),
    "tversky-probabilities": ("tversky_loss", {"apply_sigmoid": False}),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    fn, kw = LOSSES[name]
    rng = np.random.default_rng(len(name))
    logits = rng.normal(0, 2, (3, 16, 16, 1)).astype(np.float32)
    if not kw.get("sigmoid", kw.get("apply_sigmoid", True)):
        logits = 1 / (1 + np.exp(-logits))
    target = (rng.random((3, 16, 16, 1)) > 0.6).astype(np.float32)
    target[0] = 0.0                          # an empty sample
    want = getattr(jdice, fn)(jnp.asarray(logits), jnp.asarray(target), **kw)
    got = getattr(dice, fn)(torch.from_numpy(logits),
                            torch.from_numpy(target), **kw)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=0)


# ------------------------------------------------------------------ fixtures

def _objectmaps(root, split, seed):
    names = sorted(os.path.splitext(f)[0] for f in
                   os.listdir(os.path.join(root, "images", split)))
    rng = np.random.default_rng(seed)
    synthetic.write_objectmaps(
        root, {n: rng.standard_normal((SIZE // 8, SIZE // 8))
               .astype(np.float32) for n in names}, split)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """3 train and 3 val images: both splits end in a wrap-filled batch."""
    r = str(tmp_path_factory.mktemp("dec_data"))
    synthetic.generate(r, {"train": 3, "val": 3}, size=SIZE, seed=2)
    for i, split in enumerate(("train", "val")):
        _objectmaps(r, split, 3 + i)
    return r


@pytest.fixture(scope="module")
def variables(root):
    """JAX YOLOSegPP variables with the output bias centred on the first
    training batch (the median mask logit of the port's model)."""
    jmod = jsegpp.YOLOSegPP(spec=jax_spec("yolov12", "n", 1, 4, "detect"))
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 4)), train=False))
    v = _draw(shapes, seed=11)
    ds = DecoderDataset(root, "images/train", "masks/train", SIZE,
                        objectmap_path="objectmap/train")
    imgs, _, oms, _ = next(ds.batches(BATCH))
    tmod = _port_model(v)
    with torch.no_grad():
        median = float(tmod(torch.from_numpy(imgs).permute(0, 3, 1, 2),
                            torch.from_numpy(oms).permute(0, 3, 1, 2))[0]
                       .median())
    out = v["params"]["decoder"]["output"]
    out["bias"] = out["bias"] - np.float32(median)
    return jmod, v


def _port_model(v):
    m = build_segpp("yolov12", "n", nc=1, ch=4, device="cpu")
    m.load_state_dict(state_dict_from_jax(v), strict=True)
    return m


def _port_trainer(v, root, run_dir, **kw):
    cfg = DecoderTrainConfig(run_dir=str(run_dir), **dict(CFG, **kw))
    return DecoderTrainer(_port_model(v), root, cfg, device="cpu")


def _step_batches():
    rng = np.random.default_rng(7)
    for _ in range(3):
        yield (rng.integers(0, 255, (BATCH, SIZE, SIZE, 4), dtype=np.uint8),
               ((rng.random((BATCH, SIZE, SIZE, 1)) > 0.6) * 255)
               .astype(np.uint8),
               rng.random((BATCH, SIZE // 8, SIZE // 8, 1))
               .astype(np.float32))


@pytest.fixture(scope="module")
def jax_runs(variables, root, tmp_path_factory):
    """One JAX trainer: three `_train_step`s from the init, then `train()`
    for EPOCHS epochs from the same init (host batches, no device data)."""
    jmod, v = variables
    cfg = jtd.DecoderTrainConfig(
        device_data=False, run_dir=str(tmp_path_factory.mktemp("jruns")),
        **CFG)
    jtr = jtd.DecoderTrainer(jmod, v, root, cfg)
    jtr.ensure_ready(steps_per_epoch=2)
    fresh = jax.device_get(jtr.state)     # host arrays: the step donates
    state, steps = fresh, []
    for img, mask, om in _step_batches():
        state, loss, d = jtr._train_step(state, *map(jnp.asarray,
                                                     (img, mask, om)))
        steps.append((float(loss), float(d)))
    trajectory = (steps, jax.device_get(state))
    jtr.state = fresh
    history = jtr.train()
    return trajectory, history, int(jtr.state.step)


# ------------------------------------------------------------------ schedule

def test_learning_rate_follows_optax_cosine(variables, root, tmp_path):
    """The rate of every update, also past the schedule's end and after a
    change of its length, against optax.cosine_decay_schedule."""
    _, v = variables
    tr = _port_trainer(v, root, tmp_path, lr=3e-3, epochs=3)
    tr.ensure_ready(steps_per_epoch=2)
    want = np.asarray(jax.vmap(optax.cosine_decay_schedule(
        3e-3, decay_steps=6))(jnp.arange(9)))
    for t in range(9):
        got = tr.optimizer.param_groups[0]["lr"]
        np.testing.assert_allclose(got, want[t], rtol=1e-6, atol=1e-12,
                                   err_msg=f"update {t}")
        tr.optimizer.step()                  # no gradients: no update
        tr.scheduler.step()
        tr.step_count += 1
    tr.step_count = 4
    tr.ensure_ready(steps_per_epoch=5)            # 15 updates from now on
    np.testing.assert_allclose(
        tr.optimizer.param_groups[0]["lr"],
        float(optax.cosine_decay_schedule(3e-3, decay_steps=15)(4)),
        rtol=1e-6)
    assert cosine_decay(0, 4) == 1.0 and cosine_decay(9, 4) == 0.0


def test_gradient_clipping_matches_optax(variables, root, tmp_path):
    """`clip_grad_norm`: the decoder's gradients scaled as
    optax.clip_by_global_norm scales them, above and below the bound."""
    _, v = variables
    tr = _port_trainer(v, root, tmp_path)
    tr.ensure_ready(1)
    params = list(tr.model.decoder_parameters())
    rng = np.random.default_rng(5)
    grads = [rng.normal(0, 0.01, tuple(p.shape)).astype(np.float32)
             for p in params]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in grads)))
    clip = jax.jit(lambda g, bound: optax.clip_by_global_norm(bound).update(
        g, None)[0])
    for bound in (0.5 * norm, 2.0 * norm):
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        tr._clip_gradients(bound)
        want = clip(grads, bound)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-9)


# ------------------------------------------------------------------ steps

@pytest.fixture(scope="module")
def port_trajectory(variables, root, tmp_path_factory):
    _, v = variables
    tr = _port_trainer(v, root, tmp_path_factory.mktemp("truns"))
    tr.ensure_ready(steps_per_epoch=2)
    before = {k: t.clone() for k, t in tr.model.state_dict().items()}
    steps = [tuple(t.item() for t in tr.step(*batch))
             for batch in _step_batches()]
    return tr, before, steps


def test_three_step_trajectory_matches_jax(variables, jax_runs,
                                           port_trajectory):
    _, v = variables
    (want_steps, want), _, _ = jax_runs
    tr, before, steps = port_trajectory
    assert tr.step_count == int(want.step) == 3
    for i, ((loss, d), (jloss, jd)) in enumerate(zip(steps, want_steps)):
        np.testing.assert_allclose(loss, jloss, rtol=1e-5, err_msg=f"step {i}")
        assert abs(d - jd) <= 2e-3, (i, d, jd)
    got = variables_from_state_dict(tr.model.state_dict(), v)
    for coll in ("params", "batch_stats"):
        flat_w = dict(jax.tree_util.tree_leaves_with_path(
            getattr(want, coll)["decoder"]))
        diffs = []
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                got[coll]["decoder"]):
            d = np.abs(leaf - np.asarray(flat_w[path]))
            assert d.max() <= 5e-5, (coll, jax.tree_util.keystr(path),
                                     d.max())
            diffs.append(d.ravel())
        d = np.concatenate(diffs)
        assert (d > 1e-6).mean() <= 5e-3, (coll, (d > 1e-6).sum(), d.size)
    # the step was real: decoder parameters and statistics moved
    sd = tr.model.state_dict()
    assert any(not torch.equal(sd[k], before[k]) for k in sd
               if k.startswith("decoder.") and "running_" not in k)


def test_encoder_bit_exact_after_steps(port_trajectory):
    """Every `yolo.*` parameter and buffer (BatchNorm statistics included)
    is bit-identical after three updates; the decoder's moved."""
    tr, before, _ = port_trajectory
    after = tr.model.state_dict()
    yolo = [k for k in after if k.startswith("yolo.")]
    assert len(yolo) > 100
    for k in yolo:
        assert torch.equal(after[k], before[k]), k
    moved = [k for k in after if k.startswith("decoder.running_var")
             or (k.startswith("decoder.") and k.endswith("running_var"))]
    assert moved and all(not torch.equal(after[k], before[k]) for k in moved)
    params = {id(p) for p in tr.model.decoder_parameters()}
    assert all(id(p) not in params for p in tr.model.yolo.parameters())


# ------------------------------------------------------------------ train()

def test_train_matches_jax(variables, root, jax_runs, tmp_path):
    _, v = variables
    _, want, want_steps = jax_runs
    tr = _port_trainer(v, root, tmp_path)
    got = tr.train()
    assert tr.step_count == want_steps == EPOCHS * 2
    assert set(got) == set(want) == set(HISTORY_KEYS)
    tol = {"train_loss": 1e-4, "val_loss": 1e-4, "train_dice_metric": 1e-4,
           "val_dice_metric": 2e-3, "val_precision": 2e-3,
           "val_recall": 2e-3, "val_hd95_metric": 0.25}
    for k in HISTORY_KEYS:
        assert len(got[k]) == len(want[k]) == EPOCHS, k
        np.testing.assert_allclose(got[k], want[k], atol=tol[k], rtol=0,
                                   err_msg=k)
    assert 0.0 < got["val_dice_metric"][-1] < 1.0
    assert len(tr.epoch_times) == EPOCHS


def test_resume_runs_the_remaining_epochs(variables, root, tmp_path):
    """2 epochs, then `epochs=3` from `last.pt`: one more epoch, step 6, the
    same state as a third epoch taken without the restart."""
    _, v = variables
    tr = _port_trainer(v, root, tmp_path / "a")
    assert len(tr.train()["train_loss"]) == 2 and tr.step_count == 4
    run = os.listdir(tmp_path / "a")[0]
    last = tmp_path / "a" / run / "weights" / "last.pt"
    tr2 = _port_trainer(v, root, tmp_path / "b", epochs=3)
    h2 = tr2.train(resume_from=str(last))
    assert len(h2["train_loss"]) == 1 and tr2.step_count == 6
    sd, sd2 = tr.model.state_dict(), tr2.model.state_dict()
    assert any(not torch.equal(sd[k], sd2[k]) for k in sd)
    assert tr2.scheduler.last_epoch == 6
    # the rate after the restart follows the 6-update schedule
    np.testing.assert_allclose(tr2.optimizer.param_groups[0]["lr"],
                               1e-4 * cosine_decay(6, 6), atol=1e-12)


def test_run_writes_config_history_checkpoints_and_plot(variables, root,
                                                        tmp_path):
    _, v = variables
    tr = _port_trainer(v, root, tmp_path, epochs=1)
    history = tr.train()
    run = tmp_path / os.listdir(tmp_path)[0]
    assert sorted(os.listdir(run)) == ["config.json", "history.csv",
                                       "plot.png", "weights"]
    assert sorted(os.listdir(run / "weights")) == ["best.pt", "last.pt"]
    with open(run / "history.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == list(HISTORY_KEYS) and len(rows) == 2
    np.testing.assert_allclose([float(x) for x in rows[1]],
                               [history[k][0] for k in HISTORY_KEYS])
    ck = torch.load(run / "weights" / "last.pt", weights_only=True)
    assert set(ck) == {"model", "optimizer", "scheduler", "step"}
    assert ck["step"] == 2 and ck["scheduler"]["last_epoch"] == 2


def test_early_stopping_band_and_start(variables, root, tmp_path):
    """Scripted validation Dice: a gain within 1e-3 saves `best` but counts
    toward patience; patience counts only from `early_stopping_start`."""
    _, v = variables
    tr = _port_trainer(v, root, tmp_path, epochs=8, early_stopping=True,
                       patience=2, early_stopping_start=3)
    script = iter([0.5, 0.4, 0.4, 0.5005, 0.4, 0.9, 0.9, 0.9])
    saves = []
    tr.validate = lambda batches: {k: next(script) if k == "val_dice_metric"
                                   else 0.0 for k in HISTORY_KEYS[1:]
                                   if k.startswith("val")}
    tr._save = lambda path: saves.append((tr.step_count, os.path.basename(
        path)))
    history = tr.train()
    # epochs 1-2 before the start; epoch 3: patience 1; epoch 4 (gain
    # 5e-4, best saved): 2 -> stop
    assert history["val_dice_metric"] == [0.5, 0.4, 0.4, 0.5005]
    assert saves == [(2, "best.pt"), (8, "best.pt"), (8, "last.pt")]


def test_nan_loss_returns_the_history_without_the_epoch(variables, root,
                                                        tmp_path, capsys):
    _, v = variables
    tr = _port_trainer(v, root, tmp_path)
    with torch.no_grad():
        tr.model.output.bias.fill_(float("nan"))
    assert tr.train() == {k: [] for k in HISTORY_KEYS}
    assert "NaN loss detected!" in capsys.readouterr().out
    run = tmp_path / os.listdir(tmp_path)[0]
    assert os.listdir(run / "weights") == []


def test_trainer_defaults_to_the_gpu_and_refuses_a_mesh(variables, root):
    _, v = variables
    model = _port_model(v)
    with pytest.raises(NotImplementedError, match="mesh"):
        DecoderTrainer(model, root, device="cpu", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            DecoderTrainer(model, root)
