"""Training-state trees in the JAX package's `.ckpt` layout, for both trainers.

The JAX trainers write their whole state, `flax.serialization.to_state_dict`
of `DetTrainState` (`engine/trainer_detector.py`) or of the decoder's
`TrainState` (`engine/trainer_decoder.py`), as one msgpack file. This module
builds the same tree from the port's trainers and reads it back into them,
with the layouts written out here (as optax 0.2.6 gives them) instead of
taken from optax. `{}` stands for optax's `MaskedNode`, the place of a
parameter outside an optimizer group.

Detector, tree form (`flat_opt=False`, and every AdamW state)::

    params, batch_stats, ema_params      the variables' trees
    step                                 steps taken, skipped ones included
    opt_state   apply_if_finite          {notfinite_count, last_finite,
                                          total_notfinite, inner_state}
                  chain                  {0: {} (the clip), 1: multi}
                                         ({0: multi} without a clip)
                    multi_transform      {inner_states: {bias, nodecay, decay}}
                      each group         {inner_state: <group>}

    SGD group      inject_hyperparams    {count, hyperparams: {learning_rate,
                                          momentum}, hyperparams_states:
                                          {learning_rate: {count}, momentum:
                                          {count}}, inner_state: {0: {trace},
                                          1: {}}}
                   decay group           {0: {} (add_decayed_weights), 1: the
                                          above} where the weight decay is set
    AdamW group    adamw                 {0: {count, mu, nu}, 1: {}, 2: {count}}

    Without `skip_nonfinite` the chain stands where `apply_if_finite` is.

Detector, flat form (the JAX package's default `flat_opt=True`, SGD):
`ema_params` is one float32 vector and `opt_state` is `{count, mu,
notfinite}`, both vectors in `ravel_pytree` order (`_leaves`). The port
reads it and writes the tree form.

Decoder: `{params, batch_stats, opt_state, step}`, `opt_state` being
`optax.masked(adamw)`'s `{inner_state: {0: {count, mu, nu}, 1: {}, 2:
{count}}}`, one level deeper (`{0: {}, 1: ...}`) with `clip_grad_norm`;
`mu` and `nu` hold `{}` at every leaf under `yolo`, the frozen encoder.

Every params-shaped tree (params, EMA, momentum, Adam moments) crosses
through `tools/convert.py`'s rules, `jax_variables` and
`state_dict_from_jax`, with the same layouts and AAttn qkv permutation as
the weights; a moment is per element, so the permutation carries it as it
carries its weight. The head's fixed DFL projection is in no tree.

Counters: `step` is the detector trainer's `step_count`; the optimizer's
`count` its `opt_count` (updates applied), `notfinite_count` its
`notfinite_count()`. The `hyperparams` hold the rate and momentum of the
last update; they are written from the trainer's schedules and not read
back, as `inject_hyperparams` recomputes them from the count. The decoder's
`count` and `step` are its `step_count`, and its rate is rebuilt from it.
Training state is float32: a leaf of another dtype (bfloat16 among them) is
an error, not a cast.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel import mesh as meshlib
from ..tools.convert import jax_variables, state_dict_from_jax

Path = Tuple[str, ...]
GROUPS = ("bias", "decay", "nodecay")


# ------------------------------------------------------------------ trees

def _i32(v) -> np.ndarray:
    """A 0-d int32 array: flax writes a device-fetched scalar as ext 1."""
    return np.asarray(v, np.int32)


def _leaves(tree: dict, prefix: Path = ()) -> Iterator[Tuple[Path, object]]:
    """(path, leaf) in `jax.tree_util` order, which is
    `jax.flatten_util.ravel_pytree`'s: depth first, each dict's keys in
    Python's `sorted` order (so `model_11` comes before `model_2`); an
    empty dict holds no leaf."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree: dict, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: dict, path: Path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _mask(tree: dict, keep: Callable[[Path], bool], prefix: Path = ()) -> dict:
    """`tree` with `{}` (optax's MaskedNode) at every leaf not kept."""
    out = {}
    for k, v in tree.items():
        p = prefix + (k,)
        if isinstance(v, dict):
            out[k] = _mask(v, keep, p)
        else:
            out[k] = v if keep(p) else {}
    return out


def group_of(path: Path) -> str:
    """The detector optimizer's group of a params leaf, by its name as the
    JAX package's `make_detector_tx` labels it."""
    leaf = path[-1]
    return "bias" if leaf == "bias" else "nodecay" if leaf == "scale" else "decay"


def ravel(tree: dict) -> np.ndarray:
    """`ravel_pytree(tree)[0]` of a float32 tree."""
    return np.concatenate([np.ravel(leaf) for _, leaf in _leaves(tree)])


def unravel(vec: np.ndarray, template: dict) -> dict:
    """The tree of `template`'s paths and shapes holding `vec`'s values (the
    inverse of `ravel`)."""
    vec = np.asarray(vec)
    leaves = list(_leaves(template))
    size = sum(int(np.size(leaf)) for _, leaf in leaves)
    if vec.shape != (size,):
        raise ValueError(f"a flat vector of {vec.size} values for a tree of "
                         f"{size}")
    out: dict = {}
    at = 0
    for path, leaf in leaves:
        n = int(np.size(leaf))
        _put(out, path, vec[at:at + n].reshape(np.shape(leaf)))
        at += n
    return out


def _check_like(got, want, path: Path = ()) -> None:
    """Raise by path where `got` differs from `want` in keys, shape or
    dtype."""
    where = "/".join(path) or "the state"
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            have = sorted(got) if isinstance(got, dict) else type(got).__name__
            raise ValueError(f"{where}: {have} where the trainer's state has "
                             f"{sorted(want)}")
        for k in want:
            _check_like(got[k], want[k], path + (k,))
        return
    if isinstance(got, torch.Tensor):       # the codec's form of bfloat16
        raise ValueError(f"{where}: {got.dtype} in a training state, "
                         f"{want.dtype} expected")
    got = np.asarray(got)
    if got.dtype != want.dtype or got.shape != want.shape:
        raise ValueError(f"{where}: {got.dtype}{list(got.shape)} where the "
                         f"trainer's state has {want.dtype}{list(want.shape)}")


# ----------------------------------------------------- params-shaped trees

def _params_tree(model: nn.Module, tensors: Dict[str, torch.Tensor]) -> dict:
    """The JAX params tree of `tensors`, named as `model`'s parameters."""
    return jax_variables(model, tensors)["params"]


def _torch_params(tree: dict) -> Dict[str, torch.Tensor]:
    """A params tree -> the port's parameter names."""
    return state_dict_from_jax({"params": tree})


def _torch_variables(tree: dict) -> Dict[str, torch.Tensor]:
    """A state's params and batch_stats -> the port's names (together: the
    AAttn qkv BatchNorms' statistics take their kernel's permutation)."""
    return state_dict_from_jax({"params": tree["params"],
                                "batch_stats": tree["batch_stats"]})


def _optimizer_tensors(optimizer: torch.optim.Optimizer,
                       named: Dict[str, nn.Parameter], key: str
                       ) -> Dict[str, torch.Tensor]:
    """`key` of each parameter's optimizer state; zeros where the optimizer
    has not stepped it yet (or holds it not at all)."""
    out = {}
    for n, p in named.items():
        state = optimizer.state.get(p, {})
        out[n] = state[key] if key in state else torch.zeros_like(p)
    return out


def _load_optimizer(optimizer: torch.optim.Optimizer,
                    states: Dict[int, dict]) -> None:
    """Load per-parameter states (keyed by the parameter's id) through
    `load_state_dict`, which puts each tensor where torch keeps it."""
    sd = optimizer.state_dict()
    order = [p for g in optimizer.param_groups for p in g["params"]]
    sd["state"] = {i: states[id(p)] for i, p in enumerate(order)
                   if id(p) in states}
    optimizer.load_state_dict(sd)


def _copy_into(model: nn.Module, named: Dict[str, torch.Tensor],
               names) -> None:
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for n in names:
            dst = params[n] if n in params else buffers[n]
            dst.copy_(meshlib.local_part(model, n, named[n]))


def _stat_names(model: nn.Module) -> List[str]:
    return [n for n, _ in model.named_buffers()
            if n.endswith((".running_mean", ".running_var"))]


# ------------------------------------------------------- optimizer layouts

def _sgd_group(count: int, lr: float, momentum: float, trace: dict) -> dict:
    """`optax.inject_hyperparams(sgd)(...)`'s state."""
    return {"count": _i32(count),
            "hyperparams": {"learning_rate": np.asarray(lr, np.float32),
                            "momentum": np.asarray(momentum, np.float32)},
            "hyperparams_states": {"learning_rate": {"count": _i32(count)},
                                   "momentum": {"count": _i32(count)}},
            "inner_state": {"0": {"trace": trace}, "1": {}}}


def _adamw(count: int, mu: dict, nu: dict) -> dict:
    """`optax.adamw(schedule)`'s state: scale_by_adam, add_decayed_weights,
    scale_by_schedule."""
    return {"0": {"count": _i32(count), "mu": mu, "nu": nu}, "1": {},
            "2": {"count": _i32(count)}}


def _detector_group(tree: dict, group: str, cfg) -> dict:
    """The optimizer state inside a detector group's `inner_state`: the
    injected SGD state, or AdamW's chain."""
    inner = tree["inner_state"]
    if cfg.optimizer == "sgd" and group == "decay" and cfg.weight_decay:
        inner = inner["1"]
    return inner


def _detector_chain(opt_state: dict, cfg) -> dict:
    """`multi_transform`'s state inside the detector's optimizer state."""
    chain = opt_state["inner_state"] if cfg.skip_nonfinite else opt_state
    return chain["1" if cfg.clip_grad_norm else "0"]


# ---------------------------------------------------------------- detector

def _require_optimizer(tr) -> None:
    if tr.optimizer is None:
        raise RuntimeError("the trainer has no optimizer yet: call "
                           "ensure_ready(steps_per_epoch) first")


def _trainable(model: nn.Module) -> Dict[str, nn.Parameter]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def detector_state_tree(tr) -> dict:
    """`DetectorTrainer` `tr`'s state as the JAX detector trainer's tree
    form (numpy leaves; `utils/checkpoint.py` writes it). Under a model axis
    the cut weights, their EMA and their optimizer state are gathered whole
    over the model group (a collective: every rank calls it), so the tree
    is the JAX layout unchanged and never holds a slice."""
    _require_optimizer(tr)
    cfg, model = tr.cfg, tr.model

    def whole(tensors=None):
        return meshlib.gathered_state(tr.mesh, model, tensors)

    variables = jax_variables(model, whole())
    named = _trainable(model)
    ema = _params_tree(model, whole(dict(zip(named, tr.ema_params))))
    n = tr.opt_count
    groups = {}
    if cfg.optimizer == "adamw":
        mu, nu = (_params_tree(model, whole(_optimizer_tensors(
                      tr.optimizer, named, key)))
                  for key in ("exp_avg", "exp_avg_sq"))
        for g in GROUPS:
            keep = lambda p, g=g: group_of(p) == g
            groups[g] = {"inner_state": _adamw(n, _mask(mu, keep),
                                               _mask(nu, keep))}
    else:
        trace = _params_tree(model, whole(_optimizer_tensors(
            tr.optimizer, named, "momentum_buffer")))
        last = max(n - 1, 0)        # the count of the last update
        for g in GROUPS:
            lr = (tr._lr_bias_fn if g == "bias" else tr._lr_fn)(last)
            inner = _sgd_group(n, lr, tr._mom_fn(last),
                               _mask(trace, lambda p, g=g: group_of(p) == g))
            if g == "decay" and cfg.weight_decay:
                inner = {"0": {}, "1": inner}
            groups[g] = {"inner_state": inner}
    multi = {"inner_states": groups}
    opt_state = {"0": {}, "1": multi} if cfg.clip_grad_norm else {"0": multi}
    if cfg.skip_nonfinite:
        opt_state = {"notfinite_count": _i32(tr.notfinite_count()),
                     "last_finite": np.asarray(bool(tr.last_finite)),
                     "total_notfinite": _i32(tr.total_notfinite),
                     "inner_state": opt_state}
    return {"params": variables["params"],
            "batch_stats": variables["batch_stats"], "ema_params": ema,
            "opt_state": opt_state, "step": _i32(tr.step_count)}


def state_form(tree: dict) -> str:
    """"flat" (the JAX package's flat-vector SGD state), "sgd" or "adamw"
    (tree forms) for a detector training-state tree."""
    if not isinstance(tree, dict) or "ema_params" not in tree:
        raise ValueError("not a detector training state (no ema_params)")
    if not isinstance(tree["ema_params"], dict):
        return "flat"
    for path, _ in _leaves(tree["opt_state"]):
        if "trace" in path:
            return "sgd"
        if "mu" in path:
            return "adamw"
    raise ValueError("a detector training state with neither a momentum "
                     "trace nor Adam moments")


def restore_detector_state(tr, tree: dict) -> None:
    """Restore a detector training-state tree (the port's, or the JAX
    trainer's tree or flat form) into `tr`: parameters, BatchNorm
    statistics, EMA, optimizer state and counters, every tensor exactly.
    Under a model axis every rank reads the whole tree and keeps its slices
    of the cut weights. Raises by name where the file does not fit the
    trainer: another optimizer (a flat-form file is SGD's), another model,
    a missing or extra key, another shape or dtype."""
    _require_optimizer(tr)
    cfg, model = tr.cfg, tr.model
    form = state_form(tree)
    opt = "sgd" if form == "flat" else form
    if opt != cfg.optimizer:
        what = "a flat-form SGD" if form == "flat" else f"an {form}"
        raise ValueError(f"{what} training state can not be restored into a "
                         f"trainer with optimizer={cfg.optimizer!r}")
    want = detector_state_tree(tr)
    if form == "flat":
        size = sum(np.size(leaf) for _, leaf in _leaves(want["params"]))
        vec = np.zeros(size, np.float32)
        want["ema_params"] = vec
        want["opt_state"] = {"count": _i32(0), "mu": vec,
                             "notfinite": _i32(0)}
    _check_like(tree, want)

    named = _trainable(model)
    template = want["params"]
    _copy_into(model, _torch_variables(tree), [*named, *_stat_names(model)])
    if form == "flat":
        ema = unravel(tree["ema_params"], template)
    else:
        ema = tree["ema_params"]
    ema_named = _torch_params(ema)
    with torch.no_grad():
        for e, n in zip(tr.ema_params, named):
            e.copy_(meshlib.local_part(model, n, ema_named[n]))

    os_ = tree["opt_state"]
    if form == "flat":
        count = int(os_["count"])
        moments = {"momentum_buffer": unravel(os_["mu"], template)}
        notfinite = int(os_["notfinite"])
        # the flat state keeps the consecutive count only
        last_finite, total = notfinite == 0, notfinite
    else:
        groups = _detector_chain(os_, cfg)["inner_states"]
        inner = {g: _detector_group(groups[g], g, cfg) for g in GROUPS}
        if opt == "sgd":
            counts = {g: int(inner[g]["count"]) for g in GROUPS}
            parts = {"momentum_buffer": {
                g: inner[g]["inner_state"]["0"]["trace"] for g in GROUPS}}
        else:
            counts = {g: int(inner[g]["0"]["count"]) for g in GROUPS}
            parts = {key: {g: inner[g]["0"][k] for g in GROUPS}
                     for key, k in (("exp_avg", "mu"), ("exp_avg_sq", "nu"))}
        if len(set(counts.values())) != 1:
            raise ValueError(f"the groups' update counts differ: {counts}")
        count = counts["bias"]
        moments = {key: _unmask(trees, template)
                   for key, trees in parts.items()}
        if cfg.skip_nonfinite:
            notfinite = int(os_["notfinite_count"])
            last_finite = bool(os_["last_finite"])
            total = int(os_["total_notfinite"])
        else:
            notfinite, last_finite, total = 0, True, 0
    named_moments = {k: _torch_params(t) for k, t in moments.items()}
    states = {}
    for n, p in named.items():
        st = {k: meshlib.local_part(model, n, m[n]).clone()
              for k, m in named_moments.items()}
        if opt == "adamw":
            st["step"] = torch.tensor(float(count), dtype=torch.float32)
        states[id(p)] = st
    _load_optimizer(tr.optimizer, states)
    tr.step_count, tr.opt_count = int(tree["step"]), count
    tr._notfinite, tr.last_finite, tr.total_notfinite = (
        notfinite, last_finite, total)


def _unmask(trees: Dict[str, dict], template: dict) -> dict:
    """One params tree from the groups' masked trees: each leaf from the
    tree of its group."""
    out: dict = {}
    for path, _ in _leaves(template):
        _put(out, path, _get(trees[group_of(path)], path))
    return out


# ----------------------------------------------------------------- decoder

def _encoder(path: Path) -> bool:
    return path[0] == "yolo"


def decoder_state_tree(tr) -> dict:
    """`DecoderTrainer` `tr`'s state as the JAX decoder trainer's tree: the
    whole YOLO-Seg++ variables, the frozen encoder's under `yolo`, and
    `optax.masked(adamw)`'s moments, `{}` under `yolo`."""
    _require_optimizer(tr)
    model = tr.model
    variables = jax_variables(model)
    named = dict(model.named_parameters())
    moments = [_mask(_params_tree(model, _optimizer_tensors(
        tr.optimizer, named, key)), lambda p: not _encoder(p))
        for key in ("exp_avg", "exp_avg_sq")]
    adam = _adamw(tr.step_count, *moments)
    if tr.cfg.clip_grad_norm is not None:
        adam = {"0": {}, "1": adam}
    return {"params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt_state": {"inner_state": adam}, "step": _i32(tr.step_count)}


def restore_decoder_state(tr, tree: dict) -> None:
    """Restore a decoder training-state tree (the port's or the JAX
    trainer's) into `tr`: the decoder's parameters and BatchNorm
    statistics, AdamW's moments and step, the update count and with it the
    learning rate. The encoder's parameters and statistics in the file must
    equal the model's own bit for bit (the JAX trainer never moves them
    either); where they do not, or where the file does not fit the
    trainer, this raises by name."""
    _require_optimizer(tr)
    model = tr.model
    want = decoder_state_tree(tr)
    _check_like(tree, want)
    for coll in ("params", "batch_stats"):
        for path, leaf in _leaves(want[coll]["yolo"], (coll, "yolo")):
            got = np.asarray(_get(tree, path))
            if got.tobytes() != np.asarray(leaf).tobytes():
                raise ValueError(
                    f"{'/'.join(path)}: the file's frozen encoder differs "
                    f"from this model's (a decoder state resumes on the "
                    f"encoder it was trained on)")
    decoder = [n for n, _ in model.named_parameters()
               if not n.startswith("yolo.")]
    _copy_into(model, _torch_variables(tree), decoder + [
        n for n in _stat_names(model) if not n.startswith("yolo.")])
    adam = tree["opt_state"]["inner_state"]
    if tr.cfg.clip_grad_norm is not None:
        adam = adam["1"]
    # the encoder's leaves are {}: the converter drops them
    mu, nu = (_torch_params(adam["0"][k]) for k in ("mu", "nu"))
    count = int(adam["0"]["count"])
    named = dict(model.named_parameters())
    _load_optimizer(tr.optimizer, {
        id(named[n]): {"step": torch.tensor(float(count), dtype=torch.float32),
                       "exp_avg": mu[n], "exp_avg_sq": nu[n]}
        for n in decoder})
    tr.step_count = int(tree["step"])
    tr.scheduler.last_epoch = tr.step_count
    tr._sync_lr()
    tr.scheduler._last_lr = [g["lr"] for g in tr.optimizer.param_groups]
