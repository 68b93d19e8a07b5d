"""Multi-rank dry runs of the detector's training step.

`dryrun_multichip(n)` is the counterpart of the JAX package's entry of
the same name (`__graft_entry__.py`): one yolov12n-seg training step at
64^2 (4 instances, global batch max(n, 2n), the detect biases warm-started
so that TAL assigns foreground, `AugHyp(scale=0.2)`, warmup 0.1, no close
mosaic) over n data ranks, one step with mosaic and then, from a snapshot
of that state, one without. Phase 2, for an even n of 4 or more, replays
the no-mosaic step on an (n/2) x 2 data x model mesh with
`param_sharding_rules(min_size=2**12)` from the snapshot; its loss must be
phase 1's. The JAX package allows 1e-2 relative there; this one is held to
3e-4, the data-parallel tests' tolerance, in full f32 (TF32 off in its
ranks).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..data.augment import AugHyp
from ..engine.trainer_detector import DetectorTrainConfig, DetectorTrainer
from ..models.yolo import build_yolo
from ..nn.heads import warm_start_detect_bias
from ..parallel import mesh as meshlib
from ..utils.train_state import detector_state_tree, restore_detector_state

DRYRUN_RTOL = 3e-4


def dryrun_batch(b: int, imgsz: int = 64, g: int = 4):
    """The JAX dry run's batch: seeded uint8 images, one box per image."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (b, imgsz, imgsz, 4), dtype=np.uint8)
    idmap = np.zeros((b, imgsz, imgsz), np.int32)
    idmap[:, 16:40, 16:48] = 1
    cls = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    valid[:, 0] = True
    return img, idmap, cls, valid


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _numbers(loss, parts) -> tuple:
    return float(loss), {k: float(v) for k, v in parts.items()}


def _dryrun_rank(n: int) -> dict:
    # full f32 convolutions and matmuls: TF32's 10-bit mantissa alone parts
    # the two phases' losses by ~3e-4 on an H100
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    imgsz, g, b = 64, 4, max(n, 2 * n)
    mesh = meshlib.make_mesh(n_data=n)
    cfg = DetectorTrainConfig(imgsz=imgsz, batch_size=b, epochs=1,
                              max_instances=g, close_mosaic=0,
                              warmup_epochs=0.1)

    def trainer(m, min_size=None):
        model = warm_start_detect_bias(build_yolo(
            "yolov12", "n", nc=1, ch=4, task="segment", device=m.device,
            seed=0))
        rules = (None if min_size is None else
                 meshlib.param_sharding_rules(m, model, min_size=min_size))
        tr = DetectorTrainer(model, None, cfg, aug=AugHyp(scale=0.2),
                             mesh=m, sharding=rules)
        tr.ensure_ready(steps_per_epoch=2)
        return tr

    batch = dryrun_batch(b, imgsz, g)
    tr = trainer(mesh)
    tr.step(batch, _generator(mesh.device, 1), use_mosaic=True)
    snap = detector_state_tree(tr)       # the state entering the 2nd step
    out = {"phase1": _numbers(*tr.step(batch, _generator(mesh.device, 2),
                                       use_mosaic=False))}
    if n >= 4 and n % 2 == 0:
        mesh2 = meshlib.make_mesh(n_data=n // 2, n_model=2)
        tr2 = trainer(mesh2, min_size=2 ** 12)
        restore_detector_state(tr2, snap)
        out["n_cut"] = len(meshlib.model_shards(tr2.model))
        out["phase2"] = _numbers(*tr2.step(
            batch, _generator(mesh2.device, 2), use_mosaic=False))
    return out


def dryrun_multichip(n_devices: int, devices=None,
                     timeout: Optional[float] = 900.0) -> dict:
    """The dry run over `n_devices` ranks (`launch`: by default a CUDA
    device each; pass e.g. `["cpu"] * 4`, or one card four times). Prints
    the JAX function's three result lines and returns rank 0's numbers;
    raises where a loss part is not positive or phase 2 parts from phase
    1."""
    t0 = time.time()
    out = meshlib.launch(_dryrun_rank, n_devices, devices, n_devices,
                         timeout=timeout)
    loss, parts = out["phase1"]
    if not np.isfinite(loss):
        raise AssertionError(f"phase 1 loss {loss}")
    for k in ("box", "cls", "dfl", "seg"):
        if not parts[k] > 0.0:
            raise AssertionError(f"loss part '{k}' degenerate: {parts}")
    print(f"dryrun_multichip({n_devices}): ok after 2 steps, "
          f"loss={loss:.4f}, parts={parts}")
    if "phase2" in out:
        loss2 = out["phase2"][0]
        if out["n_cut"] == 0:
            raise AssertionError("TP rules sharded no kernels")
        out["rel_diff"] = abs(loss2 - loss) / abs(loss)
        if not (np.isfinite(loss2) and out["rel_diff"] <= DRYRUN_RTOL):
            raise AssertionError(f"dp-vs-tp loss mismatch: {loss} vs {loss2}")
        print(f"dryrun_multichip({n_devices}): dp x tp mesh "
              f"({n_devices // 2}x2) ok, {out['n_cut']} kernels sharded over "
              f"'model', loss={loss2:.4f} (dp {loss:.4f}; relative "
              f"difference {out['rel_diff']:.3e}, rtol {DRYRUN_RTOL})")
    out["wall"] = time.time() - t0
    print(f"dryrun_multichip({n_devices}): wall={out['wall']:.0f}s, "
          f"no compile cache (eager)")
    return out

