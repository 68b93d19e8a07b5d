"""Shared command line helpers: the device and dtype flags, and detector
loading or creation.

Counterpart of the JAX package's `cli/common.py`. Every command takes
`--device` (default `cuda`; the tests pass `cpu`); `--bf16` / `--dtype
bfloat16` mean `torch.bfloat16` compute. `--data-parallel N` of the two
trainers runs the command in N ranks (`run_in_ranks`). The JAX package's
persistent XLA compile cache has no counterpart here.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, List, Optional

import torch

from ..models.segpp import YOLOSegPP, build_segpp
from ..models.yolo import YOLOModel, build_yolo
from ..parallel import mesh as meshlib
from ..utils.model_io import load_model


def add_device_argument(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu to ask "
                        "for the CPU)")


def device_of(name: str) -> torch.device:
    """The device a command runs on; a CUDA device where there is none
    raises, so that nothing runs on the CPU unasked."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device; pass "
                           f"--device cpu to run on the CPU")
    return device


# the join timeout of `--data-parallel`'s ranks in seconds; None: none (a
# collective that hangs still fails after the process group's 30 minutes)
LAUNCH_TIMEOUT: Optional[float] = None


def data_parallel_devices(n: int, device: str) -> List[str]:
    """The ranks' devices of `--data-parallel n`: n CPU ranks for
    `--device cpu` (gloo), else one CUDA device a rank (NCCL); fewer CUDA
    devices than ranks raises, as the JAX package's `make_mesh` does with
    too few devices."""
    if n < 1:
        raise ValueError(f"--data-parallel {n}: give 1 or more ranks")
    if torch.device(device).type == "cpu":
        return ["cpu"] * n
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        raise RuntimeError(
            f"--data-parallel {n}: one CUDA device a rank, and {count} here; "
            f"pass --device cpu to run the ranks on the CPU")
    return [f"cuda:{i}" for i in range(n)]


def run_in_ranks(body: Callable, args: argparse.Namespace):
    """`body(args, mesh)`: here without a mesh for `--data-parallel 0`,
    else in `args.data_parallel` ranks started by `parallel.mesh.launch`
    with a mesh each (a mesh of one for 1, as the JAX package's
    `make_mesh(1)`), returning rank 0's result. `body` must be a
    module-level function."""
    if not args.data_parallel:
        return body(args, None)
    devices = data_parallel_devices(args.data_parallel, args.device)
    return meshlib.launch(_rank_body, args.data_parallel, devices, body,
                          args, timeout=LAUNCH_TIMEOUT)


def _rank_body(body: Callable, args: argparse.Namespace):
    return body(args, meshlib.make_mesh(args.data_parallel))


def get_or_init_detector(model_path: Optional[str], *, variant: str = "n",
                         nc: int = 1, ch: int = 4, task: str = "detect",
                         seed: int = 0,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cuda") -> YOLOModel:
    """The detector a `.ckpt` model file holds (its own architecture,
    task and weights), or yolov12 with seeded fresh weights when the file
    does not exist."""
    if model_path and os.path.exists(model_path):
        return load_model(model_path, dtype=dtype, device=device)
    return build_yolo("yolov12", variant, nc=nc, ch=ch, task=task,
                      dtype=dtype, device=device, seed=seed)


def adapt_segment_head_to_detect(state_dict: Dict[str, torch.Tensor],
                                 head: int) -> Dict[str, torch.Tensor]:
    """A segment-task detector's state_dict as a detect-task graph takes
    it: the head's mask branches (`model.{head}.cv4`, `.proto`) dropped."""
    drop = (f"model.{head}.cv4.", f"model.{head}.proto.")
    return {k: v for k, v in state_dict.items() if not k.startswith(drop)}


def build_segpp_from_detector(detector: YOLOModel, *, nc: int = 1,
                              ch: int = 4, use_logits: bool = True,
                              seed: int = 0,
                              dtype: torch.dtype = torch.float32,
                              device: torch.device | str = "cuda"
                              ) -> YOLOSegPP:
    """YOLO-Seg++ over the detector's own family and scale, with the
    detector's weights in its YOLO graph and a seeded fresh decoder (its
    skip widths follow the graph); a segment-task detector works too. The
    JAX package's builder takes yolov12 whatever the detector is."""
    model = build_segpp(detector.spec.arch, detector.spec.variant, nc, ch,
                        "detect",
                        use_logits=use_logits, dtype=dtype, device=device,
                        seed=seed)
    head = len(model.yolo.model) - 1
    model.yolo.load_state_dict(
        adapt_segment_head_to_detect(detector.state_dict(), head),
        strict=True)
    return model
