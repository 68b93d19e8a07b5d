"""Checkpoint conversion command — the counterpart of the JAX package's
`cli/convert.py`: an ultralytics-named torch state_dict `.pt` to a `.ckpt`
model file (the JAX package's format), or back with `--reverse`.

The port's own weights are that state_dict, so the forward way is a load
into the port's model (every learned tensor and BatchNorm statistic
required; `num_batches_tracked` and the head's fixed DFL projection are
derived), built on `--device`, and `utils/model_io.py`'s writer; the way
back is `tools/convert.py::state_dict_from_jax` and `torch.save`, file to
file on the host. `--arch` takes the three families the JAX command
takes (yolov12, yolov8, yolo11).

Examples:
  python -m yolou_tpu_torch convert --pt best.pt --task segment --out best.ckpt
  python -m yolou_tpu_torch convert --pt decoder.pt --kind segpp --out segpp.ckpt
  python -m yolou_tpu_torch convert --reverse --out best.ckpt --pt sd.pt
"""

from __future__ import annotations

import argparse
import json

import torch

from ..models.segpp import build_segpp
from ..models.yolo import build_yolo
from ..tools.convert import SEGPP_PREFIX_MAP, state_dict_from_jax
from ..utils.checkpoint import load_checkpoint
from ..utils.model_io import save_model
from .common import add_device_argument, device_of


def _derived(name: str) -> bool:
    """Tensors a released state_dict may lack: not learned, no statistic."""
    return name.endswith((".num_batches_tracked", ".dfl.conv.weight"))


def _port_name(name: str, prefix_map) -> str:
    """A file's tensor name as the port names it: `prefix_map` (port
    prefix -> file prefix) applied backwards."""
    for ours, theirs in prefix_map.items():
        if name == theirs or name.startswith(theirs + "."):
            return ours + name[len(theirs):]
    return name


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert a torch state_dict "
                                "checkpoint to a .ckpt model file (or, with "
                                "--reverse, a .ckpt back to a torch .pt).")
    p.add_argument("--pt", required=True,
                   help="torch .pt/.pth state_dict (input; with --reverse: "
                        "the output path)")
    p.add_argument("--out", required=True,
                   help="output .ckpt path (with --reverse: the input .ckpt)")
    p.add_argument("--reverse", action="store_true",
                   help="export a .ckpt AS a reference-style torch "
                        "state_dict .pt (with num_batches_tracked and "
                        "dfl.conv.weight, so that it loads strictly into "
                        "the ultralytics module tree)")
    p.add_argument("--arch", default="yolov12",
                   choices=["yolov12", "yolov8", "yolo11"])
    p.add_argument("--variant", default="n", choices=list("nsmlx"))
    p.add_argument("--task", default="segment", choices=["detect", "segment"])
    p.add_argument("--kind", default="yolo", choices=["yolo", "segpp"],
                   help="yolo: detector; segpp: YOLO-Seg++ decoder ckpt "
                        "(encoder.* torch prefix)")
    p.add_argument("--nc", type=int, default=1)
    p.add_argument("--channels", type=int, default=4)
    p.add_argument("--imgsz", type=int, default=160, help="unused")
    p.add_argument("--prefix-map", default=None,
                   help='JSON dict of name-prefix rewrites, e.g. '
                        '\'{"model": "model.model"}\'')
    p.add_argument("--lenient", action="store_true",
                   help="leave unmatched tensors at their fresh init "
                        "instead of failing")
    add_device_argument(p)
    args = p.parse_args(argv)
    device = device_of(args.device)

    if args.reverse:
        blob = load_checkpoint(args.out)
        kind = json.loads(blob["meta_json"]).get("kind", args.kind)
        prefix_map = dict(SEGPP_PREFIX_MAP) if kind == "segpp" else {}
        if args.prefix_map:
            prefix_map.update(json.loads(args.prefix_map))
        sd = state_dict_from_jax(blob["variables"], prefix_map=prefix_map)
        torch.save(sd, args.pt)
        print(f"exported {len(sd)} tensors ({kind}) -> {args.pt}")
        return {"exported": len(sd)}

    torch_sd = torch.load(args.pt, map_location="cpu", weights_only=True)
    if args.kind == "segpp":
        model = build_segpp(args.arch, args.variant, args.nc, args.channels,
                            "detect", device=device)
        prefix_map = dict(SEGPP_PREFIX_MAP)
    else:
        model = build_yolo(args.arch, args.variant, nc=args.nc,
                           ch=args.channels, task=args.task, device=device)
        prefix_map = {}
    if args.prefix_map:
        prefix_map.update(json.loads(args.prefix_map))
    sd = {_port_name(k, prefix_map): v for k, v in torch_sd.items()}
    own = model.state_dict()
    missing = [k for k in own if k not in sd and not _derived(k)]
    unused = [k for k in torch_sd if _port_name(k, prefix_map) not in own]
    if missing and not args.lenient:
        raise KeyError(f"{len(missing)} template leaves unmatched; first: "
                       f"{missing[:5]}")
    model.load_state_dict({k: sd.get(k, v) for k, v in own.items()},
                          strict=True)
    report = {"matched": sum(1 for k in own if k in sd and not _derived(k)),
              "missing": missing, "unused": unused}
    print(f"matched {report['matched']} tensors; "
          f"missing {len(report['missing'])}, unused {len(report['unused'])}")
    for m in report["missing"][:8]:
        print("  missing:", m)
    for u in report["unused"][:8]:
        print("  unused torch key:", u)
    save_model(args.out, model)
    print(f"saved {args.out}")
    return report


if __name__ == "__main__":
    main()
