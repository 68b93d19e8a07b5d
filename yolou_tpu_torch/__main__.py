"""`python -m yolou_tpu_torch <command>` — the command line dispatcher.

The counterpart of the JAX package's dispatcher, with its help text and its
exit codes (0 for help, 2 for an unknown command). `main(argv)` returns
what the command returns (metrics, histories, results), so a caller in the
same process can read it; run as a module, a command that returns exits 0.
All eleven of the JAX package's commands, in its order.
"""

import importlib
import sys

COMMANDS = {
    "train-decoder": "yolou_tpu_torch.cli.train_decoder",
    "train-detector": "yolou_tpu_torch.cli.train_detector",
    "evaluate": "yolou_tpu_torch.cli.evaluate",
    "predict": "yolou_tpu_torch.cli.predict",
    "val": "yolou_tpu_torch.cli.val",
    "convert": "yolou_tpu_torch.cli.convert",
    "export": "yolou_tpu_torch.cli.export",
    "generate-objectmaps": "yolou_tpu_torch.cli.generate_objectmaps",
    "generate-heatmaps": "yolou_tpu_torch.cli.generate_heatmaps",
    "visualize-logits": "yolou_tpu_torch.cli.visualize_logits",
    "profile": "yolou_tpu_torch.cli.profile",
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m yolou_tpu_torch <command> [args]\ncommands:")
        for c in COMMANDS:
            print(f"  {c}")
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; options: {', '.join(COMMANDS)}")
        return 2
    return importlib.import_module(COMMANDS[cmd]).main(argv[1:])


if __name__ == "__main__":
    out = main()
    sys.exit(out if isinstance(out, int) else 0)
