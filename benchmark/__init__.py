"""The benchmark of `yolou_tpu_torch` on NVIDIA H100 cards: `run.py` runs
one cell of `BENCHMARK.json`; see PERF.md for the cells and metrics."""
