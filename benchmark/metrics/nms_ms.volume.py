"""Kernel B's (`yolou::greedy_nms`) device milliseconds a call in the
profiled stretch."""

from benchmark.layers import op_ms_per_call


def read(ctx):
    return op_ms_per_call(ctx, "yolou::greedy_nms")
