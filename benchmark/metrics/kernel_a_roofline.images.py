"""Kernel A's (`yolou::band_attention_qkv`) share of its roofline, in %:
the least time of its calls from their shapes over the device time under
them in the profiled stretch."""

from benchmark.layers import band_attention_qkv_roofline


def read(ctx):
    return band_attention_qkv_roofline(ctx, "yolou::band_attention_qkv")
