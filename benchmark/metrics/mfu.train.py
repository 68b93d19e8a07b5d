"""The whole training step's share of the card's peak, in %: forward and
backward operations of one step (FlopCounterMode over the plain
reference; the optimizer's elementwise work not counted) times the steps
of the untraced window, over its wall seconds and the configuration's
peak (TF32 495 TFLOP/s where float32 convolutions run on TF32)."""

from benchmark.layers import mfu


def read(ctx):
    return mfu(ctx)
