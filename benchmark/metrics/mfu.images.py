"""The whole request's share of the card's peak, in %: the operations of
one request (counted over the plain reference by FlopCounterMode) times
the requests of the untraced window, over its wall seconds and the peak of
the configuration's compute precision (bf16 989 TFLOP/s; TF32 495 where
float32 convolutions run on TF32 tensor cores)."""

from benchmark.layers import mfu


def read(ctx):
    return mfu(ctx)
