"""Device kernels launched in the profiled stretch over the images it
completed: the host-dispatch layer's count."""

from benchmark.layers import launches_per_image


def read(ctx):
    return launches_per_image(ctx)
