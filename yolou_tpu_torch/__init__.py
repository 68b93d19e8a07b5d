"""PyTorch + CUDA port of yolou_tpu for NVIDIA Hopper (H100).

The package serves YOLOv12n-seg: uint8 images -> letterbox -> forward ->
DFL decode -> greedy NMS -> proto masks. Tensors are NCHW; public ops keep
the JAX package's layouts (attention bands (G, N, C), boxes (..., 4)) so the
two can be compared directly. The two TPU kernels on that path are
hand-written CUDA kernels here (`kernels/`, sources in `csrc/`); on a CPU
tensor each kernel wrapper runs its plain PyTorch version instead.

This package imports neither JAX nor `yolou_tpu`.
"""

__version__ = "0.1.0"
