"""Kernel B: greedy NMS keep mask (CUDA, sm_90a), batched over images.

Replaces the TPU kernel `yolou_tpu/ops/pallas_nms.py::suppress_greedy_fused`
(body `_nms_kernel`). Source: `../csrc/greedy_nms.cu`: one launch, a
thread-block cluster of up to 8 CTAs per image; every IoU test first, in
parallel, as bits in the cluster's shared memory, then the greedy chain over
64-row windows on those bits alone; no scratch. The entry point is the
`torch.library` operator `yolou::greedy_nms` behind a checking wrapper, as
in `attention.py`.
"""

from __future__ import annotations

import torch

from . import build

MAX_K = 2048      # each CTA holds an image's boxes in shared memory (32 KB)


def nms_hit_matrix(boxes: torch.Tensor, valid: torch.Tensor,
                   iou_thres: float) -> torch.Tensor:
    """hit[b, j, i] = j < i and valid_j and inter > t * (union + 1e-7), the
    division-free IoU compare of the TPU kernel, in its operation order."""
    x1, y1, x2, y2 = boxes.unbind(-1)                      # (B, K)
    area = (x2 - x1) * (y2 - y1)
    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :])).clamp(min=0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :])).clamp(min=0)
    inter = iw * ih
    union = area[:, :, None] + area[:, None, :] - inter
    over = inter > iou_thres * (union + 1e-7)
    k = boxes.shape[1]
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    return over & later & valid[:, :, None]


def suppress_greedy_plain(boxes: torch.Tensor, valid: torch.Tensor,
                          iou_thres: float) -> torch.Tensor:
    """Plain PyTorch version: the hit matrix, then the fixpoint
    keep <- valid & ~any_j(keep_j & hit[j, i]), which is the greedy keep-set."""
    hit = nms_hit_matrix(boxes, valid, iou_thres)
    keep = valid.clone()
    for _ in range(boxes.shape[1]):
        new = valid & ~(hit & keep[:, :, None]).any(1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def _launch_greedy_nms(boxes, valid, iou_thres):
    """Launch kernel B on checked CUDA tensors; returns keep."""
    bsz, k, _ = boxes.shape
    if not 0 < k <= MAX_K or bsz == 0:
        raise ValueError(f"the CUDA kernel takes 0 < K <= {MAX_K} and B > 0, "
                         f"got B={bsz}, K={k}")
    lib = build.load()
    if boxes.data_ptr() % 16:
        raise ValueError("the CUDA kernel needs 16-byte aligned boxes")
    keep = torch.empty((bsz, k), dtype=torch.bool, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.yolou_greedy_nms(boxes.data_ptr(), valid.data_ptr(),
                                    keep.data_ptr(), bsz, k, float(iou_thres),
                                    stream)
    build.check(lib, code, "greedy NMS kernel")
    suppress_greedy.launches += 1
    return keep


def _greedy_nms_forward(boxes, valid, iou_thres):
    """Kernel B on a CUDA tensor, the plain version (whose loop runs until
    the keep set stops changing) on a CPU tensor: the real version of the
    operator. The loop's data-dependent end stays inside the operator, out
    of any graph a tracer records."""
    if boxes.device.type == "cpu":
        return suppress_greedy_plain(boxes, valid, iou_thres)
    if boxes.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {boxes.device}")
    return _launch_greedy_nms(boxes, valid, iou_thres)


greedy_nms_op = torch.library.custom_op(
    "yolou::greedy_nms", _greedy_nms_forward, mutates_args=(),
    schema="(Tensor boxes, Tensor valid, float iou_thres) -> Tensor")


@greedy_nms_op.register_fake
def _(boxes, valid, iou_thres):
    return torch.empty_like(valid)


def suppress_greedy(boxes: torch.Tensor, valid: torch.Tensor,
                    iou_thres: float) -> torch.Tensor:
    """Greedy NMS keep mask per image.

    boxes: (B, K, 4) float32 xyxy, each image's rows sorted by descending
    score; valid: (B, K) bool. Returns keep (B, K) bool: row i is kept iff
    it is valid and no kept row j < i overlaps it with IoU > iou_thres.
    """
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    bsz, k, _ = boxes.shape
    if tuple(valid.shape) != (bsz, k):
        raise ValueError(f"valid {tuple(valid.shape)} does not match boxes")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"need float32 boxes and bool valid, got "
                        f"{boxes.dtype}, {valid.dtype}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    if boxes.device != valid.device:
        raise ValueError("boxes and valid must be on one device")
    return greedy_nms_op(boxes, valid, float(iou_thres))


suppress_greedy.launches = 0
