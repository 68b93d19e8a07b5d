"""Plain reference of YOLO-Seg++'s decoder training steps: the soft Dice
loss (MONAI's DiceLoss as the reference trains with it: sigmoid, soft
labels, one global Dice over the batch, smoothing 1e-5) and AdamW (torch's
update rule, written out) under the cosine schedule, over the decoder's
parameters only; the encoder stays frozen and in inference mode, the
decoder's BatchNorms in training mode. Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch


def soft_dice_loss(logits: torch.Tensor, target: torch.Tensor,
                   smooth: float = 1e-5) -> torch.Tensor:
    p = torch.sigmoid(logits.float())
    g = target.float()
    inter = torch.minimum(p, g).sum()
    return 1.0 - (2.0 * inter + smooth) / (p.sum() + g.sum() + smooth)


def cosine(step: int, decay_steps: int) -> float:
    """The learning rate's factor at update `step`: 0.5 (1 + cos(pi
    min(step, T) / T))."""
    return 0.5 * (1.0 + math.cos(math.pi * min(step, decay_steps)
                                 / decay_steps))


def trainable(model) -> List[Tuple[str, torch.nn.Parameter]]:
    return [(n, p) for n, p in model.named_parameters()
            if not n.startswith("yolo.")]


def adamw_steps(model, batches: Sequence[tuple], lr: float, decay_steps: int,
                betas=(0.9, 0.999), eps: float = 1e-8, wd: float = 0.01,
                input_dtype=torch.float32) -> Dict[str, object]:
    """Train `model` (the reference SegPP) in place over `batches` of (img
    (B, C, S, S) in [0, 1], mask (B, 1, S, S) in {0, 1}, objectmap (B, 1,
    S/8, S/8)). Returns each step's loss, each leaf's first gradient norm
    and each leaf's change norm after the last step."""
    params = trainable(model)
    start = {n: p.detach().clone() for n, p in params}
    m = {n: torch.zeros_like(p) for n, p in params}
    v = {n: torch.zeros_like(p) for n, p in params}
    losses, first_grad = [], {}
    model.train()
    for t, (img, mask, om) in enumerate(batches, 1):
        for _, p in params:
            p.grad = None
        logits, _ = model(img.to(input_dtype), om)
        loss = soft_dice_loss(logits, mask)
        loss.backward()
        losses.append(float(loss.detach()))
        step_lr = lr * cosine(t - 1, decay_steps)
        with torch.no_grad():
            for n, p in params:
                g = p.grad.float()
                if t == 1:
                    first_grad[n] = float(g.norm())
                p.mul_(1.0 - step_lr * wd)
                m[n].lerp_(g, 1.0 - betas[0])
                v[n].mul_(betas[1]).addcmul_(g, g, value=1.0 - betas[1])
                denom = (v[n].sqrt() / math.sqrt(1.0 - betas[1] ** t)).add_(eps)
                p.addcdiv_(m[n], denom, value=-step_lr / (1.0 - betas[0] ** t))
    change = {n: float((p.detach() - start[n]).norm()) for n, p in params}
    return {"losses": losses, "first_grad": first_grad, "change": change}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Sequence[str]) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf."""
    median = sorted(ref[n] for n in leaves)[len(leaves) // 2]
    return max(abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
               for n in leaves)
