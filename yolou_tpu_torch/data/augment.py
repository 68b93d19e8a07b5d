"""Training augmentation on the trainer's device, batched, fixed shapes.

Counterpart of `yolou_tpu/data/augment.py`: Mosaic -> random affine ->
MixUp / CutMix / CopyPaste -> resolution degradation -> per-channel Gaussian
noise -> mild blur -> bias field -> HSV -> flips, then the loss targets.
Layouts are the JAX package's: images (B, S, S, C) float32 in [0, 1],
instance labels as an overlap-encoded id map (B, S, S) int (0 = background,
j + 1 = instance j), images warped bilinearly and id maps nearest.

Every random op is split in two: `draw_*` takes the `torch.Generator` and
returns the op's parameters, the op itself takes the parameters. A
`torch.Generator` cannot repeat `jax.random`'s numbers, so it is the second
halves, and the pipeline with every probability and range at 0, that are
held against the JAX package.

Two TPU rewrites there are not carried over, each computing the same
function: `affine_warp_separable` (row and column takes for the rotation-free
case; here one general gather warp) and the compare-and-sum forms inside
`reduce_instances` (here a bincount and a table lookup).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from ..ops.nms import topk_stable
from ..ops.resize import resize_linear

GRAY = 114.0 / 255.0


@dataclasses.dataclass(frozen=True)
class AugHyp:
    mosaic: float = 1.0
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    flipud: float = 0.0
    fliplr: float = 0.5
    mixup: float = 0.0
    cutmix: float = 0.0
    copy_paste: float = 0.0
    resolution_p: float = 0.0       # random resolution degradation (off)
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    noise_p: float = 0.25
    noise_lo: float = 0.01
    noise_hi: float = 0.05
    blur_p: float = 0.15
    blur_sigma_lo: float = 0.5
    blur_sigma_hi: float = 1.5
    bias_p: float = 0.15
    bias_alpha_lo: float = 0.1
    bias_alpha_hi: float = 0.3
    bias_smoothness: float = 0.3


# ---------------------------------------------------------------- draws

def _uniform(gen: torch.Generator, shape, lo: float = 0.0,
             hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return lo + (hi - lo) * u


def _rows(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) with `ndim` dims, to gate per image."""
    return t.reshape((-1,) + (1,) * (ndim - 1))


# ---------------------------------------------------------------- warp

def affine_warp(img: torch.Tensor, idmap: torch.Tensor, minv: torch.Tensor,
                out_size: int, fill: float = GRAY
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp images (B, H, W, C) and id maps (B, H, W) by the inverse affines
    `minv` (B, 2, 3), output pixel -> input pixel, to out_size^2. Images are
    sampled bilinearly with taps outside the input reading `fill`, id maps
    at the nearest pixel with 0 outside."""
    b, h, w, _ = img.shape
    r = torch.arange(out_size, dtype=torch.float32, device=img.device)
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    m = minv[:, :, :, None, None]
    sx = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]         # (B, S, S)
    sy = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    bi = torch.arange(b, device=img.device)[:, None, None]

    def inside(yy, xx):
        return (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)

    def tap(yy, xx):
        v = img[bi, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return torch.where(inside(yy, xx)[..., None], v, fill)

    x0, y0 = sx.floor().long(), sy.floor().long()
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    out = ((tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx) * (1 - fy)
           + (tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx) * fy)
    xi, yi = sx.round().long(), sy.round().long()
    ids = idmap[bi, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
    return out, torch.where(inside(yi, xi), ids, 0)


def draw_affine(gen: torch.Generator, b: int, hyp: AugHyp,
                out_size: float) -> Dict[str, torch.Tensor]:
    """Per image: rotation and the two shears in degrees, scale, and the
    translation in output pixels."""
    return {
        "degrees": _uniform(gen, (b,), -hyp.degrees, hyp.degrees),
        "scale": _uniform(gen, (b,), 1 - hyp.scale, 1 + hyp.scale),
        "shear_x": _uniform(gen, (b,), -hyp.shear, hyp.shear),
        "shear_y": _uniform(gen, (b,), -hyp.shear, hyp.shear),
        "translate": _uniform(gen, (b, 2), -hyp.translate,
                              hyp.translate) * out_size,
    }


def affine_inverse(p: Dict[str, torch.Tensor], in_size: float,
                   out_size: float) -> torch.Tensor:
    """Inverse affines (B, 2, 3), output px -> input px, of the forward map
    p_out = T . Shear . Rot*Scale . (p_in - c_in) + c_out. With every range
    at 0 and in_size == out_size it is exactly the identity."""
    th = p["degrees"] * (math.pi / 180.0)
    cos, sin = torch.cos(th) * p["scale"], torch.sin(th) * p["scale"]
    fwd = torch.stack([torch.stack([cos, -sin], -1),
                       torch.stack([sin, cos], -1)], -2)          # (B, 2, 2)
    shx = torch.tan(p["shear_x"] * (math.pi / 180.0))
    shy = torch.tan(p["shear_y"] * (math.pi / 180.0))
    one = torch.ones_like(shx)
    sh = torch.stack([torch.stack([one, shx], -1),
                      torch.stack([shy, one], -1)], -2)
    a = sh @ fwd
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    inv = torch.stack([torch.stack([a[:, 1, 1], -a[:, 0, 1]], -1),
                       torch.stack([-a[:, 1, 0], a[:, 0, 0]], -1)],
                      -2) / det[:, None, None]
    t = out_size / 2.0 + p["translate"]                           # (B, 2)
    off = -(inv @ t[..., None])[..., 0] + in_size / 2.0
    return torch.cat([inv, off[..., None]], -1)


# ---------------------------------------------------------------- mosaic

def draw_mosaic(gen: torch.Generator, b: int, s: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A batch permutation and per-image mosaic centres (yc, xc), each in
    [S/2, 3S/2]."""
    perm = torch.randperm(b, generator=gen, device=gen.device)
    centers = torch.randint(s // 2, 3 * s // 2 + 1, (b, 2), generator=gen,
                            device=gen.device)
    return perm, centers


def mosaic4(img: torch.Tensor, idmap: torch.Tensor, cls: torch.Tensor,
            valid: torch.Tensor, perm: torch.Tensor, centers: torch.Tensor):
    """Batch mosaic: output i is a 2S x 2S canvas of images i, perm[i] and
    two rolls of perm meeting at centers[i] (ultralytics Mosaic: quadrant q
    shows the corner of image q next to the centre, gray 114 where an image
    does not reach). Instance ids are offset per quadrant (quadrant q hosts
    ids q*G+1 .. q*G+G); cls / valid grow to 4G slots.

    Every quadrant's content is the fixed 2 x 2 grid of the four images
    shifted by (yc - S, xc - S), so one wrapped index per axis plus an
    in-bounds mask gives the paste."""
    b, s = img.shape[:2]
    g = cls.shape[1]
    rolls = [torch.arange(b, device=img.device), perm, perm.roll(1),
             perm.roll(2)]
    grid = torch.cat([torch.cat([img[rolls[0]], img[rolls[1]]], 2),
                      torch.cat([img[rolls[2]], img[rolls[3]]], 2)], 1)
    m4 = [torch.where(idmap[r] > 0, idmap[r] + q * g, 0)
          for q, r in enumerate(rolls)]
    gids = torch.cat([torch.cat([m4[0], m4[1]], 2),
                      torch.cat([m4[2], m4[3]], 2)], 1)           # (B,2S,2S)
    pos = torch.arange(2 * s, device=img.device)[None, :]
    yc, xc = centers[:, :1], centers[:, 1:]
    qy = torch.where(pos < yc, pos - yc + s, pos - yc)            # (B, 2S)
    qx = torch.where(pos < xc, pos - xc + s, pos - xc)
    inb = (((qy >= 0) & (qy < s))[:, :, None]
           & ((qx >= 0) & (qx < s))[:, None, :])
    rows = ((pos - (yc - s)) % (2 * s))[:, :, None]
    cols = ((pos - (xc - s)) % (2 * s))[:, None, :]
    bi = torch.arange(b, device=img.device)[:, None, None]
    canvas = torch.where(inb[..., None], grid[bi, rows, cols], GRAY)
    ids = torch.where(inb, gids[bi, rows, cols], 0)
    cls4 = torch.cat([cls[r] for r in rolls], 1)                  # (B, 4G)
    val4 = torch.cat([valid[r] for r in rolls], 1)
    return canvas, ids, cls4, val4


def reduce_instances(idmap: torch.Tensor, cls: torch.Tensor,
                     valid: torch.Tensor, g_out: int):
    """Keep the g_out largest surviving instances (equal areas in slot
    order); remap their ids to 1 .. g_out, the rest to 0."""
    b = idmap.shape[0]
    g_in = cls.shape[1]
    flat = idmap.reshape(b, -1).long()
    counts = torch.zeros((b, g_in + 1), dtype=torch.float32,
                         device=idmap.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.float32))
    areas = counts[:, 1:] * valid.float()                         # (B, G_in)
    top_area, top_idx = topk_stable(areas, g_out)                 # (B, g_out)
    new_valid = top_area > 0
    new_cls = cls.gather(1, top_idx)
    new_id = (torch.arange(1, g_out + 1, device=idmap.device)
              * new_valid).to(idmap.dtype)                        # (B, g_out)
    table = torch.zeros((b, g_in + 1), dtype=idmap.dtype,
                        device=idmap.device)
    table.scatter_(1, top_idx + 1, new_id)
    return table.gather(1, flat).reshape(idmap.shape), new_cls, new_valid


# ---------------------------------------------------------------- photometric

def draw_blur(gen, b: int, hyp: AugHyp):
    return (_uniform(gen, (b,)) < hyp.blur_p,
            _uniform(gen, (b,), hyp.blur_sigma_lo, hyp.blur_sigma_hi))


def mild_gaussian_blur(img: torch.Tensor, apply: torch.Tensor,
                       sigma: torch.Tensor) -> torch.Tensor:
    """Separable 3x3 Gaussian blur (edge-replicated) of the images whose
    `apply` is set, each with its own sigma."""
    x = torch.tensor([-1.0, 0.0, 1.0], device=img.device)
    k = torch.exp(-(x ** 2) / (2 * sigma[:, None] ** 2))
    k = (k / k.sum(1, keepdim=True))[:, :, None, None, None]      # (B,3,1,1,1)
    pad = torch.cat([img[:, :, :1], img, img[:, :, -1:]], 2)
    h = pad[:, :, :-2] * k[:, 0] + pad[:, :, 1:-1] * k[:, 1] + pad[:, :, 2:] * k[:, 2]
    hp = torch.cat([h[:, :1], h, h[:, -1:]], 1)
    out = hp[:, :-2] * k[:, 0] + hp[:, 1:-1] * k[:, 1] + hp[:, 2:] * k[:, 2]
    return torch.where(_rows(apply, 4), out, img)


def draw_noise(gen, shape, hyp: AugHyp):
    b, _, _, c = shape
    return (_uniform(gen, (b,)) < hyp.noise_p,
            _uniform(gen, (b, 1, 1, c), hyp.noise_lo, hyp.noise_hi),
            torch.randn(shape, generator=gen, device=gen.device))


def gaussian_noise_per_channel(img, apply, std, noise) -> torch.Tensor:
    return torch.where(_rows(apply, 4), (img + noise * std).clamp(0.0, 1.0),
                       img)


def draw_bias_field(gen, b: int, hyp: AugHyp) -> Dict[str, torch.Tensor]:
    return {"apply": _uniform(gen, (b,)) < hyp.bias_p,
            "center": _uniform(gen, (b, 2), -1, 1),
            "alpha": _uniform(gen, (b,), hyp.bias_alpha_lo, hyp.bias_alpha_hi),
            "scale": _uniform(gen, (b, 2), 0.5, 2.0),
            "invert": _uniform(gen, (b,)) > 0.5}


def random_bias_field(img: torch.Tensor, p: Dict[str, torch.Tensor],
                      smoothness: float) -> torch.Tensor:
    """Elliptical multiplicative bias field (an MRI coil's), invertible."""
    _, h, w, _ = img.shape
    gx = torch.linspace(-1, 1, w, device=img.device)[None, None, :]
    gy = torch.linspace(-1, 1, h, device=img.device)[None, :, None]
    c, sc = p["center"], p["scale"]
    d2 = (((gx - _rows(c[:, 0], 3)) * _rows(sc[:, 0], 3)) ** 2
          + ((gy - _rows(c[:, 1], 3)) * _rows(sc[:, 1], 3)) ** 2)
    bias = 1 + _rows(p["alpha"], 3) * torch.exp(-d2 / (2 * smoothness ** 2))
    bias = torch.where(_rows(p["invert"], 3), 2 - bias, bias).clamp(0.5, 1.5)
    out = (img * bias[..., None]).clamp(0.0, 1.0)
    return torch.where(_rows(p["apply"], 4), out, img)


def draw_hsv(gen, b: int, hyp: AugHyp):
    return (_uniform(gen, (b, 1, 1), -hyp.hsv_h, hyp.hsv_h),
            1 + _uniform(gen, (b, 1, 1), -hyp.hsv_s, hyp.hsv_s),
            1 + _uniform(gen, (b, 1, 1), -hyp.hsv_v, hyp.hsv_v))


def random_hsv(img: torch.Tensor, dh, ds, dv) -> torch.Tensor:
    """HSV jitter for 3-channel inputs; identity otherwise (4-channel MRI)."""
    if img.shape[-1] != 3:
        return img
    hsv = _rgb_to_hsv(img)
    h = torch.remainder(hsv[..., 0] + dh, 1.0)
    s = (hsv[..., 1] * ds).clamp(0, 1)
    v = (hsv[..., 2] * dv).clamp(0, 1)
    return _hsv_to_rgb(torch.stack([h, s, v], -1))


def _rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(-1)
    mx = rgb.amax(-1)
    d = mx - rgb.amin(-1) + 1e-12
    h = torch.where(mx == r, torch.remainder((g - b) / d, 6),
                    torch.where(mx == g, (b - r) / d + 2, (r - g) / d + 4)) / 6.0
    s = torch.where(mx > 0, d / (mx + 1e-12), 0.0)
    return torch.stack([h, s, mx], -1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = h.floor()
    f = h - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.long() % 6

    def select(choices):
        return torch.stack(choices, -1).gather(-1, i[..., None])[..., 0]

    return torch.stack([select([v, q, p, p, t, v]), select([t, v, v, q, p, p]),
                        select([p, p, t, v, v, q])], -1)


def draw_flips(gen, b: int, hyp: AugHyp):
    return _uniform(gen, (b,)) < hyp.flipud, _uniform(gen, (b,)) < hyp.fliplr


def random_flips(img, idmap, ud, lr):
    img = torch.where(_rows(ud, 4), img.flip(1), img)
    idmap = torch.where(_rows(ud, 3), idmap.flip(1), idmap)
    img = torch.where(_rows(lr, 4), img.flip(2), img)
    idmap = torch.where(_rows(lr, 3), idmap.flip(2), idmap)
    return img, idmap


# ---------------------------------------------------------------- mixing

def _join_labels(cls, valid, partner_valid):
    """Label slots of an image followed by its rolled partner's."""
    return (torch.cat([cls, cls.roll(1, 0)], 1),
            torch.cat([valid, partner_valid], 1))


def draw_mixup(gen, b: int, p: float):
    """Gate and the mixing weight lam ~ Beta(32, 32), drawn as a ratio of two
    Gamma(32) variates, each a sum of 32 exponentials."""
    apply = _uniform(gen, (b,)) < p
    x, y = -torch.log(_uniform(gen, (2, b, 32)).clamp(min=1e-12)).sum(-1)
    return apply, x / (x + y)


def mixup(img, idmap, cls, valid, apply, lam):
    """Blend each gated image with the previous one of the batch; the
    partner's instances join as ids G+1 .. 2G where the image has none."""
    g = cls.shape[1]
    lam4 = _rows(lam, 4)
    mixed = img * lam4 + img.roll(1, 0) * (1 - lam4)
    img = torch.where(_rows(apply, 4), mixed, img)
    id2 = idmap.roll(1, 0)
    joined = torch.where((idmap == 0) & (id2 > 0) & _rows(apply, 3),
                         id2 + g, idmap)
    return (img, joined,
            *_join_labels(cls, valid, valid.roll(1, 0) & apply[:, None]))


def draw_cutmix(gen, b: int, s: int, p: float):
    return (_uniform(gen, (b,)) < p, _uniform(gen, (b, 2), 0.2, 0.8) * s,
            _uniform(gen, (b, 2), 0.2, 0.5) * s)


def cutmix(img, idmap, cls, valid, apply, cxy, wh):
    """Paste a rectangle of the previous image of the batch; labels join."""
    s = img.shape[1]
    g = cls.shape[1]
    r = torch.arange(s, device=img.device)
    ys, xs = r[None, :, None], r[None, None, :]
    in_box = ((xs >= _rows(cxy[:, 0] - wh[:, 0] / 2, 3))
              & (xs < _rows(cxy[:, 0] + wh[:, 0] / 2, 3))
              & (ys >= _rows(cxy[:, 1] - wh[:, 1] / 2, 3))
              & (ys < _rows(cxy[:, 1] + wh[:, 1] / 2, 3))
              & _rows(apply, 3))
    id2 = idmap.roll(1, 0)
    img = torch.where(in_box[..., None], img.roll(1, 0), img)
    idmap = torch.where(in_box, torch.where(id2 > 0, id2 + g, 0), idmap)
    return (img, idmap,
            *_join_labels(cls, valid, valid.roll(1, 0) & apply[:, None]))


def copy_paste_flip(img, idmap, cls, valid, apply):
    """Paste the horizontally mirrored instances of the same image onto its
    free background (ultralytics copy_paste_mode='flip')."""
    g = cls.shape[1]
    fid = idmap.flip(2)
    paste = (fid > 0) & (idmap == 0) & _rows(apply, 3)
    img = torch.where(paste[..., None], img.flip(2), img)
    idmap = torch.where(paste, fid + g, idmap)
    return (img, idmap, torch.cat([cls, cls], 1),
            torch.cat([valid, valid & apply[:, None]], 1))


RESOLUTION_SCALES = (0.6, 0.75, 0.9)


def draw_resolution(gen, b: int, hyp: AugHyp):
    return (_uniform(gen, (b,)) < hyp.resolution_p,
            torch.randint(0, 3, (b,), generator=gen, device=gen.device))


def random_resolution(img, apply, which) -> torch.Tensor:
    """Down-up linear resample of the gated images by one of three scales."""
    s = img.shape[1]
    out = img
    for i, scale in enumerate(RESOLUTION_SCALES):
        t = max(8, int(s * scale))
        low = resize_linear(img, (t, t), dims=(1, 2))
        out = torch.where(_rows(apply & (which == i), 4),
                          resize_linear(low, (s, s), dims=(1, 2)), out)
    return out


# ---------------------------------------------------------------- finalize

def boxes_from_idmap(idmap: torch.Tensor, g: int) -> torch.Tensor:
    """(B, S, S) id map -> (B, G, 4) normalised xywh from instance extents."""
    s = idmap.shape[1]
    ids = torch.arange(1, g + 1, device=idmap.device)
    onehot = idmap[:, None, :, :] == ids[None, :, None, None]     # (B,G,S,S)
    rows, cols = onehot.any(3), onehot.any(2)                     # (B,G,S)
    yy = torch.arange(s, dtype=torch.float32, device=idmap.device)
    big = torch.tensor(float(s), device=idmap.device)
    zero = torch.zeros((), device=idmap.device)
    y1 = torch.where(rows, yy, big).amin(-1)
    y2 = torch.where(rows, yy + 1, zero).amax(-1)
    x1 = torch.where(cols, yy, big).amin(-1)
    x2 = torch.where(cols, yy + 1, zero).amax(-1)
    out = torch.stack([(x1 + x2) / 2 / s, (y1 + y2) / 2 / s,
                       (x2 - x1).clamp(min=0) / s,
                       (y2 - y1).clamp(min=0) / s], -1)
    return out * rows.any(-1)[..., None]


def masks_at_proto_res(idmap: torch.Tensor, g: int,
                       ratio: int = 4) -> torch.Tensor:
    """(B, S, S) -> per-instance float masks (B, G, S/r, S/r), nearest."""
    small = idmap[:, ::ratio, ::ratio]
    ids = torch.arange(1, g + 1, device=idmap.device)
    return (small[:, None] == ids[None, :, None, None]).float()


def augment_batch(img: torch.Tensor, idmap: torch.Tensor, cls: torch.Tensor,
                  valid: torch.Tensor, generator: torch.Generator,
                  hyp: AugHyp = AugHyp(), g_out: int = 16,
                  mask_ratio: int = 4,
                  use_mosaic: bool = True) -> Dict[str, torch.Tensor]:
    """The whole train-time pipeline. img float32 in [0, 1] (B, S, S, C),
    idmap (B, S, S) int, cls (B, G) int, valid (B, G) bool, all on
    `generator`'s device. Returns the loss batch: img, cls (B, g_out), bboxes
    xywh normalised, valid, masks (proto resolution)."""
    gen = generator
    b, s = img.shape[:2]
    idmap = idmap.long()

    if use_mosaic and hyp.mosaic > 0:
        canvas, mcanvas, cls4, val4 = mosaic4(img, idmap, cls, valid,
                                              *draw_mosaic(gen, b, s))
        in_size = 2 * s
        # per image: with probability 1 - mosaic, the image alone, centred
        # on the 2S canvas
        lo, hi = s // 2, s // 2 + s
        single = torch.full_like(canvas, GRAY)
        single[:, lo:hi, lo:hi] = img
        m_single = torch.zeros_like(mcanvas)
        m_single[:, lo:hi, lo:hi] = idmap
        use = _uniform(gen, (b,)) < hyp.mosaic
        canvas = torch.where(_rows(use, 4), canvas, single)
        mcanvas = torch.where(_rows(use, 3), mcanvas, m_single)
        g4 = cls4.shape[1]
        keep_first = torch.arange(g4, device=img.device) < g4 // 4
        cls, valid = cls4, torch.where(use[:, None], val4,
                                       val4 & keep_first[None])
    else:
        canvas, mcanvas, in_size = img, idmap, s

    minv = affine_inverse(draw_affine(gen, b, hyp, s), in_size, s)
    img, idmap = affine_warp(canvas, mcanvas, minv, s)

    if hyp.mixup > 0:     # a gate on the setting: p = 0 must not double
        img, idmap, cls, valid = mixup(img, idmap, cls, valid,   # the slots
                                       *draw_mixup(gen, b, hyp.mixup))
    if hyp.cutmix > 0:
        img, idmap, cls, valid = cutmix(img, idmap, cls, valid,
                                        *draw_cutmix(gen, b, s, hyp.cutmix))
    if hyp.copy_paste > 0:
        img, idmap, cls, valid = copy_paste_flip(
            img, idmap, cls, valid, _uniform(gen, (b,)) < hyp.copy_paste)

    if hyp.resolution_p > 0:
        img = random_resolution(img, *draw_resolution(gen, b, hyp))
    img = gaussian_noise_per_channel(img, *draw_noise(gen, img.shape, hyp))
    img = mild_gaussian_blur(img, *draw_blur(gen, b, hyp))
    img = random_bias_field(img, draw_bias_field(gen, b, hyp),
                            hyp.bias_smoothness)
    img = random_hsv(img, *draw_hsv(gen, b, hyp))
    img, idmap = random_flips(img, idmap, *draw_flips(gen, b, hyp))

    idmap, cls, valid = reduce_instances(idmap, cls, valid, g_out)
    bboxes = boxes_from_idmap(idmap, g_out)
    masks = masks_at_proto_res(idmap, g_out, mask_ratio)
    valid = valid & (bboxes[..., 2] > 0) & (bboxes[..., 3] > 0)
    return {"img": img, "cls": cls, "bboxes": bboxes, "valid": valid,
            "masks": masks}
