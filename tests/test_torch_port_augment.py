"""PyTorch port: the device augmentation against the JAX package, f32 CPU.

`jax.random` and `torch.Generator` give different numbers, so each op is
held against its JAX op with the parameters given (a fixed inverse affine,
fixed flags, centres, permutation, noise), and the whole pipeline with every
probability and range at 0, where no draw matters. Integer outputs (id maps,
classes, validity) must be equal; float outputs within 1e-6 (2e-6 for the
warp, whose JAX counterpart interpolates rows then columns).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.data import augment as jaug
from yolou_tpu_torch.data import augment as taug

from .torch_threads import one_torch_thread  # noqa: F401

S, B, G, C = 32, 4, 3, 4


def _batch(seed=0, c=C):
    rng = np.random.default_rng(seed)
    img = rng.random((B, S, S, c), np.float32)
    idmap = np.zeros((B, S, S), np.int32)
    for i in range(B):
        for j in range(G - (i == 1)):          # image 1 has an empty slot
            y, x = rng.integers(0, S - 10, 2)
            h, w = rng.integers(3, 10, 2)
            idmap[i, y:y + h, x:x + w] = j + 1
    cls = rng.integers(0, 3, (B, G)).astype(np.int32)
    valid = np.ones((B, G), bool)
    valid[1, G - 1] = False
    return img, idmap, cls, valid


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _eq(got, want, atol=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    if atol is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


MINVS = {
    "identity": [[1, 0, 0], [0, 1, 0]],
    "scale-shift": [[1.3, 0, -3.7], [0, 0.8, 2.2]],
    "rotate-shear": [[0.9, -0.35, 6.0], [0.4, 1.1, -5.5]],
}


@pytest.mark.parametrize("name", list(MINVS))
def test_affine_warp_matches_jax(name):
    img, idmap, _, _ = _batch(1)
    minv = np.float32(MINVS[name])
    warp = (jaug.affine_warp if name == "rotate-shear"
            else jaug.affine_warp_separable)
    want = jax.vmap(lambda im, mm: warp(im, mm, jnp.asarray(minv), S))(
        jnp.asarray(img), jnp.asarray(idmap))
    got = taug.affine_warp(*_t(img, idmap),
                           torch.from_numpy(minv).expand(B, 2, 3), S)
    _eq(got[0], want[0], atol=2e-6)
    _eq(got[1], want[1])
    if name == "identity":
        _eq(got[0], img)
    # the general JAX warp too, from a 2S canvas down to S
    big = np.tile(img, (1, 2, 2, 1))
    bigm = np.tile(idmap, (1, 2, 2))
    want = jax.vmap(lambda im, mm: jaug.affine_warp(
        im, mm, jnp.asarray(minv * 1.7), S))(jnp.asarray(big),
                                             jnp.asarray(bigm))
    got = taug.affine_warp(*_t(big, bigm),
                           torch.from_numpy(minv * 1.7).expand(B, 2, 3), S)
    _eq(got[0], want[0], atol=2e-6)
    _eq(got[1], want[1])


def test_affine_inverse_is_the_identity_with_all_ranges_zero():
    hyp = taug.AugHyp(degrees=0, translate=0, scale=0, shear=0)
    p = taug.draw_affine(torch.Generator().manual_seed(0), B, hyp, S)
    minv = taug.affine_inverse(p, S, S)
    assert torch.equal(minv, torch.tensor([[1., 0, 0], [0, 1, 0]]).expand(B, 2, 3))
    # and against the JAX construction for given parameters
    p = {"degrees": torch.tensor([10.0, -4.0]), "scale": torch.tensor([1.2, 0.7]),
         "shear_x": torch.tensor([2.0, 0.0]), "shear_y": torch.tensor([-1.0, 3.0]),
         "translate": torch.tensor([[1.5, -2.0], [0.0, 4.0]])}
    got = taug.affine_inverse(p, 2 * S, S)
    for i in range(2):
        th = np.deg2rad(p["degrees"][i].item())
        sc = p["scale"][i].item()
        fwd = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]) * sc
        sh = np.array([[1, np.tan(np.deg2rad(p["shear_x"][i].item()))],
                       [np.tan(np.deg2rad(p["shear_y"][i].item())), 1]])
        inv = np.linalg.inv(sh @ fwd)
        t = S / 2 + p["translate"][i].numpy()
        want = np.concatenate([inv, (-inv @ t + S)[:, None]], 1)
        np.testing.assert_allclose(got[i].numpy(), want, atol=1e-5)


def test_mosaic4_matches_jax_for_given_permutation_and_centres():
    img, idmap, cls, valid = _batch(2)
    perm = np.array([2, 0, 3, 1])
    centers = np.array([[S // 2, 3 * S // 2], [S, S], [20, 41], [47, 17]])
    rolls = [np.arange(B), perm, np.roll(perm, 1), np.roll(perm, 2)]
    img4 = np.stack([img[r] for r in rolls], 1)
    m4 = np.stack([np.where(idmap[r] > 0, idmap[r] + q * G, 0)
                   for q, r in enumerate(rolls)], 1)
    want_c, want_m = jax.vmap(jaug._mosaic_gather)(
        jnp.asarray(img4), jnp.asarray(m4), jnp.asarray(centers[:, 0]),
        jnp.asarray(centers[:, 1]))
    got = taug.mosaic4(*_t(img, idmap.astype(np.int64), cls, valid,
                           perm, centers))
    _eq(got[0], want_c, atol=1e-6)
    _eq(got[1], want_m)
    _eq(got[2], np.concatenate([cls[r] for r in rolls], 1))
    _eq(got[3], np.concatenate([valid[r] for r in rolls], 1))


def test_reduce_instances_boxes_and_masks_match_jax():
    img, idmap, cls, valid = _batch(3)
    # 2G slots in, G out; equal areas tie in slot order
    idmap2 = idmap.copy()
    idmap2[:, 20:24, 20:24] = G + 2
    idmap2[0, :4, :4] = G + 3
    idmap2[0, 4:8, :4] = 2 * G          # same area as slot G + 3
    cls2 = np.concatenate([cls, cls + 5], 1)
    valid2 = np.concatenate([valid, np.ones_like(valid)], 1)
    want = jaug.reduce_instances(jnp.asarray(idmap2), jnp.asarray(cls2),
                                 jnp.asarray(valid2), G)
    got = taug.reduce_instances(*_t(idmap2.astype(np.int64), cls2, valid2), G)
    for g_, w_ in zip(got, want):
        _eq(g_, w_)
    new_idmap = np.array(want[0])
    _eq(taug.boxes_from_idmap(torch.from_numpy(new_idmap), G),
        jaug.boxes_from_idmap(want[0], G), atol=1e-7)
    _eq(taug.masks_at_proto_res(torch.from_numpy(new_idmap), G, 4),
        jaug.masks_at_proto_res(want[0], G, 4))


def test_flips_mixing_ops_match_jax_for_given_flags():
    img, idmap, cls, valid = _batch(4)
    ti, tm, tc, tv = _t(img, idmap.astype(np.int64), cls, valid)
    ud = np.array([True, False, True, False])
    lr = np.array([True, True, False, False])
    want_i = jnp.where(ud[:, None, None, None], img[:, ::-1], img)
    want_m = jnp.where(ud[:, None, None], idmap[:, ::-1], idmap)
    want_i = jnp.where(lr[:, None, None, None], want_i[:, :, ::-1], want_i)
    want_m = jnp.where(lr[:, None, None], want_m[:, :, ::-1], want_m)
    got = taug.random_flips(ti, tm, *_t(ud, lr))
    _eq(got[0], want_i)
    _eq(got[1], want_m)

    apply = np.array([True, False, True, True])
    # mixup / cutmix / copy-paste: the JAX ops with their draws replaced
    lam = np.float32([0.4, 0.5, 0.55, 0.6])
    img2, id2 = np.roll(img, 1, 0), np.roll(idmap, 1, 0)
    l4 = lam[:, None, None, None]
    want_i = np.where(apply[:, None, None, None],
                      img * l4 + img2 * (1 - l4), img)
    want_m = np.where((idmap == 0) & (id2 > 0) & apply[:, None, None],
                      id2 + G, idmap)
    got = taug.mixup(ti, tm, tc, tv, *_t(apply, lam))
    _eq(got[0], want_i, atol=1e-7)
    _eq(got[1], want_m)
    _eq(got[2], np.concatenate([cls, np.roll(cls, 1, 0)], 1))
    _eq(got[3], np.concatenate([valid, np.roll(valid, 1, 0)
                                & apply[:, None]], 1))

    cxy = np.float32([[10, 12], [16, 16], [20, 9], [8, 25]])
    wh = np.float32([[8, 10], [12, 7], [9, 9], [14, 6]])
    ys, xs = np.arange(S)[None, :, None], np.arange(S)[None, None, :]
    box = ((xs >= (cxy[:, 0] - wh[:, 0] / 2)[:, None, None])
           & (xs < (cxy[:, 0] + wh[:, 0] / 2)[:, None, None])
           & (ys >= (cxy[:, 1] - wh[:, 1] / 2)[:, None, None])
           & (ys < (cxy[:, 1] + wh[:, 1] / 2)[:, None, None])
           & apply[:, None, None])
    got = taug.cutmix(ti, tm, tc, tv, *_t(apply, cxy, wh))
    _eq(got[0], np.where(box[..., None], img2, img))
    _eq(got[1], np.where(box, np.where(id2 > 0, id2 + G, 0), idmap))

    fid = idmap[:, :, ::-1]
    paste = (fid > 0) & (idmap == 0) & apply[:, None, None]
    got = taug.copy_paste_flip(ti, tm, tc, tv, torch.from_numpy(apply))
    _eq(got[0], np.where(paste[..., None], img[:, :, ::-1], img))
    _eq(got[1], np.where(paste, fid + G, idmap))
    _eq(got[3], np.concatenate([valid, valid & apply[:, None]], 1))


def test_photometric_ops_match_jax_with_its_own_draws():
    """Each JAX op draws from its key; the same draws (re-derived with the
    op's key splits) go to the port's second half."""
    img, _, _, _ = _batch(5)
    ti = torch.from_numpy(img)
    key = jax.random.key(7)

    hyp = jaug.AugHyp(blur_p=0.5)
    kp, ks = jax.random.split(key)
    apply = np.asarray(jax.random.uniform(kp, (B,)) < hyp.blur_p)
    sigma = np.asarray(jax.random.uniform(ks, (B,), minval=hyp.blur_sigma_lo,
                                          maxval=hyp.blur_sigma_hi))
    _eq(taug.mild_gaussian_blur(ti, *_t(apply, sigma)),
        jaug.mild_gaussian_blur(jnp.asarray(img), key, hyp), atol=1e-6)

    hyp = jaug.AugHyp(noise_p=0.5)
    kp, kstd, kn = jax.random.split(key, 3)
    apply = np.asarray(jax.random.uniform(kp, (B,)) < hyp.noise_p)
    std = np.asarray(jax.random.uniform(kstd, (B, 1, 1, C),
                                        minval=hyp.noise_lo,
                                        maxval=hyp.noise_hi))
    noise = np.asarray(jax.random.normal(kn, img.shape))
    _eq(taug.gaussian_noise_per_channel(ti, *_t(apply, std, noise)),
        jaug.gaussian_noise_per_channel(jnp.asarray(img), key, hyp),
        atol=1e-6)

    hyp = jaug.AugHyp(bias_p=0.6)
    kp, kc, ka, ks, ki = jax.random.split(key, 5)
    p = {"apply": jax.random.uniform(kp, (B,)) < hyp.bias_p,
         "center": jax.random.uniform(kc, (B, 2), minval=-1, maxval=1),
         "alpha": jax.random.uniform(ka, (B,), minval=hyp.bias_alpha_lo,
                                     maxval=hyp.bias_alpha_hi),
         "scale": jax.random.uniform(ks, (B, 2), minval=0.5, maxval=2.0),
         "invert": jax.random.uniform(ki, (B,)) > 0.5}
    p = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    _eq(taug.random_bias_field(ti, p, hyp.bias_smoothness),
        jaug.random_bias_field(jnp.asarray(img), key, hyp), atol=1e-6)


def test_hsv_and_resolution_match_jax():
    img, _, _, _ = _batch(6, c=3)
    key = jax.random.key(3)
    hyp = jaug.AugHyp()
    kh, ks, kv = jax.random.split(key, 3)
    dh = jax.random.uniform(kh, (B, 1, 1), minval=-hyp.hsv_h, maxval=hyp.hsv_h)
    ds = 1 + jax.random.uniform(ks, (B, 1, 1), minval=-hyp.hsv_s,
                                maxval=hyp.hsv_s)
    dv = 1 + jax.random.uniform(kv, (B, 1, 1), minval=-hyp.hsv_v,
                                maxval=hyp.hsv_v)
    got = taug.random_hsv(torch.from_numpy(img),
                          *_t(np.array(dh), np.array(ds), np.array(dv)))
    _eq(got, jaug.random_hsv(jnp.asarray(img), key, hyp), atol=2e-6)
    four = torch.rand(2, 8, 8, 4)
    assert taug.random_hsv(four, None, None, None) is four

    hyp = jaug.AugHyp(resolution_p=0.7)
    kp, ks = jax.random.split(key)
    apply = np.asarray(jax.random.uniform(kp, (B,)) < hyp.resolution_p)
    which = np.asarray(jax.random.randint(ks, (B,), 0, 3))
    assert apply.any()
    _eq(taug.random_resolution(torch.from_numpy(img), *_t(apply, which)),
        jaug.random_resolution(jnp.asarray(img), key, hyp), atol=2e-6)


OFF = dict(mosaic=0.0, degrees=0.0, translate=0.0, scale=0.0, shear=0.0,
           flipud=0.0, fliplr=0.0, mixup=0.0, cutmix=0.0, copy_paste=0.0,
           hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, noise_p=0.0, blur_p=0.0,
           bias_p=0.0)


@pytest.mark.parametrize("use_mosaic", [False, True])
def test_augment_batch_with_everything_off_matches_jax(use_mosaic):
    """mosaic = 0 takes the no-mosaic branch whatever `use_mosaic` says."""
    img, idmap, cls, valid = _batch(8)
    want = jaug.augment_batch(jnp.asarray(img), jnp.asarray(idmap),
                              jnp.asarray(cls), jnp.asarray(valid),
                              jax.random.key(0), jaug.AugHyp(**OFF), g_out=G,
                              mask_ratio=4, use_mosaic=use_mosaic)
    got = taug.augment_batch(*_t(img, idmap, cls, valid),
                             torch.Generator().manual_seed(0),
                             taug.AugHyp(**OFF), g_out=G, mask_ratio=4,
                             use_mosaic=use_mosaic)
    assert sorted(got) == sorted(want)
    _eq(got["img"], img)
    for k in ("cls", "valid", "masks"):
        _eq(got[k], want[k])
    _eq(got["bboxes"], want["bboxes"], atol=1e-7)


def test_augment_batch_with_everything_on_keeps_its_contract():
    """Every op on, mosaic included: shapes, ranges, and labels that agree
    with the id-map-derived boxes; the same generator seed repeats it."""
    img, idmap, cls, valid = _batch(9)
    hyp = taug.AugHyp(degrees=5.0, shear=2.0, flipud=0.3, mixup=0.5,
                      cutmix=0.5, copy_paste=0.5, resolution_p=0.5,
                      noise_p=0.9, blur_p=0.9, bias_p=0.9)
    outs = [taug.augment_batch(*_t(img, idmap, cls, valid),
                               torch.Generator().manual_seed(5), hyp,
                               g_out=G, mask_ratio=4) for _ in range(2)]
    a = outs[0]
    assert a["img"].shape == (B, S, S, C) and a["masks"].shape == (B, G, 8, 8)
    assert 0.0 <= a["img"].min() and a["img"].max() <= 1.0
    assert a["valid"].any()
    wh = a["bboxes"][..., 2:]
    assert bool(((wh > 0).all(-1) | ~a["valid"]).all())
    for k in a:
        assert torch.equal(a[k], outs[1][k]), k
