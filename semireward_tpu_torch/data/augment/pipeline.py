"""Batched on-device augmentation (port of
``semireward_tpu/data/augment/pipeline.py``).

- weak = reflect-pad random crop + horizontal flip
- strong = weak + RandAugment(n=3, continuous magnitudes) + Cutout(<= 0.5)
- eval = plain normalize

Each view is split into a *draw* (crop offsets, flips, op ids, magnitudes,
cutout corners; a few numbers per image from an explicit
``torch.Generator``) and a deterministic *apply* on the device, so tests can
hand both packages the same draws. RandAugment computes every op on the
whole batch and selects per image, as the JAX version does, so no step
reads the draws back to the host.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from semireward_tpu_torch import rng
from semireward_tpu_torch.data.augment import ops


class AugmentSpec(NamedTuple):
    crop_size: int
    crop_pad: int                  # int(crop_size * (1 - crop_ratio))
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]
    randaug_n: int = 3
    exclude_color: bool = False    # RandAugment no-color variant
    hflip: bool = True


# (op, min_val, max_val), the reference's augment_list() order
FULL_OPS = [
    (ops.autocontrast, 0.0, 1.0),
    (ops.brightness, 0.05, 0.95),
    (ops.color, 0.05, 0.95),
    (ops.contrast, 0.05, 0.95),
    (ops.equalize, 0.0, 1.0),
    (ops.identity, 0.0, 1.0),
    (ops.posterize, 4.0, 8.0),
    (ops.rotate, -30.0, 30.0),
    (ops.sharpness, 0.05, 0.95),
    (ops.shear_x, -0.3, 0.3),
    (ops.shear_y, -0.3, 0.3),
    (ops.solarize, 0.0, 256.0),
    (ops.translate_x, -0.3, 0.3),
    (ops.translate_y, -0.3, 0.3),
]
NO_COLOR_OPS = [
    (ops.brightness, 0.05, 0.95),
    (ops.equalize, 0.0, 1.0),
    (ops.identity, 0.0, 1.0),
    (ops.rotate, -30.0, 30.0),
    (ops.sharpness, 0.05, 0.95),
    (ops.shear_x, -0.3, 0.3),
    (ops.shear_y, -0.3, 0.3),
    (ops.translate_x, -0.3, 0.3),
    (ops.translate_y, -0.3, 0.3),
]
GEO_NAMES = ("rotate", "shear_x", "shear_y", "translate_x", "translate_y")


class CropDraws(NamedTuple):
    oy: torch.Tensor    # long [B], in [0, 2*pad]
    ox: torch.Tensor    # long [B]
    flip: torch.Tensor  # bool [B]


class RandAugDraws(NamedTuple):
    op_idx: torch.Tensor  # long [n, B], index into the op table
    u: torch.Tensor       # f32 [n, B], uniform [0, 1): magnitude position
    cut_v: torch.Tensor   # f32 [B], cutout size, uniform [0, W/2)
    cut_x: torch.Tensor   # f32 [B], uniform [0, W)
    cut_y: torch.Tensor   # f32 [B], uniform [0, H)


def _table(exclude_color: bool):
    return NO_COLOR_OPS if exclude_color else FULL_OPS


def draw_crop(batch: int, spec: AugmentSpec, generator, device) -> CropDraws:
    n = 2 * spec.crop_pad + 1
    oy = rng.randint(0, n, (batch,), generator=generator, device=device)
    ox = rng.randint(0, n, (batch,), generator=generator, device=device)
    flip = rng.rand(batch, generator=generator, device=device) < 0.5
    if not spec.hflip:
        flip = torch.zeros_like(flip)
    return CropDraws(oy, ox, flip)


def draw_randaug(batch: int, spec: AugmentSpec, generator,
                 device) -> RandAugDraws:
    n, k = spec.randaug_n, len(_table(spec.exclude_color))
    W = H = spec.crop_size
    rand = lambda *s: rng.rand(*s, generator=generator, device=device)
    return RandAugDraws(
        op_idx=rng.randint(0, k, (n, batch), generator=generator,
                           device=device),
        u=rand(n, batch), cut_v=rand(batch) * 0.5 * W, cut_x=rand(batch) * W,
        cut_y=rand(batch) * H)


def crop_flip(x, pad: int, d: CropDraws):
    """Reflect-pad (no edge repeat) random crop + hflip as one gather."""
    B, H, W, C = x.shape
    rows = torch.arange(H, device=x.device).expand(B, H)
    cols = torch.arange(W, device=x.device).expand(B, W)
    if pad > 0:
        rows = rows + d.oy[:, None] - pad
        cols = cols + d.ox[:, None] - pad
        rows = torch.where(rows < 0, -rows, rows)
        rows = torch.where(rows > H - 1, 2 * (H - 1) - rows, rows)
        cols = torch.where(cols < 0, -cols, cols)
        cols = torch.where(cols > W - 1, 2 * (W - 1) - cols, cols)
    cols = torch.where(d.flip[:, None], cols.flip(-1), cols)
    bi = torch.arange(B, device=x.device)[:, None, None]
    return x[bi, rows[:, :, None], cols[:, None, :]]


def randaugment_apply(x, d: RandAugDraws, exclude_color: bool = False):
    """``n`` rounds of one drawn op per image, then Cutout."""
    table = _table(exclude_color)
    names = [op.__name__ for op, _, _ in table]
    lo = ops.const([l for _, l, _ in table], x.device)
    hi = ops.const([h for _, _, h in table], x.device)
    H, W = x.shape[1], x.shape[2]
    geo_idx = [i for i, nm in enumerate(names) if nm in GEO_NAMES]
    sel4 = lambda m: m[:, None, None, None]
    for r in range(d.op_idx.shape[0]):
        idx, u = d.op_idx[r], d.u[r]
        v = lo[idx] + (hi[idx] - lo[idx]) * u
        out = x
        for i, (op, _l, _h) in enumerate(table):
            if names[i] not in GEO_NAMES:
                out = torch.where(sel4(idx == i), op(x, v), out)
        if geo_idx:
            one, zero = torch.ones_like(v), torch.zeros_like(v)
            coef = [one, zero, zero, zero, one, zero]
            for i in geo_idx:
                sel = idx == i
                coef = [torch.where(sel, c_new, c) for c_new, c in
                        zip(ops.affine_coeffs(names[i], v, H, W), coef)]
            is_geo = torch.zeros_like(idx, dtype=torch.bool)
            for i in geo_idx:
                is_geo = is_geo | (idx == i)
            out = torch.where(sel4(is_geo), ops.affine_nearest(x, *coef), out)
        x = out
    return ops.cutout_abs(x, d.cut_v, d.cut_x, d.cut_y)


def normalize(x, mean: Sequence[float], std: Sequence[float]):
    """ToTensor + Normalize: /255 then (x - mean) / std, NHWC float32."""
    m, s = ops.const(mean, x.device), ops.const(std, x.device)
    return (ops.div_exact(x.float(), 255.0) - m) / s


def weak_augment(batch, spec: AugmentSpec, d: CropDraws):
    """[B, H, W, C] uint8 -> normalized float32 weak view."""
    return normalize(crop_flip(batch.float(), spec.crop_pad, d), spec.mean,
                     spec.std)


def strong_augment(batch, spec: AugmentSpec, dc: CropDraws, dr: RandAugDraws):
    x = crop_flip(batch.float(), spec.crop_pad, dc)
    x = randaugment_apply(x, dr, spec.exclude_color)
    return normalize(x, spec.mean, spec.std)


def rot90_views(x):
    """``[B, H, W, C]`` -> the four rotations by 0, 90, 180 and 270 degrees,
    concatenated along the batch (``jnp.rot90(x, k, (1, 2))``)."""
    return torch.cat([torch.rot90(x, k, (1, 2)) for k in range(4)])


def rot90_per_sample(x, k):
    """Rotate image ``i`` of ``[B, H, W, C]`` by ``k[i] * 90`` degrees."""
    B = x.shape[0]
    rots = rot90_views(x).reshape(4, B, *x.shape[1:])
    return rots[k.long(), torch.arange(B, device=x.device)]


def augment_views(raw_lb, raw_ulb, spec: AugmentSpec, keys: Sequence[str],
                  generator: Optional[torch.Generator] = None,
                  weak_ulb_s: bool = False) -> Dict[str, torch.Tensor]:
    """The views an algorithm's BATCH_KEYS ask for, from raw uint8 batches on
    the device: x_lb / x_ulb_w weak, x_ulb_s strong (or a second weak view
    with ``weak_ulb_s``). ReMixMatch's ``x_ulb_s_0_rot`` is the x_ulb_s_0
    view rotated by a drawn ``rot_v * 90`` degrees a sample; CRMatch's
    ``x_ulb_rot`` is a fresh weak view in all four rotations, with ``rot_v``
    0..3 a block of B each."""
    weak_keys = ("x_lb", "x_ulb_w", "x_ulb_w_2")
    strong_keys = ("x_lb_s", "x_ulb_s", "x_ulb_s_0", "x_ulb_s_1")
    out = {}
    for key in keys:
        if key not in weak_keys + strong_keys:
            continue
        src = raw_lb if key in ("x_lb", "x_lb_s") else raw_ulb
        B, dev = src.shape[0], src.device
        dc = draw_crop(B, spec, generator, dev)
        if key in strong_keys and not (key == "x_ulb_s" and weak_ulb_s):
            out[key] = strong_augment(src, spec, dc,
                                      draw_randaug(B, spec, generator, dev))
        else:
            out[key] = weak_augment(src, spec, dc)
    B, dev = raw_ulb.shape[0], raw_ulb.device
    if "x_ulb_s_0_rot" in keys:
        rot_v = rng.randint(0, 4, (B,), generator=generator, device=dev)
        out["x_ulb_s_0_rot"] = rot90_per_sample(out["x_ulb_s_0"], rot_v)
        out["rot_v"] = rot_v
    if "x_ulb_rot" in keys:
        out["x_ulb_rot"] = rot90_views(weak_augment(
            raw_ulb, spec, draw_crop(B, spec, generator, dev)))
        out["rot_v"] = torch.arange(4, device=dev).repeat_interleave(B)
    return out
