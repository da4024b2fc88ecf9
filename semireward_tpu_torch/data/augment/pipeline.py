"""Batched on-device augmentation (port of
``semireward_tpu/data/augment/pipeline.py``).

- weak = reflect-pad random crop + horizontal flip
- strong = weak + RandAugment(n=3, continuous magnitudes) + Cutout(<= 0.5)
- eval = plain normalize

A full-size JPEG set decodes at ``src_size = floor(img_size / crop_ratio)``
(``AugmentSpec.src_size``), and its views follow the reference's ImageNet
transforms: weak = a random ``crop_size`` crop of the larger decode + flip,
strong = RandomResizedCrop (area 8-100%, aspect 3/4-4/3, bilinear) + flip +
RandAugment; eval center-crops (the trainer). Both crops are gathers: the
one-hot product that the JAX package used on the TPU for the crop is a TPU
measurement and is not carried over.

Each view is split into a *draw* (crop offsets, flips, op ids, magnitudes,
cutout corners; a few numbers per image from an explicit
``torch.Generator``) and a deterministic *apply* on the device, so tests can
hand both packages the same draws. RandAugment computes every op on the
whole batch and selects per image, as the JAX version does, so no step
reads the draws back to the host.
"""
from __future__ import annotations

import math
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
    # full-size JPEG sets: the decode's size, floor(img_size / crop_ratio);
    # 0 = decoded at crop_size (the reflect-pad path)
    src_size: int = 0

    @property
    def full_size(self) -> bool:
        return self.src_size > self.crop_size


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
    oy: torch.Tensor    # long [B], in [0, 2*pad] (full size: [0, src-crop])
    ox: torch.Tensor    # long [B]
    flip: torch.Tensor  # bool [B]


class ResizedCropDraws(NamedTuple):
    area: torch.Tensor       # f32 [B], box area / image area, [0.08, 1)
    log_ratio: torch.Tensor  # f32 [B], log aspect, [log 3/4, log 4/3)
    ux: torch.Tensor         # f32 [B], uniform [0, 1): the box's left edge
    uy: torch.Tensor         # f32 [B], uniform [0, 1): its top edge
    flip: torch.Tensor       # bool [B]


class RandAugDraws(NamedTuple):
    op_idx: torch.Tensor  # long [n, B], index into the op table
    u: torch.Tensor       # f32 [n, B], uniform [0, 1): magnitude position
    cut_v: torch.Tensor   # f32 [B], cutout size, uniform [0, W/2)
    cut_x: torch.Tensor   # f32 [B], uniform [0, W)
    cut_y: torch.Tensor   # f32 [B], uniform [0, H)


def _table(exclude_color: bool):
    return NO_COLOR_OPS if exclude_color else FULL_OPS


def _draw_flip(batch: int, spec: AugmentSpec, generator, device):
    flip = rng.rand(batch, generator=generator, device=device, rows=0) < 0.5
    return flip if spec.hflip else torch.zeros_like(flip)


def draw_crop(batch: int, spec: AugmentSpec, generator, device) -> CropDraws:
    n = (spec.src_size - spec.crop_size + 1 if spec.full_size
         else 2 * spec.crop_pad + 1)
    oy = rng.randint(0, n, (batch,), generator=generator, device=device,
                     rows=0)
    ox = rng.randint(0, n, (batch,), generator=generator, device=device,
                     rows=0)
    return CropDraws(oy, ox, _draw_flip(batch, spec, generator, device))


def draw_resized_crop(batch: int, spec: AugmentSpec, generator,
                      device) -> ResizedCropDraws:
    """RandomResizedCrop's draws: area 8-100% of the image, aspect ratio
    3/4-4/3 (uniform in its log), the box's place, the flip."""
    rand = lambda: rng.rand(batch, generator=generator, device=device,
                            rows=0)
    lo, hi = math.log(3 / 4), math.log(4 / 3)
    return ResizedCropDraws(
        area=0.08 + 0.92 * rand(), log_ratio=lo + (hi - lo) * rand(),
        ux=rand(), uy=rand(), flip=_draw_flip(batch, spec, generator, device))


def draw_randaug(batch: int, spec: AugmentSpec, generator,
                 device) -> RandAugDraws:
    n, k = spec.randaug_n, len(_table(spec.exclude_color))
    W = H = spec.crop_size
    # the batch is dim 0, or dim 1 of the per-op draws
    rand = lambda *s: rng.rand(*s, generator=generator, device=device,
                               rows=len(s) - 1)
    return RandAugDraws(
        op_idx=rng.randint(0, k, (n, batch), generator=generator,
                           device=device, rows=1),
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


def crop_from_larger(x, out_size: int, d: CropDraws):
    """A random ``out_size`` crop of a larger image + hflip as one gather
    (the reference's Resize(img / crop_ratio) -> RandomCrop(img) -> flip):
    offsets in [0, src - out], no padding."""
    B = x.shape[0]
    ar = torch.arange(out_size, device=x.device)
    rows = ar + d.oy[:, None]
    cols = ar + d.ox[:, None]
    cols = torch.where(d.flip[:, None], cols.flip(-1), cols)
    bi = torch.arange(B, device=x.device)[:, None, None]
    return x[bi, rows[:, :, None], cols[:, None, :]]


def resized_crop_boxes(H: int, W: int, d: ResizedCropDraws):
    """-> (x0, y0, w, h), int32 [B] each: the box of each image, in the JAX
    package's float32 arithmetic (int32 truncation, sides clipped to [1,
    W] / [1, H])."""
    area = d.area.float() * float(H * W)
    ar = torch.exp(d.log_ratio.float())
    w = torch.sqrt(area * ar).to(torch.int32).clamp(1, W)
    h = torch.sqrt(area / ar).to(torch.int32).clamp(1, H)
    x0 = (d.ux.float() * (W - w + 1).float()).to(torch.int32)
    y0 = (d.uy.float() * (H - h + 1).float()).to(torch.int32)
    return x0, y0, w, h


def random_resized_crop(x, out_size: int, d: ResizedCropDraws):
    """RandomResizedCropAndInterpolation (the reference's timm-derived
    transform): each image's box (``resized_crop_boxes``) bilinearly
    sampled onto an ``out_size`` grid, in float32, then the flip. ``x``:
    float [B, H, W, C]. As in the JAX package, a sample point above or left
    of pixel 0 (a box smaller than the grid at the top or left edge) keeps
    its negative weight: those rows and columns extrapolate past [0,
    255]."""
    B, H, W, C = x.shape
    x0, y0, w, h = resized_crop_boxes(H, W, d)
    step = (torch.arange(out_size, device=x.device) + 0.5)[None]

    def axis(start, side, size):
        pos = start[:, None] + step * (side.float() / out_size)[:, None] - 0.5
        lo = torch.floor(pos).to(torch.int64).clamp(0, size - 1)
        return lo, (lo + 1).clamp(0, size - 1), pos - lo

    y0i, y1i, fy = axis(y0, h, H)
    x0i, x1i, fx = axis(x0, w, W)
    fy, fx = fy[:, :, None, None], fx[:, None, :, None]
    bi = torch.arange(B, device=x.device)[:, None, None]

    def at(r, c):
        return x[bi, r[:, :, None], c[:, None, :]]

    out = (at(y0i, x0i) * (1 - fy) * (1 - fx) + at(y0i, x1i) * (1 - fy) * fx
           + at(y1i, x0i) * fy * (1 - fx) + at(y1i, x1i) * fy * fx)
    return torch.where(d.flip[:, None, None, None], out.flip(2), out)


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
    x = (crop_from_larger(batch.float(), spec.crop_size, d)
         if spec.full_size else crop_flip(batch.float(), spec.crop_pad, d))
    return normalize(x, spec.mean, spec.std)


def draw_strong_crop(batch: int, spec: AugmentSpec, generator, device):
    """The strong view's crop draws: a resized crop on a full-size set."""
    return (draw_resized_crop if spec.full_size else draw_crop)(
        batch, spec, generator, device)


def strong_augment(batch, spec: AugmentSpec, dc, dr: RandAugDraws):
    """Crop (``ResizedCropDraws`` on a full-size set, else ``CropDraws``),
    RandAugment, Cutout, normalize."""
    x = (random_resized_crop(batch.float(), spec.crop_size, dc)
         if spec.full_size else crop_flip(batch.float(), spec.crop_pad, dc))
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
        if key in strong_keys and not (key == "x_ulb_s" and weak_ulb_s):
            out[key] = strong_augment(
                src, spec, draw_strong_crop(B, spec, generator, dev),
                draw_randaug(B, spec, generator, dev))
        else:
            out[key] = weak_augment(src, spec,
                                    draw_crop(B, spec, generator, dev))
    B, dev = raw_ulb.shape[0], raw_ulb.device
    if "x_ulb_s_0_rot" in keys:
        rot_v = rng.randint(0, 4, (B,), generator=generator, device=dev,
                            rows=0)
        out["x_ulb_s_0_rot"] = rot90_per_sample(out["x_ulb_s_0"], rot_v)
        out["rot_v"] = rot_v
    if "x_ulb_rot" in keys:
        out["x_ulb_rot"] = rot90_views(weak_augment(
            raw_ulb, spec, draw_crop(B, spec, generator, dev)))
        out["rot_v"] = torch.arange(4, device=dev).repeat_interleave(B)
    return out
