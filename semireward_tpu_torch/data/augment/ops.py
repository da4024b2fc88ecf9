"""Batched on-device image ops emulating PIL (port of
``semireward_tpu/data/augment/ops.py``).

Every op takes float32 images in [0, 255] of shape [B, H, W, C] and a
per-image magnitude ``v`` [B], and rounds like PIL's uint8 quantization, so
that each output equals the JAX op's bit for bit. Geometric ops gather
pixels by index and the histogram of ``equalize`` is a scatter-add: the
direct GPU forms (the JAX package used one-hot contractions because gathers
are slow on the TPU).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

CUTOUT_COLOR = (125.0, 123.0, 114.0)


def const(values, device) -> torch.Tensor:
    """A small f32 constant tensor built on ``device`` by fills, so that no
    host-to-device copy (which would wait for the device) enters the step."""
    t = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        t[i] = v
    return t


def div_exact(x, d: float):
    """x / d correctly rounded. PyTorch turns division by a Python scalar
    into multiplication by its reciprocal, which can differ in the last bit
    from the JAX (and PIL) quotient; dividing by a one-element tensor does
    not."""
    return x / torch.full((1,), d, dtype=x.dtype, device=x.device)


def _b(v):
    return v.reshape(-1, 1, 1, 1)


def _round_clip(x):
    return torch.round(x).clamp(0.0, 255.0)


def _luminance(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return div_exact(299.0 * r + 587.0 * g + 114.0 * b, 1000.0)


def _blend(degenerate, img, v):
    return _round_clip(degenerate + (img - degenerate) * _b(v))


def autocontrast(img, _v):
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    scale = torch.full_like(hi, 255.0) / (hi - lo).clamp(min=1e-12)
    return _round_clip(torch.where(hi > lo, (img - lo) * scale, img))


def brightness(img, v):
    return _blend(torch.zeros_like(img), img, v)


def color(img, v):
    gray = torch.round(_luminance(img))[..., None]
    return _blend(gray.expand_as(img), img, v)


def contrast(img, v):
    lum = torch.round(_luminance(img))
    n = lum.shape[1] * lum.shape[2]
    mean = torch.floor(div_exact(lum.sum(dim=(1, 2)), float(n)) + 0.5)
    return _blend(_b(mean).expand_as(img), img, v)


def identity(img, _v):
    return img


def equalize(img, _v):
    """PIL ImageOps.equalize per channel: step = (npixels - hist[255]) // 255,
    lut[i] = (step // 2 + cumsum(hist)[:i]) // step; identity if step == 0.
    A value whose truncation lies outside [0, 255] (the bilinear
    RandomResizedCrop extrapolates at a box's top and left edges when it
    upsamples) falls in no bin and maps to 0, as in the JAX package's
    one-hot form."""
    B, H, W, C = img.shape
    chans = img.permute(0, 3, 1, 2).reshape(B * C, H * W)
    pix = chans.to(torch.long)
    valid = (pix >= 0) & (pix <= 255)
    pix = pix.clamp(0, 255)
    hist = torch.zeros(B * C, 256, dtype=torch.long, device=img.device)
    hist.scatter_add_(1, pix, valid.long())
    step = (hist.sum(1) - hist[:, 255]) // 255
    excl = torch.cumsum(hist, 1) - hist
    lut = ((step[:, None] // 2 + excl) // step.clamp(min=1)[:, None]).clamp(0, 255)
    out = (torch.gather(lut, 1, pix) * valid).to(img.dtype)
    out = torch.where(step[:, None] == 0, chans, out)
    return out.reshape(B, C, H, W).permute(0, 2, 3, 1).contiguous()


def posterize(img, v):
    bits = v.to(torch.int32).clamp(1, 8)
    shift = _b((8 - bits).to(torch.uint8))
    x = img.to(torch.uint8)
    return ((x >> shift) << shift).to(torch.float32)


def solarize(img, v):
    return torch.where(img < _b(v), img, 255.0 - img)


def sharpness(img, v):
    """Blend with the SMOOTH-filtered image; the 1-px border keeps the
    original pixels, as in PIL."""
    B, H, W, C = img.shape
    k = torch.ones(3, 3, device=img.device)
    k[1, 1] = 5.0
    k = div_exact(k, 13.0)
    x = img.permute(0, 3, 1, 2).reshape(B * C, 1, H, W)
    sm = F.conv2d(x, k.view(1, 1, 3, 3), padding=1)
    sm = torch.round(sm).reshape(B, C, H, W).permute(0, 2, 3, 1)
    interior = torch.zeros(H, W, 1, dtype=torch.bool, device=img.device)
    interior[1:H - 1, 1:W - 1] = True
    return _blend(torch.where(interior, sm, img), img, v)


def affine_nearest(img, a, b, c, d, e, f):
    """out(x, y) = img(a*x + b*y + c, d*x + e*y + f) per image (coefficients
    [B]), nearest neighbour, black fill, PIL's +0.5 pixel centres."""
    B, H, W, C = img.shape
    xo = torch.arange(W, dtype=torch.float32, device=img.device)[None, None, :] + 0.5
    yo = torch.arange(H, dtype=torch.float32, device=img.device)[None, :, None] + 0.5
    r = lambda t: t.reshape(-1, 1, 1)
    xn = torch.floor(r(a) * xo + r(b) * yo + r(c)).to(torch.long)
    yn = torch.floor(r(d) * xo + r(e) * yo + r(f)).to(torch.long)
    valid = (xn >= 0) & (xn < W) & (yn >= 0) & (yn < H)
    bi = torch.arange(B, device=img.device).reshape(-1, 1, 1)
    out = img[bi, yn.clamp(0, H - 1), xn.clamp(0, W - 1)]
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def affine_coeffs(name: str, v, H: int, W: int):
    """Output->input affine coefficients (a, b, c, d, e, f) of a geometric op."""
    zero, one = torch.zeros_like(v), torch.ones_like(v)
    if name == "rotate":
        theta = div_exact(-v * math.pi, 180.0)
        cx, cy = W / 2.0, H / 2.0
        cos, sin = torch.cos(theta), torch.sin(theta)
        return (cos, sin, cx - cos * cx - sin * cy,
                -sin, cos, cy + sin * cx - cos * cy)
    if name == "shear_x":
        return (one, v, zero, zero, one, zero)
    if name == "shear_y":
        return (one, zero, zero, v, one, zero)
    if name == "translate_x":
        return (one, zero, v * W, zero, one, zero)
    if name == "translate_y":
        return (one, zero, zero, zero, one, v * H)
    raise KeyError(name)


def _geometric(name):
    def op(img, v):
        return affine_nearest(img, *affine_coeffs(name, v, img.shape[1],
                                                  img.shape[2]))
    op.__name__ = name
    return op


rotate = _geometric("rotate")
shear_x = _geometric("shear_x")
shear_y = _geometric("shear_y")
translate_x = _geometric("translate_x")
translate_y = _geometric("translate_y")


def cutout_abs(img, v, x0, y0):
    """Fill a v x v square at drawn corner (x0, y0) (uniform in [0, W) and
    [0, H), shifted by -v/2 and clamped) with the reference's gray; PIL's
    rectangle covers both corners."""
    B, H, W, C = img.shape
    x0 = torch.floor(torch.clamp(x0 - v / 2.0, min=0.0))
    y0 = torch.floor(torch.clamp(y0 - v / 2.0, min=0.0))
    x1 = torch.clamp(x0 + v, max=W * 1.0)
    y1 = torch.clamp(y0 + v, max=H * 1.0)
    xs = torch.arange(W, dtype=torch.float32, device=img.device)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=img.device)[None, :, None]
    r = lambda t: t.reshape(-1, 1, 1)
    inside = (xs >= r(x0)) & (xs <= r(x1)) & (ys >= r(y0)) & (ys <= r(y1))
    return torch.where(inside[..., None], const(CUTOUT_COLOR, img.device), img)
