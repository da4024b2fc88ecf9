"""Fused transformer MLP: ``gelu(x @ W1^T + b1) @ W2^T + b2``.

Port of ``semireward_tpu/ops/fused_mlp.py`` (the full-resident pair
``_fwd_kernel``/``_bwd_kernel``). On a CUDA tensor the forward and backward
run the hand-written Hopper kernels in ``csrc/fused_mlp.cu``, which keep the
``[rows, hidden]`` activation out of device memory. On a CPU tensor they run
the plain PyTorch version below, which does the same arithmetic: bf16 (or
the activation dtype) products with f32 accumulation, bias adds and GELU in
f32, the hidden rounded to the activation dtype before the second product,
``dh`` rounded before ``dx``/``dW1``, f32 bias grads and weight grads in the
weights' dtype. GELU is the exact erf form in both; the TPU kernel used an
erf approximation only because Mosaic had no ``erf`` (max error 1.5e-7).

Weights use ``torch.nn.Linear``'s layout: ``w1 [H, C]``, ``w2 [C, H]``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from semireward_tpu_torch.ops import _build

# launches of each kernel wrapper (the backward counts once per call of its
# three-kernel sequence)
launches = {"fused_mlp_fwd": 0, "fused_mlp_bwd": 0}

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _gelu(u):
    return 0.5 * u * (1.0 + torch.erf(u * _INV_SQRT2))


def _dgelu(u):
    cdf = 0.5 * (1.0 + torch.erf(u * _INV_SQRT2))
    return cdf + u * (_INV_SQRT_2PI * torch.exp(-0.5 * u * u))


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------

def plain_fwd(x, w1, b1, w2, b2):
    """x [M, C], w1 [H, C], b1 [H] f32, w2 [C, H], b2 [C] f32 -> [M, C]."""
    u = x.float() @ w1.float().t() + b1
    h = _gelu(u).to(x.dtype)
    return (h.float() @ w2.float().t() + b2).to(x.dtype)


def plain_bwd(x, w1, b1, w2, g):
    """-> (dx, dw1, dw2, db1, db2) for upstream grad ``g`` [M, C]."""
    xf, gf = x.float(), g.to(x.dtype).float()
    u = xf @ w1.float().t() + b1
    h = _gelu(u).to(x.dtype).float()
    dh = (gf @ w2.float()) * _dgelu(u)
    dh_lp = dh.to(x.dtype).float()
    dx = (dh_lp @ w1.float()).to(x.dtype)
    dw1 = (dh_lp.t() @ xf).to(w1.dtype)
    dw2 = (gf.t() @ h).to(w2.dtype)
    return dx, dw1, dw2, dh.sum(0), gf.sum(0)


# ---------------------------------------------------------------------------
# the Hopper kernels
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("fused_mlp")
    if not getattr(lib, "_srt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.srt_fused_mlp_supported.argtypes = [i, i]
        lib.srt_fused_mlp_supported.restype = i
        lib.srt_fused_mlp_fwd.argtypes = [p, p, p, p, p, p, i, i, i, p]
        lib.srt_fused_mlp_fwd.restype = i
        lib.srt_fused_mlp_bwd.argtypes = [p] * 11 + [i, i, i, i, p]
        lib.srt_fused_mlp_bwd.restype = i
        lib._srt_typed = True
    return lib


def require_supported(c: int, h: int, device) -> None:
    """On a CUDA ``device``, raise ``NotImplementedError`` when the Hopper
    kernels (built for the widths that ``srt_fused_mlp_supported`` names)
    do not take an MLP of width ``c`` and hidden ``h``: the hidden-blocked
    kernel for wider MLPs (K3) is not ported yet. The CPU runs the plain
    version at any width."""
    if torch.device(device).type != "cuda":
        return
    if not _lib().srt_fused_mlp_supported(c, h):
        raise NotImplementedError(
            f"fused MLP at C={c}, H={h}: the full-resident kernel (K1) does "
            f"not take this width and the hidden-blocked one (K3) is not "
            f"ported yet (ROADMAP: K3). Set use_fused_mlp False to run the "
            f"MLP as two dense layers.")


def _check(name, t, shape, dtype):
    if not t.is_cuda:
        raise ValueError(f"fused_mlp: {name} is on {t.device}, expected CUDA")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_mlp: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"fused_mlp: {name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_mlp: {name} must be contiguous and "
                         f"16-byte aligned")


def _check_args(x, w1, b1, w2):
    m, c = x.shape
    h = w1.shape[0]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_mlp: the CUDA kernel takes bfloat16 "
                         f"activations, got {x.dtype}")
    _check("x", x, (m, c), torch.bfloat16)
    require_supported(c, h, x.device)
    _check("w1", w1, (h, c), torch.bfloat16)
    _check("b1", b1, (h,), torch.float32)
    _check("w2", w2, (c, h), torch.bfloat16)
    return m, c, h


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_if(err, what):
    if err != 0:
        raise RuntimeError(f"fused_mlp: {what} launch failed with CUDA "
                           f"error {err}")


def kernel_fwd(x, w1, b1, w2, b2):
    m, c, h = _check_args(x, w1, b1, w2)
    _check("b2", b2, (c,), torch.float32)
    out = torch.empty_like(x)
    err = _lib().srt_fused_mlp_fwd(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                   w2.data_ptr(), b2.data_ptr(),
                                   out.data_ptr(), m, c, h, _stream(x))
    _raise_if(err, "forward")
    launches["fused_mlp_fwd"] += 1
    return out


def bwd_splits(m: int, h: int, device) -> int:
    """Row splits of the dW kernel: as many (hidden chunk, split) CTAs as fit
    one wave on the card's SMs, at least one."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(math.ceil(m / 64), sms // (h // 32)))


def kernel_bwd(x, w1, b1, w2, g):
    m, c, h = _check_args(x, w1, b1, w2)
    _check("g", g, (m, c), torch.bfloat16)
    splits = bwd_splits(m, h, x.device)
    dx = torch.empty_like(x)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    db1 = torch.empty(h, device=x.device, dtype=torch.float32)
    db2 = torch.empty(c, device=x.device, dtype=torch.float32)
    ws = torch.empty(splits * (2 * c * h + h + c), device=x.device,
                     dtype=torch.float32)
    err = _lib().srt_fused_mlp_bwd(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        g.data_ptr(), dx.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
        db1.data_ptr(), db2.data_ptr(), ws.data_ptr(), m, c, h, splits,
        _stream(x))
    _raise_if(err, "backward")
    launches["fused_mlp_bwd"] += 1
    return dx, dw1, dw2, db1, db2


def _fwd(x, w1, b1, w2, b2):
    if x.device.type == "cpu":
        return plain_fwd(x, w1, b1, w2, b2)
    return kernel_fwd(x, w1, b1, w2, b2)


def _bwd(x, w1, b1, w2, g):
    if x.device.type == "cpu":
        return plain_bwd(x, w1, b1, w2, g)
    return kernel_bwd(x, w1, b1, w2, g.contiguous())


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)
        return _fwd(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, dw2, db1, db2 = _bwd(x, w1, b1, w2, g.to(x.dtype))
        return dx, dw1, db1, dw2, db2


def fused_mlp(x, w1, b1, w2, b2):
    """``x`` [..., C] in the activation dtype; ``w1`` [H, C], ``w2`` [C, H]
    cast to it (as a Linear with a compute dtype does); biases in f32.
    CPU tensors take the plain version, CUDA tensors the kernels (or an
    error when the kernels do not take the shape or dtype)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mlp: no path for device {x.device}")
    lead, c = x.shape[:-1], x.shape[-1]
    dt = x.dtype
    out = _FusedMLP.apply(x.reshape(-1, c).contiguous(), w1.to(dt).contiguous(),
                          b1.float().contiguous(), w2.to(dt).contiguous(),
                          b2.float().contiguous())
    return out.reshape(*lead, -1)
