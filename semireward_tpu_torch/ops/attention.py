"""Flash attention with a key-padding bias and counter-hash dropout.

Port of ``semireward_tpu/ops/attention.py``. :func:`flash_attention` takes
``q, k, v`` as ``[B, N, H, d]``, an optional KEY-ONLY additive bias
(``[B, 1, 1, N]``, ``[1, 1, 1, N]`` or ``[B, H, 1, N]``: the BERT padding
mask) and dropout on the attention probabilities, and returns
``[B, N, H, d]``. The bias and the seed get no gradient.

On a CUDA tensor the forward and the backward run the hand-written Hopper
kernels of ``csrc/flash_attention.cu`` (forward; dq; dk/dv; wgmma with TMA
loads, bf16, head dim 64, that of every net of the port), which keep the
``[B, H, N, N]`` scores out of device memory. The forward hashes the dropout
mask; under autograd it also writes the keep bits it drew
(:func:`pack_keep_bits`'s layout), which the backward kernels read instead of
hashing again, and the dq kernel computes ``delta = rowsum(dO * O)`` itself.
On a CPU tensor they run the plain PyTorch version
below, which does the JAX kernels' arithmetic: f32 products, ``q * scale``
before ``q k^T`` in the forward and ``* scale`` after it in the backward, the
row max / sum / ``lse = m + log(l)`` of the online softmax, ``delta =
rowsum(dO * O)``, dropout applied to ``p / keep`` in ``PV`` and ``dV`` and to
``dp``. The kernels round ``P``, ``dS`` and ``P^T`` to bf16 before their
tensor-core products (the JAX kernels keep them in f32): one bf16 rounding,
held to 1% of ``max|plain|``.

The dropout stream is the JAX package's, bit for bit
(:func:`attention_keep_mask`): ``keep = lowbias32(lowbias32(ctr) ^ seed) <
thresh`` with ``ctr = (bh * Np + q) * Np + k`` in wrapping uint32 arithmetic
and ``Np`` = N rounded up to 128. The port pads nothing, so the kernels mask
a ragged tail themselves and take any N; ``Np`` stays because it is part of
the stream. The seed is JAX's ``seed_arg``: four int32 values ``(seed,
bh_offset, local_heads, head_stride)`` on the device, which the forward
kernel reads; its ``bh`` is ``bh_offset + (L // local_heads) * head_stride
+ L % local_heads`` for its own batch*head index ``L`` (an unsharded call
passes ``(seed, 0, H, H)``: ``bh = L``). A counter past ``2**32`` (``B * H
* Np**2``) wraps in the kernels as in :func:`attention_keep_mask`, so the
stream stays the JAX one there too.

A bias that is not key-only is refused (the JAX package sends it to an
einsum path; no net of the port passes one).

K4's attention form, :func:`flash_attention_sharded` (``flash_fn(mesh)``),
takes a rank's own rows and heads (batch over the batch axes, heads over
``model``; no collective) and gives the kernel the shard's global
batch*head start, so the dropout stream is the one of a single call on the
whole batch.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from semireward_tpu_torch.ops import _build

# launches of each kernel wrapper (the backward counts once per call of its
# dq + dk/dv pair)
launches = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}

_BQ = 128          # the JAX kernel's tile: the counter's Np rounds N up to it
_U32 = 0xFFFFFFFF


# forward launches that K4's form made (each also counts in ``launches``),
# on a mesh without and with a ``model`` axis
launches_k4 = {"flash_attention_sharded": 0,
               "flash_attention_sharded_heads": 0}


def reset_launches() -> None:
    for d in (launches, launches_k4):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# counter-based dropout hash (uint32 arithmetic on int64 tensors)
# ---------------------------------------------------------------------------

def _mul32(x, c: int):
    """(x * c) mod 2**32 for x < 2**32, without leaving int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _U32


def _lowbias32(x):
    """lowbias32 integer hash (uint32 -> uint32) on int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _keep_bits(counter, seed_u32):
    return _lowbias32(_lowbias32(counter) ^ seed_u32)


def keep_threshold(dropout_rate: float) -> int:
    """uint32 comparison threshold for keep_prob = 1 - dropout_rate."""
    return int(round((1.0 - float(dropout_rate)) * 2.0 ** 32))


def padded_len(n: int) -> int:
    """The JAX kernel's padded sequence length (N rounded up to 128)."""
    return ((n + _BQ - 1) // _BQ) * _BQ


def attention_keep_mask(seed, BH: int, N: int, np_pad: int, thresh: int,
                        bh_offset=0, local_heads=None, head_stride=None,
                        device=None):
    """Keep mask ``[BH, N, N]`` (bool) of the kernels' stream. ``seed`` is an
    int or an int32 tensor (its device is used unless ``device`` is given);
    ``bh_offset`` offsets the batch*head index; ``local_heads`` /
    ``head_stride`` decompose a head-sharded shard's local index L into
    ``bh_offset + (L // local_heads) * head_stride + L % local_heads``."""
    if device is None:
        device = seed.device if isinstance(seed, torch.Tensor) else "cpu"
    i64 = dict(dtype=torch.int64, device=device)
    seed_u = torch.as_tensor(seed).to(**i64).reshape(()) & _U32
    off = torch.as_tensor(bh_offset).to(**i64).reshape(()) & _U32
    L = torch.arange(BH, **i64)
    if local_heads is not None:
        st = head_stride if head_stride is not None else local_heads
        L = (L // local_heads) * st + L % local_heads
    bh = ((L + off) & _U32)[:, None, None]
    qpos = torch.arange(N, **i64)[None, :, None]
    kpos = torch.arange(N, **i64)[None, None, :]
    counter = ((((bh * np_pad + qpos) & _U32) * np_pad) + kpos) & _U32
    return _keep_bits(counter, seed_u) < thresh


def pack_keep_bits(keep):
    """The keep mask ``[BH, N, N]`` (bool) in the layout the kernels write
    and read: int32 words ``[BH, N, Np // 32]`` (``Np = padded_len(N)``), bit
    ``k % 32`` of word ``k // 32`` of row ``q`` is ``keep[bh, q, k]``, and the
    bits of keys ``>= N`` are 0. A row spans ``Np`` keys so that every key
    tile of a kernel (64 or 128 keys) lies inside it."""
    BH, N, _ = keep.shape
    np_pad = padded_len(N)
    padded = torch.zeros(BH, N, np_pad, dtype=torch.int64, device=keep.device)
    padded[..., :N] = keep
    shifts = torch.arange(32, dtype=torch.int64, device=keep.device)
    words = (padded.view(BH, N, np_pad // 32, 32) << shifts).sum(-1)
    return torch.where(words > 0x7FFFFFFF, words - (1 << 32),
                       words).to(torch.int32)


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------

def _dropout_of(seed, rate, B, H, N, device):
    """(keep mask [B, H, N, N] or None, f32 1/keep) for ``rate``; ``seed``
    is the kernels' four int32 values (:func:`seed_arg`)."""
    if not rate:
        return None, None
    seed = _seed4(seed, H)
    keep = attention_keep_mask(seed[0], B * H, N, padded_len(N),
                               keep_threshold(rate), bh_offset=seed[1],
                               local_heads=int(seed[2]),
                               head_stride=int(seed[3]), device=device)
    inv = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=device)
    return keep.view(B, H, N, N), inv


def plain_fwd(q, k, v, bias=None, seed=None, rate: float = 0.0):
    """``q, k, v [B, N, H, d]``, ``bias [B*H, N]`` f32 or None -> (out in
    q's dtype ``[B, N, H, d]``, lse ``[B*H, N]`` f32)."""
    B, N, H, d = q.shape
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float() * scale, k.float())
    if bias is not None:
        s = s + bias.view(B, H, 1, N)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    keep, inv = _dropout_of(seed, rate, B, H, N, q.device)
    if keep is not None:
        e = torch.where(keep, e * inv, torch.zeros_like(e))
    acc = torch.matmul(e, v.float().permute(0, 2, 1, 3))       # [B, H, N, d]
    out = (acc / l).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    return out, (m + torch.log(l)).reshape(B * H, N)


def plain_bwd(q, k, v, bias, seed, rate, dout, lse, delta):
    """-> (dq, dk, dv) in q's dtype, recomputing p from ``lse``;
    ``delta = rowsum(dout * out)`` ``[B*H, N]`` f32."""
    B, N, H, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
    if bias is not None:
        s = s + bias.view(B, H, 1, N)
    p = torch.exp(s - lse.view(B, H, N, 1))
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    pv = p
    keep, inv = _dropout_of(seed, rate, B, H, N, q.device)
    if keep is not None:
        zero = torch.zeros_like(p)
        dp = torch.where(keep, dp * inv, zero)
        pv = torch.where(keep, p * inv, zero)
    ds = p * (dp - delta.view(B, H, N, 1))
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf) * scale
    dv = torch.einsum("bhnm,bnhd->bmhd", pv, dof)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def delta_of(dout, out):
    """rowsum(dO * O) in f32, ``[B*H, N]`` (a torch reduction, as JAX
    computes it outside its kernels; on the card the dq kernel computes
    it)."""
    B, N, H, _ = out.shape
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(
        B * H, N).contiguous()


# ---------------------------------------------------------------------------
# the Hopper kernels
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_srt_typed", False):
        p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                      ctypes.c_float)
        tail = [i, i, i, i, i, f, u, f]
        lib.srt_flash_fwd.argtypes = [p] * 8 + tail + [p]
        lib.srt_flash_fwd.restype = i
        lib.srt_flash_bwd.argtypes = [p] * 13 + tail + [p]
        lib.srt_flash_bwd.restype = i
        lib.srt_flash_head_dim.restype = i
        lib._srt_head_dim = lib.srt_flash_head_dim()
        lib._srt_typed = True
    return lib


def _check(name, t, shape, dtype):
    if not t.is_cuda:
        raise ValueError(f"flash_attention: {name} is on {t.device}, "
                         f"expected CUDA")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash_attention: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"flash_attention: {name} is {t.dtype}, expected "
                         f"{dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must be contiguous and "
                         f"16-byte aligned")


def _seed4(seed, H: int):
    """The kernels' four seed values: ``seed`` itself, or a single seed as
    an unsharded call's ``(seed, 0, H, H)``."""
    if seed is None or seed.numel() == 4:
        return seed
    return seed_arg(seed, seed.device, H)


def _check_args(q, k, v, bias, seed):
    """-> (library, B, N, H, d) after checking what every kernel takes."""
    B, N, H, d = q.shape
    if not q.is_cuda:
        raise ValueError(f"flash_attention: q is on {q.device}, expected CUDA")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: the CUDA kernels take bfloat16, "
                         f"got {q.dtype}")
    lib = _lib()
    if d != lib._srt_head_dim:
        raise ValueError(f"flash_attention: the CUDA kernels take head dim "
                         f"{lib._srt_head_dim}, got d={d}")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B*H = {B * H} exceeds the grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, (B, N, H, d), torch.bfloat16)
    if bias is not None:
        _check("bias", bias, (B * H, N), torch.float32)
    if seed is not None:
        _check("seed", seed, (4,), torch.int32)
    return lib, B, N, H, d


def _ptr(t):
    return t.data_ptr() if t is not None else None


@functools.lru_cache(maxsize=64)
def _shape_args(B, N, H, d, rate):
    thresh = keep_threshold(rate) if rate else 0
    inv = 1.0 / (1.0 - rate) if rate else 1.0
    return (B, N, H, d, padded_len(N), 1.0 / math.sqrt(d), thresh, inv)


def _stream(t):
    """The raw handle of the current stream on ``t``'s device: the query
    PyTorch's own compiled code launches with. ``torch.cuda.current_stream``
    builds a Stream object a call, host time that the host-bound steps
    running these kernels pay."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _raise_if(err, what):
    if err != 0:
        why = {-1: "arguments the kernels do not take",
               -2: "cuTensorMapEncodeTiled missing or refused"}.get(
                   err, f"CUDA error {err}")
        raise RuntimeError(f"flash_attention: {what} launch failed: {why}")


def kernel_fwd(q, k, v, bias=None, seed=None, rate: float = 0.0,
               keep_bits: bool = False):
    """The forward kernel: -> (out [B, N, H, d] bf16, lse [B*H, N] f32,
    bits). With dropout and ``keep_bits`` the kernel also writes the keep
    bits it drew (``[B*H, N, Np // 32]`` int32, :func:`pack_keep_bits`'s
    layout) for the backward; else ``bits`` is None."""
    seed = _seed4(seed, q.shape[2])
    lib, B, N, H, d = _check_args(q, k, v, bias, seed)
    dev = q.device
    out = torch.empty_like(q)
    lse = torch.empty(B * H, N, device=dev, dtype=torch.float32)
    bits = (torch.empty(B * H, N, padded_len(N) // 32, device=dev,
                        dtype=torch.int32) if rate and keep_bits else None)
    err = lib.srt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            _ptr(bias), _ptr(seed) if rate else None,
                            out.data_ptr(), lse.data_ptr(), _ptr(bits),
                            *_shape_args(B, N, H, d, rate), _stream(q))
    _raise_if(err, "forward")
    launches["flash_attention_fwd"] += 1
    return out, lse, bits


def kernel_bwd(q, k, v, bias, seed, rate, dout, lse, out, bits):
    """The dq and dk/dv kernels: -> (dq, dk, dv) bf16. ``out`` is the
    forward's output (the dq kernel computes ``delta = rowsum(dout * out)``
    from it); under dropout ``bits`` are the forward's keep bits."""
    seed = _seed4(seed, q.shape[2])
    lib, B, N, H, d = _check_args(q, k, v, bias, seed)
    _check("dout", dout, (B, N, H, d), torch.bfloat16)
    _check("lse", lse, (B * H, N), torch.float32)
    _check("out", out, (B, N, H, d), torch.bfloat16)
    if rate:
        if bits is None:
            raise ValueError("flash_attention: the backward under dropout "
                             "reads the forward's keep bits; got none")
        _check("bits", bits, (B * H, N, padded_len(N) // 32), torch.int32)
    grads = torch.empty((3,) + tuple(q.shape), device=q.device,
                        dtype=q.dtype)
    delta = torch.empty(B * H, N, device=q.device, dtype=torch.float32)
    dq, dk, dv = grads.unbind(0)
    err = lib.srt_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            _ptr(bias), _ptr(seed) if rate else None,
                            dout.data_ptr(), lse.data_ptr(), out.data_ptr(),
                            _ptr(bits) if rate else None, delta.data_ptr(),
                            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                            *_shape_args(B, N, H, d, rate), _stream(q))
    _raise_if(err, "backward")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate, keep_bits):
        ctx.plain = q.device.type == "cpu"
        if ctx.plain:
            (out, lse), bits = plain_fwd(q, k, v, bias, seed, rate), None
        else:
            out, lse, bits = kernel_fwd(q, k, v, bias, seed, rate, keep_bits)
        ctx.save_for_backward(q, k, v, bias, seed, out, lse, bits)
        ctx.rate = rate
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, seed, out, lse, bits = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        if ctx.plain:
            dq, dk, dv = plain_bwd(q, k, v, bias, seed, ctx.rate, dout, lse,
                                   delta_of(dout, out))
        else:
            dq, dk, dv = kernel_bwd(q, k, v, bias, seed, ctx.rate, dout, lse,
                                    out, bits)
        return dq, dk, dv, None, None, None, None


# ---------------------------------------------------------------------------
# the public function
# ---------------------------------------------------------------------------

def _key_bias_of(bias, B, H, N):
    """``[B*H, N]`` f32 key-only bias (``bias`` a ``[B,1,1,N]`` /
    ``[1,1,1,N]`` / ``[B,H,1,N]`` broadcast); raises for any other shape."""
    shape = tuple(bias.shape)
    if (len(shape) != 4 or shape[2] != 1 or shape[3] != N
            or shape[0] not in (1, B) or shape[1] not in (1, H)):
        raise ValueError(f"flash_attention: the bias must be key-only "
                         f"([B|1, H|1, 1, N] with N={N}), got {shape}")
    return bias.float().expand(B, H, 1, N).reshape(B * H, N).contiguous()


@functools.lru_cache(maxsize=256)
def _seed_tail(device: torch.device, bh_offset: int, local_heads: int,
               head_stride: int) -> torch.Tensor:
    """``[bh_offset, local_heads, head_stride]`` int32 on ``device``, made
    once (no copy to the card a call)."""
    return torch.tensor([bh_offset, local_heads, head_stride],
                        dtype=torch.int32, device=device)


def seed_arg(seed, device, H: int, bh_offset: int = 0, local_heads=None,
             head_stride=None):
    """JAX's ``seed_arg``: int32 ``[seed, bh_offset, local_heads,
    head_stride]`` on ``device`` (``local_heads`` and ``head_stride``
    default to ``H``; ``seed`` an int or a tensor, best on the device)."""
    hl = H if local_heads is None else int(local_heads)
    st = hl if head_stride is None else int(head_stride)
    device = torch.device(device)
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor([int(seed)], dtype=torch.int32)
    return torch.cat([seed.to(device=device, dtype=torch.int32).reshape(1),
                      _seed_tail(device, int(bh_offset), hl, st)])


def flash_attention(q, k, v, bias=None, dropout_rate: float = 0.0,
                    dropout_seed=None, bh_offset=0, local_heads=None,
                    head_stride=None):
    """``q, k, v [B, N, H, d]`` -> ``[B, N, H, d]``; differentiable in q, k,
    v. ``dropout_seed`` (int or int32 tensor, best on the device) is needed
    when ``dropout_rate > 0``; the same seed and shape give the same mask,
    so callers draw a fresh seed per step and layer. ``bh_offset`` /
    ``local_heads`` / ``head_stride`` place a shard's batch*head index in
    the global counter (:func:`attention_keep_mask`)."""
    B, N, H, d = q.shape
    rate = float(dropout_rate)
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no path for device {q.device}")
    key_bias = None if bias is None else _key_bias_of(bias, B, H, N)
    seed = (seed_arg(dropout_seed, q.device, H, bh_offset, local_heads,
                     head_stride) if rate else None)
    # the backward's keep bits, only where a backward can follow
    keep_bits = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                        key_bias, seed, rate, keep_bits)


def flash_attention_sharded(q, k, v, bias=None, dropout_rate: float = 0.0,
                            dropout_seed=None, *, mesh):
    """K4's attention form (JAX's ``flash_attention_sharded``): ``q, k,
    v`` are this rank's rows (a block of the batch over the mesh's batch
    axes) and heads (a block over ``model``), ``bias`` its rows' key bias;
    the call runs on them alone (attention has no cross-batch or cross-head
    reduction). The dropout counter takes the shard's global batch*head
    start, ``bh = (b0 + lb) * H + h0 + lh``: ``bh_offset = b0 * H + h0``,
    ``local_heads`` the local heads, ``head_stride`` the global ``H``. The
    kernel runs at every size: past ``2**32`` its counter wraps as
    :func:`attention_keep_mask`'s does (JAX's sharded form guards that size
    with its plain path; its unsharded kernel, like the port's, does not)."""
    B, N, Hl, d = q.shape
    nm = mesh.tp
    H = Hl * nm
    off = mesh.batch_index * B * H + mesh.index(("model",)) * Hl
    rate = float(dropout_rate)
    if q.is_cuda:
        launches_k4["flash_attention_sharded_heads" if "model" in
                    mesh.axis_names else "flash_attention_sharded"] += 1
    return flash_attention(q, k, v, bias, rate, dropout_seed, bh_offset=off,
                           local_heads=Hl, head_stride=H)


def flash_fn(mesh=None):
    """The models' dispatch point: :func:`flash_attention`, or with a mesh
    the K4 form bound to it."""
    if mesh is None:
        return flash_attention
    return functools.partial(flash_attention_sharded, mesh=mesh)
