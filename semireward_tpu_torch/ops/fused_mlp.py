"""Fused transformer MLP: ``gelu(x @ W1^T + b1) @ W2^T + b2``.

Port of ``semireward_tpu/ops/fused_mlp.py``. On a CUDA tensor the forward and
backward run hand-written Hopper kernels, both built on the wgmma + TMA GEMM
of ``csrc/hopper_gemm.cuh`` (two GEMMs forward, five backward, with the bias,
GELU and rounding in their epilogues) and both passing the ``[rows,
hidden]`` activation through device memory:

- K1 (``csrc/fused_mlp.cu``), the port of the full-resident pair
  ``_fwd_kernel``/``_bwd_kernel``, for C a multiple of 64 from 128 to 384
  (ViT-S, ViT-Ti); its GELU epilogues overlap the tensor-core work
  (ping-pong consumer warpgroups);
- K3 (``csrc/fused_mlp_blocked.cu``), the port of the hidden-blocked
  ``_fwd_blocked_kernel``/``_bwd_dx_kernel``/``_bwd_dw_kernel``, for every
  other C that is a multiple of 64 (C 768: ViT-B, DINOv2 ViT-B/14,
  BERT-base, HuBERT-base, wav2vec2-base; C 1024: DINOv2 ViT-L/14), and for
  K1's widths where ``block_h`` < H forces the blocked form.

:func:`blocked_plan` picks both kernels' tile widths and K splits. A width
neither kernel takes (C not a multiple of 64) runs on a CUDA tensor as two
dense layers (bf16 products, exact GELU), as the JAX package's
``fused_mlp`` does where no hidden block fits: :func:`route` chooses that
from the shape alone, never because a build or a launch failed, and each
such forward counts in ``launches["fused_mlp_dense"]``. On a CPU tensor
every width runs the plain PyTorch version below: bf16 (or the activation
dtype) products with f32 accumulation, bias adds and GELU in f32, the
hidden rounded to the activation dtype before the second product, ``dh``
rounded before ``dx``/``dW1``, f32 bias grads from the unrounded ``dh``,
weight grads in the weights' dtype. The kernels compute the same function
with the f32 sums taken in another order (per 64-wide K step). GELU is the
exact erf form everywhere; the TPU kernel used an erf approximation only
because Mosaic had no ``erf`` (max error 1.5e-7).

Weights use ``torch.nn.Linear``'s layout: ``w1 [H, C]``, ``w2 [C, H]``.

K4's MLP forms (``fused_mlp_sharded``, ``fused_mlp_tp_sharded``; the JAX
package's ``shard_map`` forms) run this function on a rank's own rows or
hidden slice with the collectives written out (``parallel/mesh.py``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from semireward_tpu_torch.ops import _build

# launches of each kernel wrapper (a backward counts once per call of its
# kernel sequence), and the forwards that took the two dense layers on a
# card
launches = {"fused_mlp_fwd": 0, "fused_mlp_bwd": 0,
            "fused_mlp_blocked_fwd": 0, "fused_mlp_blocked_bwd": 0,
            "fused_mlp_dense": 0}

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


# launches of K1 / K3 that the K4 forms made (each also counts in
# ``launches``): the data-parallel and the Megatron form
launches_k4 = {"fused_mlp_sharded": 0, "fused_mlp_tp_sharded": 0}


def reset_launches() -> None:
    for d in (launches, launches_k4):
        for k in d:
            d[k] = 0


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

def _typed(name: str, prefix: str):
    lib = _build.load(name)
    if not getattr(lib, "_srt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        getattr(lib, prefix + "_supported").argtypes = [i, i]
        getattr(lib, prefix + "_supported").restype = i
        getattr(lib, prefix + "_fwd").argtypes = [p] * 7 + [i] * 6 + [p]
        getattr(lib, prefix + "_fwd").restype = i
        getattr(lib, prefix + "_bwd").argtypes = [p] * 15 + [i] * 7 + [p]
        getattr(lib, prefix + "_bwd").restype = i
        lib._srt_typed = True
    return lib


def _lib():
    """K1, the full-resident kernels' port."""
    return _typed("fused_mlp", "srt_fused_mlp")


def _blocked_lib():
    """K3, the hidden-blocked kernels' port."""
    return _typed("fused_mlp_blocked", "srt_fused_mlp_blocked")


def check_block_h(h: int, block_h) -> None:
    """The JAX call contract: a ``block_h`` that does not divide the hidden
    dim raises (the TPU grid would silently drop the last partial block)."""
    if block_h is not None and (block_h <= 0 or h % block_h != 0):
        raise ValueError(f"block_h={block_h} must divide hidden dim {h}")


def route(c: int, h: int, device, block_h=None) -> str:
    """Which path an MLP of width ``c`` and hidden ``h`` takes on
    ``device``: ``'plain'`` on the CPU; on a CUDA device ``'full'`` (K1)
    where K1 takes the width and ``block_h`` does not force hidden blocks
    (``block_h`` < ``h``), else ``'blocked'`` (K3) where K3 takes it, else
    ``'dense'`` (two dense layers). Raises ``ValueError`` for a ``block_h``
    that does not divide ``h``."""
    check_block_h(h, block_h)
    if torch.device(device).type != "cuda":
        return "plain"
    forced = block_h is not None and block_h < h
    if not forced and _lib().srt_fused_mlp_supported(c, h):
        return "full"
    if _blocked_lib().srt_fused_mlp_blocked_supported(c, h):
        return "blocked"
    return "dense"


def dense_mlp(x, w1, b1, w2, b2):
    """The two dense layers of the JAX package's ``fused_mlp`` fallback:
    bf16 (activation dtype) products with the biases cast to it, exact
    GELU."""
    launches["fused_mlp_dense"] += 1
    return _dense(x, w1, b1, w2, b2)


def _dense(x, w1, b1, w2, b2):
    dt = x.dtype
    hid = torch.nn.functional.gelu(torch.nn.functional.linear(
        x, w1.to(dt), b1.to(dt)))
    return torch.nn.functional.linear(hid, w2.to(dt), b2.to(dt))


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


def _check_args(x, w1, b1, w2, supported):
    m, c = x.shape
    h = w1.shape[0]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_mlp: the CUDA kernel takes bfloat16 "
                         f"activations, got {x.dtype}")
    _check("x", x, (m, c), torch.bfloat16)
    if not supported(c, h):
        raise NotImplementedError(f"fused_mlp: this kernel does not take "
                                  f"C={c}, H={h} (route() picks the one "
                                  f"that does)")
    _check("w1", w1, (h, c), torch.bfloat16)
    _check("b1", b1, (h,), torch.float32)
    _check("w2", w2, (c, h), torch.bfloat16)
    return m, c, h


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# the kernels' host-side refusals (csrc/hopper_gemm.cuh); CUDA's codes are > 0
_HOST_ERRORS = {-1: "arguments or a plan the kernels do not take",
                -2: "cuTensorMapEncodeTiled is missing or refused a TMA map"}


def _raise_if(err, what):
    if err != 0:
        why = _HOST_ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"fused_mlp: {what} launch failed: {why}")


# The GEMM tiles of K1 and K3 (csrc/hopper_gemm.cuh): GEMM_BM output rows by
# a tile width, K in steps of GEMM_BK; B3 (dW) may split its K = M into up to
# GEMM_MAX_SPLITS.
GEMM_BM, GEMM_BK, GEMM_MAX_SPLITS = 128, 64, 4
# Each kernel's tile widths per GEMM. K1's F1 and B1 run ping-pong (one
# consumer warpgroup owns a whole 128-row tile), which caps their
# accumulators: B1 (two products) at 64 wide. F1 takes 128 only: at 192 its
# epilogue, which bounds it, grew by more than its 1.5x elements (H100,
# PERF.md), so the fuller last wave did not pay.
_WIDTHS = {"blocked": {"up": (128, 256), "down": (128, 256), "dh": (128,),
                       "dx": (128, 256), "dw": (128, 256)},
           "full": {"up": (128,), "down": (128, 192, 256), "dh": (64,),
                    "dx": (128, 192, 256), "dw": (128, 192, 256)}}
# The planning model: the published H100 SXM peaks (989 TFLOP/s bf16 dense,
# 3.35 TB/s) and the share of the tensor-core peak each tile width is assumed
# to reach (a narrower tile reads more shared memory per product). These
# shares rank the candidates; they are not measured rates.
_PEAK_MACS, _PEAK_BYTES = 989e12 / 2, 3.35e12
_TILE_EFF = {64: 0.70, 128: 0.80, 192: 0.85, 256: 0.90}
# device-memory bytes a K split of B3 costs per dW element: the f32 partial
# written and read back counts 8; the measured reduction pass (H100, 2 and 3
# splits at M 6144 and 8192) cost as much as ~14
_SPLIT_BYTES = 14


def _blocked_products(m: int, c: int, h: int, kernel: str = "blocked"):
    """The GEMM launches of K3 (``kernel`` "blocked") or K1 ("full"): name ->
    (outputs [(rows, cols)], K, tile widths, K splits tried, products per
    tile)."""
    w = _WIDTHS[kernel]
    return {
        "up": ([(m, h)], c, w["up"], (1,), 1),        # F1: gelu(x W1^T + b1)
        "down": ([(m, c)], h, w["down"], (1,), 1),    # F2: h W2^T + b2
        "dh": ([(m, h)], c, w["dh"], (1,), 2),        # B1: x W1^T and g W2
        "dx": ([(m, c)], h, w["dx"], (1,), 1),        # B2: dh W1
        "dw": ([(h, c), (c, h)], m, w["dw"],          # B3: dh^T x and g^T h
               tuple(range(1, GEMM_MAX_SPLITS + 1)), 1),
    }


def blocked_tiles(outputs, k: int, bn: int, splits: int):
    """The tiles of one GEMM launch in the order its persistent grid walks
    them (CTA b takes tiles b, b + grid, ...), as ``csrc/hopper_gemm.cuh:
    decode`` enumerates them: split-major, then each output's tiles, row
    tiles fastest. Each is (split, output, row0, col0, kb, ke) with K steps
    [kb, ke) of ``GEMM_BK``."""
    ks = math.ceil(k / GEMM_BK)
    tiles = []
    for s in range(splits):
        kb, ke = s * ks // splits, (s + 1) * ks // splits
        for p, (rows, cols) in enumerate(outputs):
            mt = math.ceil(rows / GEMM_BM)
            for q in range(mt * math.ceil(cols / bn)):
                tiles.append((s, p, (q % mt) * GEMM_BM, (q // mt) * bn, kb, ke))
    return tiles


def _blocked_tile_count(outputs, bn: int, splits: int) -> int:
    return splits * sum(math.ceil(r / GEMM_BM) * math.ceil(c / bn)
                        for r, c in outputs)


def _blocked_cost(outputs, k, bn, splits, sms, per_tile):
    """Modelled seconds of one launch: full waves of the persistent grid
    times one tile's products at the width's assumed rate, plus the K
    splits' f32 partials (``_SPLIT_BYTES``)."""
    steps = math.ceil(math.ceil(k / GEMM_BK) / splits)
    tile_s = (per_tile * GEMM_BM * bn * GEMM_BK * steps
              / (_PEAK_MACS / sms * _TILE_EFF[bn]))
    ws = 0 if splits == 1 else _SPLIT_BYTES * splits * sum(r * c for r, c
                                                          in outputs)
    return (math.ceil(_blocked_tile_count(outputs, bn, splits) / sms) * tile_s
            + ws / _PEAK_BYTES)


def _blocked_choices(m, c, h, sms, bn, dw_splits, kernel):
    """((name, bn, splits, tiles), ...): the search behind blocked_plan."""
    chosen = []
    for name, (outputs, k, bns, splits_tried, per_tile) in \
            _blocked_products(m, c, h, kernel).items():
        if bn in bns:
            bns = (bn,)
        if name == "dw" and dw_splits is not None:
            splits_tried = (dw_splits,)
        best = None
        for width in bns:
            for s in splits_tried:
                if s > math.ceil(k / GEMM_BK):
                    continue
                cost = _blocked_cost(outputs, k, width, s, sms, per_tile)
                if best is None or cost < best[0]:
                    best = (cost, width, s)
        if best is None:
            raise ValueError(f"blocked_plan: {dw_splits} K splits of M={m}")
        _, width, s = best
        chosen.append((name, width, s,
                       _blocked_tile_count(outputs, width, s)))
    return tuple(chosen)


@functools.lru_cache(maxsize=256)
def blocked_plan(m: int, c: int, h: int, sms: int, bn=None,
                 dw_splits=None, kernel: str = "blocked") -> dict:
    """The launch plan of K3 (``kernel`` "blocked") or K1 ("full") for ``m``
    rows on a card of ``sms`` SMs: for each GEMM (``up``, ``down`` forward;
    ``dh``, ``dx``, ``dw`` backward) the tile width ``bn``, the K
    ``splits``, its ``tiles`` and ``grid`` (one CTA per SM, at most one per
    tile), chosen from the kernel's widths by :func:`_blocked_cost` so the
    last wave is nearly full; and the ``workspace`` element counts the
    wrapper allocates (bf16 ``h``/``dh``, f32 ``dw`` split partials,
    ``db1`` per 128-row tile, ``db2`` per 32-row chunk). ``bn`` and
    ``dw_splits`` force a tile width on every GEMM that takes it and B3's K
    splits (the card tests reach every variant so). Pure: no device is
    asked. Cached, because every kernel call asks for its plan: the dict is
    shared, and callers only read it."""
    if m <= 0 or sms <= 0:
        raise ValueError(f"blocked_plan: m={m}, sms={sms} must be positive")
    plan = {"sms": sms}
    for name, width, s, tiles in _blocked_choices(m, c, h, sms, bn,
                                                  dw_splits, kernel):
        plan[name] = {"bn": width, "splits": s, "tiles": tiles,
                      "grid": min(tiles, sms)}
    splits = plan["dw"]["splits"]
    plan["workspace"] = {"h": m * h, "dh": m * h,
                         "dw": 2 * c * h * splits if splits > 1 else 0,
                         "db1": math.ceil(m / GEMM_BM) * h,
                         "db2": math.ceil(m / 32) * c}
    return plan


@functools.lru_cache(maxsize=None)
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(device) -> int:
    device = torch.device(device)
    return _sms_of(torch.cuda.current_device() if device.index is None
                   else device.index)


# kernel -> (its library, its C prefix, its launch-count prefix)
_ENTRY = {"full": (_lib, "srt_fused_mlp", "fused_mlp"),
          "blocked": (_blocked_lib, "srt_fused_mlp_blocked",
                      "fused_mlp_blocked")}


def _run_fwd(kernel, x, w1, b1, w2, b2, plan):
    get_lib, prefix, key = _ENTRY[kernel]
    lib = get_lib()
    m, c, h = _check_args(x, w1, b1, w2, getattr(lib, prefix + "_supported"))
    _check("b2", b2, (c,), torch.float32)
    plan = plan or blocked_plan(m, c, h, _sms(x.device), kernel=kernel)
    out = torch.empty_like(x)
    hid = torch.empty(m, h, device=x.device, dtype=x.dtype)
    err = getattr(lib, prefix + "_fwd")(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), hid.data_ptr(), m, c, h,
        plan["up"]["bn"], plan["down"]["bn"], plan["sms"], _stream(x))
    _raise_if(err, f"{key} forward")
    launches[key + "_fwd"] += 1
    return out


def _run_bwd(kernel, x, w1, b1, w2, g, plan):
    get_lib, prefix, key = _ENTRY[kernel]
    lib = get_lib()
    m, c, h = _check_args(x, w1, b1, w2, getattr(lib, prefix + "_supported"))
    _check("g", g, (m, c), torch.bfloat16)
    plan = plan or blocked_plan(m, c, h, _sms(x.device), kernel=kernel)
    dx = torch.empty_like(x)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    db1 = torch.empty(h, device=x.device, dtype=torch.float32)
    db2 = torch.empty(c, device=x.device, dtype=torch.float32)
    # the scratch (bf16 h and dh, f32 partials) in one allocation: a host
    # call less per buffer in steps that the host bounds
    ws = plan["workspace"]
    sizes = (2 * ws["h"], 2 * ws["dh"], 4 * ws["dw"], 4 * ws["db1"],
             4 * ws["db2"])
    offsets = [0]
    for n in sizes[:-1]:
        offsets.append(offsets[-1] + -(-n // 256) * 256)
    scratch = torch.empty(offsets[-1] + sizes[-1], device=x.device,
                          dtype=torch.uint8)
    hid, dh, ws_dw, ws_db1, ws_db2 = (
        scratch.data_ptr() + o if n else None
        for o, n in zip(offsets, sizes))
    err = getattr(lib, prefix + "_bwd")(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        g.data_ptr(), dx.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
        db1.data_ptr(), db2.data_ptr(), hid, dh, ws_dw, ws_db1, ws_db2,
        m, c, h, plan["dx"]["bn"], plan["dw"]["bn"], plan["dw"]["splits"],
        plan["sms"], _stream(x))
    _raise_if(err, f"{key} backward")
    launches[key + "_bwd"] += 1
    return dx, dw1, dw2, db1, db2


def kernel_fwd(x, w1, b1, w2, b2, plan=None):
    """K1 forward (F1, F2). ``plan`` defaults to ``blocked_plan(...,
    kernel="full")``'s; the card tests pass others to reach every tile
    width."""
    return _run_fwd("full", x, w1, b1, w2, b2, plan)


def kernel_bwd(x, w1, b1, w2, g, plan=None):
    """K1 backward (B1, B2, B3, the g column sums and the fixed-order
    reduction) -> (dx, dw1, dw2, db1, db2). ``plan`` as in
    :func:`kernel_fwd` (the card tests reach B3's K splits so)."""
    return _run_bwd("full", x, w1, b1, w2, g, plan)


def kernel_blocked_fwd(x, w1, b1, w2, b2, plan=None):
    """K3 forward (F1, F2); ``plan`` as in :func:`kernel_fwd`."""
    return _run_fwd("blocked", x, w1, b1, w2, b2, plan)


def kernel_blocked_bwd(x, w1, b1, w2, g, plan=None):
    """K3 backward -> (dx, dw1, dw2, db1, db2); ``plan`` as in
    :func:`kernel_fwd`."""
    return _run_bwd("blocked", x, w1, b1, w2, g, plan)


_FWD = {"plain": plain_fwd, "full": kernel_fwd, "blocked": kernel_blocked_fwd}
_BWD = {"plain": plain_bwd, "full": kernel_bwd, "blocked": kernel_blocked_bwd}


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, kind):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.kind = kind
        return _FWD[kind](x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, dw2, db1, db2 = _BWD[ctx.kind](
            x, w1, b1, w2, g.to(x.dtype).contiguous())
        return dx, dw1, db1, dw2, db2, None


def fused_mlp(x, w1, b1, w2, b2, block_h=None):
    """``x`` [..., C] in the activation dtype; ``w1`` [H, C], ``w2`` [C, H]
    cast to it (as a Linear with a compute dtype does); biases in f32.
    CPU tensors take the plain version, CUDA tensors K1, K3 or the two
    dense layers (:func:`route`; ``block_h`` < H forces K3, and must divide
    H as in the JAX package); a kernel raises on a dtype it does not
    take."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mlp: no path for device {x.device}")
    lead, c = x.shape[:-1], x.shape[-1]
    kind = route(c, w1.shape[0], x.device, block_h)
    if kind == "dense":
        return dense_mlp(x, w1, b1, w2, b2)
    dt = x.dtype
    out = _FusedMLP.apply(x.reshape(-1, c).contiguous(), w1.to(dt).contiguous(),
                          b1.float().contiguous(), w2.to(dt).contiguous(),
                          b2.float().contiguous(), kind)
    return out.reshape(*lead, -1)


# ---------------------------------------------------------------------------
# K4: the sharded forms (JAX's fused_mlp_sharded / fused_mlp_tp_sharded)
# ---------------------------------------------------------------------------

def fused_mlp_sharded(x, w1, b1, w2, b2, *, mesh, block_h=None):
    """K4's data-parallel form: ``x`` is this rank's rows (a block of the
    batch over the mesh's batch axes), the weights whole on every rank; K1
    / K3 (:func:`fused_mlp`) run on the local rows. The weights' gradients
    are this rank's; the step sums them over the batch ranks with every
    other gradient (``Layout.sync``), where JAX's form sums them in its
    backward. On a mesh with a ``model`` axis this is the Megatron form,
    as in the JAX package."""
    if "model" in mesh.axis_names:
        return fused_mlp_tp_sharded(x, w1, b1, w2, b2, mesh=mesh,
                                    hidden=w1.shape[0])
    _count_k4("fused_mlp_sharded", x, w1, block_h)
    return fused_mlp(x, w1, b1, w2, b2, block_h)


def _count_k4(form: str, x, w1, block_h=None) -> None:
    """One launch of ``form`` where its call takes K1 or K3."""
    if x.is_cuda and route(x.shape[-1], w1.shape[0], x.device,
                           block_h) != "dense":
        launches_k4[form] += 1


class _AddBias(torch.autograd.Function):
    """``y + b2`` in ``y``'s dtype, as JAX's form adds it; b2's gradient
    the f32 row sum of g, as its backward computes it (autograd's would
    sum in ``y``'s dtype)."""

    @staticmethod
    def forward(ctx, y, b2):
        ctx.b2_dtype = b2.dtype
        return y + b2.to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        db2 = g.float().reshape(-1, g.shape[-1]).sum(0)
        return g, db2.to(ctx.b2_dtype)


def fused_mlp_tp_sharded(x, w1, b1, w2, b2, *, mesh, hidden: int):
    """K4's Megatron form: ``w1`` holds this rank's rows of the hidden
    (fc1 column-parallel), ``w2`` the same hidden columns (fc2
    row-parallel), ``b1`` its block, ``b2`` whole; ``x`` is the same on
    every model rank. Forward: K1 / K3 (as :func:`route` says for the
    slice's width: BERT's H 3072 over 4 ranks gives 768) computes the
    local partial with a zero b2, the partials are summed over ``model``
    and b2 added after. Backward: dx summed over ``model``, dW1 / db1 /
    dW2 local to the hidden slice and db2 the row sum of g, each over this
    rank's rows (the step sums them over the batch ranks). Where the layout
    left fc1 whole (``hidden`` not a multiple of the model axis), JAX's
    dense fallback runs instead."""
    from semireward_tpu_torch.parallel.mesh import sum_fwd, sum_grad
    mg = mesh.group(("model",))
    if w1.shape[0] == hidden and mesh.tp > 1:
        return (dense_mlp if x.is_cuda else _dense)(x, w1, b1, w2, b2)
    _count_k4("fused_mlp_tp_sharded", x, w1)
    part = fused_mlp(sum_grad(x, mg), w1, b1, w2, torch.zeros_like(b2))
    return _AddBias.apply(sum_fwd(part, mg), b2)
