"""Vision Transformer (port of ``semireward_tpu/models/vit.py``).

Same parameters and dtype policy as the flax model: parameters in float32;
patch embedding, attention projections and MLP compute in ``dtype``
(bfloat16 by default); attention scores, softmax and LayerNorms in float32,
probabilities cast back to ``dtype``; the residual stream in ``dtype``;
features and head in float32. The MLP runs the fused kernel
(``ops/fused_mlp.py``) under the same gate as the JAX model: fused unless
training with MLP dropout. With ``use_flash`` the attention runs the
flash kernel (``ops/attention.py``, no bias, no dropout) under the JAX
model's gate: unless training with attention dropout. Module names follow
torch idiom (``blocks.0`` for flax ``blocks0``);
``semireward_tpu_torch.convert`` maps one onto the other.

With ``init_values`` (DINOv2's LayerScale, ``models/dinov2.py``) each block
scales its attention and MLP outputs by the float32 parameters ``ls1`` and
``ls2`` (``[C]``, constant ``init_values`` at init) before the drop path:
the bf16 branch times the float32 gamma is taken in float32 and cast to the
residual's dtype, as JAX's promotion does in the flax block.

With ``remat`` (the configs' ``gradient_checkpointing``) each block of a
training forward under autograd runs inside
``torch.utils.checkpoint.checkpoint`` (non-reentrant): its activations are
dropped and the block runs again in the backward, the fused-MLP and flash
kernels included. A block's two drop-path masks are drawn before the
checkpointed region and passed in, and the recompute replays the generator
from where the block's forward started it (its dropout masks), so the
backward sees the forward's masks, as ``nn.remat`` replays its key in the
flax model. Eval forwards and forwards without grad run no checkpoint.

With ``fused_mesh`` (a ``parallel/mesh.py`` mesh; the trainer passes it on
a mesh) the MLP and the attention run their K4 forms (``mlp_forward``,
``ops.attention.flash_fn``), and where the mesh's layout gave a layer a
block of the ``model`` axis the layer is Megatron's: column-parallel
q / k / v (``split_qkv``: three projections for the fused ``qkv``, as the
JAX model's tensor-parallel variant) and fc1, row-parallel ``proj`` and fc2
summed over ``model`` with the bias added after; the attention runs on the
rank's heads. BERT and HuBERT take the same helpers (``qkv_heads``,
``out_proj``, ``mlp_forward``).
"""
from __future__ import annotations

import contextlib
import inspect
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from semireward_tpu_torch import rng
from semireward_tpu_torch.models.initializers import init_module_
from semireward_tpu_torch.ops.attention import flash_fn
from semireward_tpu_torch.ops.fused_mlp import (fused_mlp, fused_mlp_sharded,
                                                fused_mlp_tp_sharded)
from semireward_tpu_torch.parallel import mesh as mesh_lib


def _linear(x, layer: nn.Linear, dtype):
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _dropout(x, rate: float, train: bool, generator, cols=None):
    """Dropout of ``x`` (rows its batch); ``cols`` names the dim that holds
    this rank's tensor-parallel block, if any (``rng.rand``)."""
    if not train or rate == 0.0:
        return x
    keep = rng.rand(x.shape, generator=generator, device=x.device, rows=0,
                    cols=cols) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _drop_path(x, rate: float, train: bool, generator):
    """Stochastic depth per sample (timm DropPath)."""
    if not train or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    keep = rng.rand(shape, generator=generator, device=x.device,
                    rows=0) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


def _path_scale(x, rate: float, train: bool, generator):
    """A residual branch's drop-path factor per sample, drawn ahead of the
    block: ``_drop_path`` of ones ``[B, 1, ...]`` (``1 / keep_prob`` where
    the sample is kept, 0 where it is dropped), or None when nothing
    drops."""
    if not train or rate == 0.0:
        return None
    ones = x.new_ones((x.shape[0],) + (1,) * (x.ndim - 1))
    return _drop_path(ones, rate, train, generator)


def _apply_path(h, scale):
    """``h`` under the drop-path factor ``_path_scale`` drew."""
    return h if scale is None else h * scale


def _replay(generator: torch.Generator):
    """``checkpoint``'s ``context_fn``: the recompute starts ``generator``
    where the forward started it (so it draws the forward's dropout
    masks), and leaves it where it was."""
    start = []

    @contextlib.contextmanager
    def forward():
        start.append(generator.get_state())
        yield

    @contextlib.contextmanager
    def recompute():
        now = generator.get_state()
        generator.set_state(start[0])
        try:
            yield
        finally:
            generator.set_state(now)

    return forward(), recompute()


def _layer_norm(x, norm: nn.LayerNorm):
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps)


def mlp_forward(x, fc1: nn.Linear, fc2: nn.Linear, hidden: int, dtype,
                fused: bool, mesh, train: bool, drop: float, generator):
    """``fc2(gelu(fc1(x)))`` with dropout after each (none under
    ``fused``, the kernel's gate): through the fused kernel, or with a mesh
    its K4 form (data-parallel; Megatron where the mesh has ``model``),
    else two dense layers, column- / row-parallel where the layout split
    the hidden over ``model``."""
    ws = (fc1.weight, fc1.bias, fc2.weight, fc2.bias)
    if fused:
        x = x.to(dtype)
        if mesh is None:
            return fused_mlp(x, *ws)
        if "model" in mesh.axis_names:
            return fused_mlp_tp_sharded(x, *ws, mesh=mesh, hidden=hidden)
        return fused_mlp_sharded(x, *ws, mesh=mesh)
    tp = mesh_lib.tp_mesh(mesh)
    if tp is not None and mesh_lib.is_split(fc1, hidden, 0):
        h = F.gelu(mesh_lib.col_linear(x, fc1, dtype, tp))
        h = _dropout(h, drop, train, generator, cols=h.ndim - 1)
        h = mesh_lib.row_linear(h, fc2, dtype, tp)
    else:
        h = F.gelu(_linear(x, fc1, dtype))
        h = _dropout(h, drop, train, generator)
        h = _linear(h, fc2, dtype)
    return _dropout(h, drop, train, generator)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, drop: float = 0.0,
                 dtype=torch.bfloat16, use_fused: bool = False, mesh=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop, self.dtype, self.use_fused = drop, dtype, use_fused
        self.hidden, self.mesh = hidden, mesh

    def forward(self, x, train: bool, generator=None):
        return mlp_forward(x, self.fc1, self.fc2, self.hidden, self.dtype,
                           self.use_fused and not (train and self.drop > 0),
                           self.mesh, train, self.drop, generator)


def head_block(layer: nn.Linear, dim: int, hd: int, mesh) -> bool:
    """Whether the layout gave ``layer`` (a column-parallel q / k / v of
    width ``dim``) a block of the heads; raises where the block would cut
    a head (the model axis must divide the heads, as the JAX package's
    docstring asks)."""
    if mesh_lib.tp_mesh(mesh) is None or not mesh_lib.is_split(layer, dim, 0):
        return False
    if layer.weight.shape[0] % hd:
        raise NotImplementedError(
            f"tensor parallelism over {mesh.tp} ranks cuts a head of "
            f"{hd} out of {dim}: the model axis must divide the heads")
    return True


def qkv_heads(x, layers, dim: int, heads: int, dtype, mesh):
    """``q, k, v [B, L, Hl, hd]`` from three projections of width ``dim``,
    column-parallel where the layout gave them a block of the heads (then
    ``Hl`` is that block and ``local`` True)."""
    B, L = x.shape[:2]
    hd = dim // heads
    local = head_block(layers[0], dim, hd, mesh)
    proj = ((lambda l: mesh_lib.col_linear(x, l, dtype, mesh)) if local
            else (lambda l: _linear(x, l, dtype)))
    q, k, v = (proj(l) for l in layers)
    Hl = q.shape[-1] // hd
    return tuple(t.reshape(B, L, Hl, hd) for t in (q, k, v)) + (local,)


def out_proj(out, layer: nn.Linear, dim: int, dtype, mesh, local_in: bool):
    """The attention's output projection, row-parallel where the layout
    split its input over ``model`` (``local_in``: the heads are this rank's
    block already)."""
    tp = mesh_lib.tp_mesh(mesh)
    if tp is not None and mesh_lib.is_split(layer, dim, 1):
        return mesh_lib.row_linear(out, layer, dtype, tp, local_in=local_in)
    return _linear(out, layer, dtype)


class Attention(nn.Module):
    """``split_qkv`` (the JAX model's tensor-parallel variant): three
    projections ``q`` / ``k`` / ``v`` in place of the fused ``qkv``, so that
    the Megatron layout splits each head-aligned; the same function."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype=torch.bfloat16, use_flash: bool = False,
                 split_qkv: bool = False, mesh=None):
        super().__init__()
        self.num_heads, self.dim, self.split_qkv = num_heads, dim, split_qkv
        if split_qkv:
            for name in ("q", "k", "v"):
                self.add_module(name, nn.Linear(dim, dim, bias=qkv_bias))
        else:
            self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.attn_drop, self.proj_drop, self.dtype = attn_drop, proj_drop, dtype
        self.use_flash, self.mesh = use_flash, mesh

    def forward(self, x, train: bool, generator=None):
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        dt = self.dtype
        if self.split_qkv:
            q, k, v, local = qkv_heads(x, (self.q, self.k, self.v), C, H, dt,
                                       self.mesh)
        else:
            # contiguous thirds of the fused projection, as in the flax model
            q, k, v = (t.reshape(B, N, H, hd)
                       for t in _linear(x, self.qkv, dt).split(C, dim=-1))
            local = False
        Hl = q.shape[2]
        if self.use_flash and not (train and self.attn_drop > 0):
            out = flash_fn(self.mesh)(q, k, v).reshape(B, N, Hl * hd)
        else:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, N, hd]
            # bf16 products are exact in f32, so the f32 product reproduces
            # the JAX einsum with preferred_element_type=float32
            a = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
            a = _dropout(F.softmax(a, dim=-1), self.attn_drop, train, generator,
                         cols=1 if local else None)
            out = torch.matmul(a.to(dt), v)
            out = out.transpose(1, 2).reshape(B, N, Hl * hd)
        out = out_proj(out, self.proj, C, dt, self.mesh, local)
        return _dropout(out, self.proj_drop, train, generator)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 dtype=torch.bfloat16, use_fused_mlp: bool = False,
                 use_flash: bool = False, remat: bool = False,
                 init_values: Optional[float] = None,
                 split_qkv: bool = False, mesh=None):
        super().__init__()
        # parameters in the flax block's order: norm1, attn, ls1, norm2,
        # mlp, ls2
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop, dtype,
                              use_flash, split_qkv, mesh)
        self.ls1 = nn.Parameter(torch.empty(dim)) if init_values else None
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, dtype, use_fused_mlp,
                       mesh)
        self.ls2 = nn.Parameter(torch.empty(dim)) if init_values else None
        self.drop_path, self.dtype, self.remat = drop_path, dtype, remat
        self.init_values = init_values

    def forward(self, x, train: bool, generator=None):
        s1 = _path_scale(x, self.drop_path, train, generator)
        s2 = _path_scale(x, self.drop_path, train, generator)
        if not (self.remat and train and torch.is_grad_enabled()):
            return self._body(x, train, generator, s1, s2)
        # the recompute replays the dropout draws: from ``generator``, or
        # from the global generators, which checkpoint itself replays
        kw = {} if generator is None else {
            "preserve_rng_state": False,
            "context_fn": lambda: _replay(generator)}
        return checkpoint(self._body, x, train, generator, s1, s2,
                          use_reentrant=False, **kw)

    def _body(self, x, train: bool, generator, s1, s2):
        h = self.attn(_layer_norm(x, self.norm1).to(self.dtype), train,
                      generator)
        if self.ls1 is not None:
            h = h * self.ls1  # bf16 x f32 -> f32
        x = x + _apply_path(h.to(x.dtype), s1)
        h = self.mlp(_layer_norm(x, self.norm2).to(self.dtype), train,
                     generator)
        if self.ls2 is not None:
            h = h * self.ls2
        return x + _apply_path(h.to(x.dtype), s2)


class VisionTransformer(nn.Module):
    """Input NHWC float, like the flax model. ``forward`` returns
    ``{'logits', 'feat'}`` (or features / logits with ``only_feat`` /
    ``only_fc``)."""

    def __init__(self, num_classes: int, img_size: int = 224,
                 patch_size: int = 16, in_chans: int = 3,
                 global_pool: str = "token", embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 dtype=torch.bfloat16, use_fused_mlp: bool = False,
                 use_flash: bool = False, remat: bool = False,
                 init_values: Optional[float] = None,
                 split_qkv: bool = False, fused_mesh=None):
        super().__init__()
        self.num_classes, self.img_size, self.patch_size = (num_classes,
                                                            img_size,
                                                            patch_size)
        self.global_pool, self.embed_dim, self.depth = (global_pool,
                                                        embed_dim, depth)
        self.drop_rate, self.dtype = drop_rate, dtype
        num_patches = (img_size // patch_size) ** 2
        self.patch_embed = nn.Conv2d(in_chans, embed_dim, patch_size,
                                     stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1,
                                                  embed_dim))
        dpr = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, drop_rate,
                  attn_drop_rate, dpr[i], dtype, use_fused_mlp, use_flash,
                  remat, init_values, split_qkv, fused_mesh)
            for i in range(depth))
        if global_pool == "avg":
            self.fc_norm = nn.LayerNorm(embed_dim, eps=1e-6)
        else:
            self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.head = nn.Linear(embed_dim, num_classes)

    @property
    def num_features(self) -> int:
        return self.embed_dim

    def forward(self, x, train: bool = True, only_fc: bool = False,
                only_feat: bool = False, generator=None):
        if only_fc:
            return F.linear(x.float(), self.head.weight, self.head.bias)
        dt = self.dtype
        B = x.shape[0]
        x = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)                      # [B, N-1, C]
        cls = self.cls_token.to(dt).expand(B, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        x = _dropout(x, self.drop_rate, train, generator)
        for blk in self.blocks:
            x = blk(x, train, generator)
        if self.global_pool == "avg":
            feat = _layer_norm(x[:, 1:].mean(1), self.fc_norm)
        else:
            x = _layer_norm(x, self.norm)
            feat = x[:, 0] if self.global_pool else x
        feat = feat.float()
        if only_feat:
            return feat
        return {"logits": F.linear(feat, self.head.weight, self.head.bias),
                "feat": feat}


def layer_id(names: List[str], num_layers: int) -> int:
    """Layer-decay group: embeddings = 0, block i = i + 1, norm/head = last
    (names are the dot-split parameter name, e.g. ['blocks', '3', ...])."""
    if not names:
        return num_layers
    head = names[0]
    if head in ("cls_token", "pos_embed", "patch_embed"):
        return 0
    if head == "blocks":
        return int(names[1]) + 1
    return num_layers


_VIT_ARGS = set(inspect.signature(VisionTransformer.__init__).parameters) - {
    "self", "num_classes", "dtype"}


def build_vit(num_classes: int, dtype=torch.bfloat16, device=None,
              generator: Optional[torch.Generator] = None,
              **kw) -> VisionTransformer:
    """A ``VisionTransformer`` of ``kw``'s geometry on ``device``, with the
    flax model's init: torch-default kernels drawn from ``generator``, zero
    biases and tokens, LayerScale at ``init_values``."""
    with torch.device("meta"):
        model = VisionTransformer(num_classes=num_classes, dtype=dtype, **kw)
    model = model.to_empty(device=device or "cpu")
    init_module_(model, generator)
    with torch.no_grad():
        model.cls_token.zero_()
        model.pos_embed.zero_()
        for blk in model.blocks:
            if blk.init_values:
                blk.ls1.fill_(blk.init_values)
                blk.ls2.fill_(blk.init_values)
    return model


def _builder(name, **cfg):
    def build(num_classes: int, dtype=torch.bfloat16, device=None,
              generator: Optional[torch.Generator] = None,
              **kw) -> VisionTransformer:
        merged = dict(cfg)
        merged.update({k: v for k, v in kw.items() if k in _VIT_ARGS})
        return build_vit(num_classes, dtype, device, generator, **merged)

    build.__name__ = name
    build.layer_id_fn = layer_id
    build.num_layers = cfg.get("depth", 12) + 1
    return build


vit_tiny_patch2_32 = _builder("vit_tiny_patch2_32", img_size=32, patch_size=2,
                              embed_dim=192, depth=12, num_heads=3,
                              drop_path_rate=0.1)
vit_small_patch2_32 = _builder("vit_small_patch2_32", img_size=32,
                               patch_size=2, embed_dim=384, depth=12,
                               num_heads=6, drop_path_rate=0.2)
vit_small_patch16_224 = _builder("vit_small_patch16_224", img_size=224,
                                 patch_size=16, embed_dim=384, depth=12,
                                 num_heads=6, drop_path_rate=0.2)
vit_base_patch16_96 = _builder("vit_base_patch16_96", img_size=96,
                               patch_size=16, embed_dim=768, depth=12,
                               num_heads=12, drop_path_rate=0.2)
vit_base_patch16_224 = _builder("vit_base_patch16_224", img_size=224,
                                patch_size=16, embed_dim=768, depth=12,
                                num_heads=12, drop_path_rate=0.2)
