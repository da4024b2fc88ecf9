"""Released pretrained weights (port of ``semireward_tpu/models/utils.py``).

Load a torch checkpoint (``{'model': state_dict}``, ``{'state_dict': ...}``
or a bare state dict), strip ``module.`` prefixes, skip the classifier
head, resize the ViT position-embedding grid when the geometry differs, and
graft the tensors onto the port's parameters by name. The released files
are torch layouts, as the port's modules are, so no weight is transposed.
The position-embedding resize computes what the JAX package's
``jax.image.resize(method="bicubic")`` computes (Keys cubic, a = -0.5,
half-pixel centres, antialiased when the grid shrinks), which
``torch.nn.functional.interpolate`` does not.
"""
from __future__ import annotations

import math
import os
import re
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel with a = -0.5 (0 from |x| = 2 on)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def cubic_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """``[n_in, n_out]`` weights of a 1-D bicubic resize, as
    ``jax.image.scale_and_translate`` builds them with antialiasing: the
    kernel widens by n_in / n_out when the grid shrinks, each output's
    weights sum to 1, and an output whose sample falls outside the input
    gets none."""
    f32 = np.float32
    inv = f32(n_in / n_out)
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = _keys_cubic(x / kernel_scale).astype(f32)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def resize_pos_embed_vit(posemb: np.ndarray, new_len: int,
                         num_tokens: int = 1) -> np.ndarray:
    """``[1, num_tokens + g*g, D]`` -> ``[1, new_len, D]``: the g x g grid
    resized bicubically to the new square grid, the class token kept."""
    posemb_tok = posemb[:, :num_tokens]
    posemb_grid = posemb[0, num_tokens:]
    gs_old = int(math.sqrt(len(posemb_grid)))
    gs_new = int(math.sqrt(new_len - num_tokens))
    if gs_old == gs_new:
        return posemb
    grid = posemb_grid.reshape(gs_old, gs_old, -1).astype(np.float64)
    w = cubic_resize_weights(gs_old, gs_new).astype(np.float64)
    resized = np.einsum("hwd,hH,wW->HWd", grid, w, w).astype(np.float32)
    return np.concatenate([posemb_tok.astype(np.float32),
                           resized.reshape(1, gs_new * gs_new, -1)], axis=1)


def _torch_state_dict(checkpoint_path: str) -> Dict[str, np.ndarray]:
    """The file's state dict (under ``model`` or ``state_dict`` when
    nested) as numpy arrays, ``module.`` prefixes stripped."""
    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if isinstance(v, torch.Tensor):
            v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        out[k] = np.asarray(v)
    return out


class Graft:
    """float32 numpy copies of a model's named parameters that released
    weights overwrite leaf by leaf; ``result()`` gives them back as
    tensors."""

    def __init__(self, params: Mapping[str, torch.Tensor]):
        self.p = {n: t.detach().float().cpu().numpy()
                  for n, t in params.items()}

    def put(self, name: str, val, transpose: Optional[Sequence[int]] = None):
        val = np.asarray(val, np.float32)
        if transpose is not None:
            val = val.transpose(transpose)
        if name not in self.p:
            raise KeyError(f"the model has no parameter '{name}'")
        if self.p[name].shape != val.shape:
            raise ValueError(f"pretrained '{name}' shape {val.shape} != the "
                             f"model's {self.p[name].shape}")
        self.p[name] = val

    def count(self, pattern: str) -> int:
        """Distinct integers ``i`` in the names that match ``pattern``'s
        ``(\\d+)``: the number of blocks or layers."""
        rx = re.compile(pattern)
        return len({m.group(1) for n in self.p for m in [rx.match(n)] if m})

    def result(self) -> Dict[str, torch.Tensor]:
        return {n: torch.from_numpy(np.ascontiguousarray(v))
                for n, v in self.p.items()}


def load_vit_checkpoint(params: Mapping[str, torch.Tensor],
                        checkpoint_path: str, skip_head: bool = True
                        ) -> Dict[str, torch.Tensor]:
    """Graft a timm-style ViT state dict (the reference's released
    pretrained ``.pth`` files, DINOv2's too) onto the port's ViT
    parameters. As in the JAX package, LayerScale (``blocks.i.ls1.gamma``
    / ``ls2.gamma``) is not read: a grafted DINOv2 keeps ``ls1`` / ``ls2``
    at their init."""
    sd = _torch_state_dict(checkpoint_path)
    g = Graft(params)
    if "pos_embed" in sd:
        g.put("pos_embed", resize_pos_embed_vit(sd["pos_embed"],
                                                g.p["pos_embed"].shape[1]))
    if "cls_token" in sd:
        g.put("cls_token", sd["cls_token"])
    if "patch_embed.proj.weight" in sd:
        g.put("patch_embed.weight", sd["patch_embed.proj.weight"])
        g.put("patch_embed.bias", sd["patch_embed.proj.bias"])
    for i in range(g.count(r"blocks\.(\d+)\.")):
        b = f"blocks.{i}."
        for name in ("norm1", "norm2", "attn.proj", "mlp.fc1", "mlp.fc2"):
            g.put(b + name + ".weight", sd[b + name + ".weight"])
            g.put(b + name + ".bias", sd[b + name + ".bias"])
        if b + "attn.qkv.weight" in g.p:
            g.put(b + "attn.qkv.weight", sd[b + "attn.qkv.weight"])
            if b + "attn.qkv.bias" in sd:
                g.put(b + "attn.qkv.bias", sd[b + "attn.qkv.bias"])
            continue
        # a split_qkv net (tensor parallelism): the fused [3C, C] weight's
        # contiguous thirds [q; k; v] onto the three projections, as the
        # JAX graft does
        w3 = sd[b + "attn.qkv.weight"]
        C = w3.shape[0] // 3
        for j, nm in enumerate(("q", "k", "v")):
            g.put(f"{b}attn.{nm}.weight", w3[j * C:(j + 1) * C])
            if b + "attn.qkv.bias" in sd:
                g.put(f"{b}attn.{nm}.bias",
                      sd[b + "attn.qkv.bias"][j * C:(j + 1) * C])
    if "norm.weight" in sd and "norm.weight" in g.p:
        g.put("norm.weight", sd["norm.weight"])
        g.put("norm.bias", sd["norm.bias"])
    if not skip_head and "head.weight" in sd and "head.weight" in g.p:
        g.put("head.weight", sd["head.weight"])
        g.put("head.bias", sd["head.bias"])
    return g.result()


def load_pretrained(model_name: str, params: Mapping[str, torch.Tensor],
                    checkpoint_path: str) -> Dict[str, torch.Tensor]:
    """Every parameter of the net, the released ones grafted in, by the
    net's family."""
    if not checkpoint_path or not os.path.isfile(checkpoint_path):
        raise FileNotFoundError(
            f"pretrain_path '{checkpoint_path}' not found (no network in this "
            f"environment — place the released .pth locally)")
    if model_name.startswith(("vit", "dinov2")):
        return load_vit_checkpoint(params, checkpoint_path)
    if model_name.startswith("bert"):
        from semireward_tpu_torch.models.bert import load_hf_bert_weights
        return load_hf_bert_weights(params, _torch_state_dict(checkpoint_path))
    if model_name.startswith(("hubert", "wave2vecv2")):
        from semireward_tpu_torch.models.hubert import load_hf_audio_weights
        return load_hf_audio_weights(params,
                                     _torch_state_dict(checkpoint_path))
    raise NotImplementedError(
        f"pretrained import for '{model_name}' not wired yet")
