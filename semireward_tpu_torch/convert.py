"""flax -> torch parameter conversion, on nested dicts of numpy arrays (no
JAX needed at run time).

- Dense ``kernel [in, out]`` -> Linear ``weight [out, in]``; a fused ``qkv``
  kernel keeps its q/k/v thirds in place.
- Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW; a 1-D conv's
  ``[k, in/groups, out]`` -> Conv1d ``[out, in/groups, k]`` (groups kept).
- LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``.
- flax's ``blocks3`` / ``layer3`` module names -> torch's ``blocks.3`` /
  ``layer.3``; raw params (BERT's ``position_embeddings``) keep their name.

Works for the ViT, the BERT and HuBERT/wav2vec2 classifiers and the SemiReward
``Rewarder``/``Generator``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_BLOCK = re.compile(r"^(blocks|layer)(\d+)$")


def _name(part: str) -> str:
    m = _BLOCK.match(part)
    return f"{m.group(1)}.{m.group(2)}" if m else part


def torch_name(path) -> str:
    """flax parameter path (e.g. ('blocks0', 'mlp', 'fc1', 'kernel')) -> torch
    parameter name ('blocks.0.mlp.fc1.weight')."""
    *mods, leaf = [str(p) for p in path]
    leaf = "weight" if leaf in ("kernel", "scale", "embedding") else leaf
    return ".".join([_name(m) for m in mods] + [leaf])


def _value(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel":
        if value.ndim == 2:
            return value.T
        if value.ndim == 3:
            return value.transpose(2, 1, 0)
        if value.ndim == 4:
            return value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {value.ndim}")
    return value


def flax_to_torch(params: Mapping[str, Any], path=()) -> Dict[str, np.ndarray]:
    """Nested flax ``params`` -> flat ``{torch name: array}``."""
    out: Dict[str, np.ndarray] = {}
    for key, value in params.items():
        if isinstance(value, Mapping):
            out.update(flax_to_torch(value, path + (key,)))
        else:
            out[torch_name(path + (key,))] = np.ascontiguousarray(
                _value(key, np.asarray(value)))
    return out


@torch.no_grad()
def load_flax_params(module: torch.nn.Module, params: Mapping[str, Any]
                     ) -> torch.nn.Module:
    """Copy flax ``params`` into ``module`` in place; every parameter must be
    covered and every shape must match."""
    flat = flax_to_torch(params)
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"flax/torch parameter mismatch: missing {missing}, "
                       f"unexpected {extra}")
    for name, p in own.items():
        src = torch.from_numpy(np.array(flat[name], dtype=np.float32))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: flax shape {tuple(src.shape)} vs "
                             f"torch {tuple(p.shape)}")
        p.copy_(src)
    return module
