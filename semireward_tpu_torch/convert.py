"""flax -> torch parameter conversion, on nested dicts of numpy arrays (no
JAX needed at run time).

- Dense ``kernel [in, out]`` -> Linear ``weight [out, in]``; a fused ``qkv``
  kernel keeps its q/k/v thirds in place.
- Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW; a 1-D conv's
  ``[k, in/groups, out]`` -> Conv1d ``[out, in/groups, k]`` (groups kept).
- LayerNorm / BatchNorm ``scale`` -> ``weight``; Embed ``embedding`` ->
  ``weight``; raw parameters keep their name (the ViT block's LayerScale
  ``blocks3/ls1`` -> ``blocks.3.ls1``).
- ``batch_stats`` ``mean`` / ``var`` -> the BatchNorm's ``running_mean`` /
  ``running_var`` buffers.
- flax's ``blocks3`` / ``layer3`` module names -> torch's ``blocks.3`` /
  ``layer.3``, ResNet-50's ``layer2_1`` -> ``layer2.1``; raw params (BERT's ``position_embeddings``) keep their name.

Works for the ViT, the BERT and HuBERT/wav2vec2 classifiers, the WideResNets,
ResNet-50 and the SemiReward ``Rewarder``/``Generator``, and for the algorithms' net
wrappers, nested too: ``{'backbone': {'backbone': ..., 'rot_classifier':
...}, 'aux_classifier': ...}`` (ABC over ReMixMatch) maps onto
``backbone.backbone.*``, ``backbone.rot_classifier.*`` and
``aux_classifier.*``, CoSSL's head onto ``teacher_classifier.*``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_BLOCK = re.compile(r"^(blocks|layer|layer\d+_)(\d+)$")


def _name(part: str) -> str:
    m = _BLOCK.match(part)
    return f"{m.group(1).rstrip('_')}.{m.group(2)}" if m else part


_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
_STATS_LEAF = {"mean": "running_mean", "var": "running_var"}


def torch_name(path, stats: bool = False) -> str:
    """flax parameter path (e.g. ('blocks0', 'mlp', 'fc1', 'kernel')) -> torch
    parameter name ('blocks.0.mlp.fc1.weight'); with ``stats`` a
    ``batch_stats`` path (('bn1', 'mean') -> 'bn1.running_mean')."""
    *mods, leaf = [str(p) for p in path]
    leaf = (_STATS_LEAF if stats else _PARAM_LEAF).get(leaf, leaf)
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


def flax_to_torch(params: Mapping[str, Any], path=(), stats: bool = False
                  ) -> Dict[str, np.ndarray]:
    """Nested flax ``params`` (or, with ``stats``, ``batch_stats``) -> flat
    ``{torch name: array}``."""
    out: Dict[str, np.ndarray] = {}
    for key, value in params.items():
        if isinstance(value, Mapping):
            out.update(flax_to_torch(value, path + (key,), stats))
        else:
            out[torch_name(path + (key,), stats)] = np.ascontiguousarray(
                np.asarray(value) if stats else _value(key, np.asarray(value)))
    return out


def _copy_all(kind: str, own: Dict[str, torch.Tensor],
              flat: Dict[str, np.ndarray]) -> None:
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"flax/torch {kind} mismatch: missing {missing}, "
                       f"unexpected {extra}")
    for name, p in own.items():
        src = torch.from_numpy(np.array(flat[name], dtype=np.float32))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: flax shape {tuple(src.shape)} vs "
                             f"torch {tuple(p.shape)}")
        p.copy_(src)


@torch.no_grad()
def load_flax_params(module: torch.nn.Module, params: Mapping[str, Any],
                     batch_stats: Mapping[str, Any] = None
                     ) -> torch.nn.Module:
    """Copy flax ``params`` (and the BatchNorm ``batch_stats``, when given)
    into ``module`` in place; every parameter (every BatchNorm buffer) must
    be covered and every shape must match."""
    _copy_all("parameter", dict(module.named_parameters()),
              flax_to_torch(params))
    if batch_stats is not None:
        _copy_all("batch_stats", {n: b for n, b in module.named_buffers()
                                  if n.endswith(("running_mean",
                                                 "running_var"))},
                  flax_to_torch(batch_stats, stats=True))
    return module
