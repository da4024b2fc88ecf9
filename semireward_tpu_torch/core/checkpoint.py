"""Checkpoint / resume (port of ``semireward_tpu/core/checkpoint.py``).

One file per checkpoint: ``torch.save`` of ``{"state": {name: CPU tensor},
"extra": dict}``, where ``state`` is ``TrainState.state_dict()`` (step,
parameters and BatchNorm buffers, EMA, optimizer moments and counts, the
algorithm state, the SemiReward rewarder / generator / optimizer / EMA /
max_reward, the generator state). The write is atomic (``.tmp`` then
``os.replace``) and every load is ``weights_only``. The trainer keeps the
JAX package's two files, ``latest_model.ckpt`` and ``model_best.ckpt``.

On a mesh (a state with a ``layout``) every rank calls ``save_checkpoint``:
the sharded leaves (parameters, EMA, moments) are gathered whole on every
rank (collectives) and rank 0 alone writes, so the file holds the same keys
and values as a one-process run's and the eval CLI and ``--resume`` read it
anywhere; a load cuts each leaf to the rank's block again.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from semireward_tpu_torch.core.train_state import check_leaves
from semireward_tpu_torch.parallel.mesh import param_of

LATEST = "latest_model.ckpt"
BEST = "model_best.ckpt"


def _plain(x):
    """``extra`` as types ``weights_only`` loads: numpy scalars and arrays
    become Python numbers and lists."""
    if isinstance(x, Mapping):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def full_leaves(state) -> Dict[str, Any]:
    """``state.state_dict()`` with every leaf whole: on a mesh the sharded
    ones gathered (a collective every rank calls)."""
    leaves = state.state_dict()
    layout = getattr(state, "layout", None)
    if layout is None:
        return leaves
    return {k: layout.full(param_of(k), v) if param_of(k) in layout.specs
            else v for k, v in leaves.items()}


def local_leaves(state, src: Mapping[str, Any]) -> Mapping[str, Any]:
    """Whole leaves (a file's) cut to ``state``'s blocks on a mesh."""
    layout = getattr(state, "layout", None)
    if layout is None:
        return src
    return {k: layout.local(param_of(k), v) if param_of(k) in layout.specs
            else v for k, v in src.items()}


def save_checkpoint(path: str, state, extra: Optional[Dict[str, Any]] = None,
                    write: bool = True) -> int:
    """Write ``state`` (a ``TrainState`` or a ``{name: tensor}`` mapping)
    and ``extra`` to ``path`` atomically; returns the file's bytes. On a
    mesh every rank calls it and only the one with ``write`` writes (0 is
    returned elsewhere)."""
    leaves = full_leaves(state) if hasattr(state, "state_dict") else state
    if not write:
        return 0
    payload = {"state": {k: v.detach().cpu() for k, v in leaves.items()},
               "extra": _plain(extra or {})}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return os.path.getsize(path)


def read_payload(path: str) -> Dict[str, Any]:
    """``{"state": {name: CPU tensor}, "extra": dict}``, memory-mapped."""
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True)


def load_checkpoint(path: str, state) -> Dict[str, Any]:
    """Restore ``state`` (a ``TrainState``) in place from ``path``; every
    leaf's name, shape and dtype is checked first. Returns ``extra``."""
    payload = read_payload(path)
    state.load_state_dict(local_leaves(state, payload["state"]))
    return payload.get("extra", {})


def load_eval_weights(path: str, state) -> Dict[str, Any]:
    """Algorithm-agnostic load for evaluation: only the model's parameters
    and buffers and the EMA shadow, whichever algorithm wrote the file (its
    optimizer, algorithm and SemiReward state are ignored). A name missing
    from the file also matches ``backbone.<name>``, as the JAX package's
    ``_graft_tree`` does for its wrapped nets. Returns ``extra``."""
    payload = read_payload(path)
    src = payload["state"]
    src = local_leaves(state, {k: v for k, v in src.items()
                               if k.startswith(("model.", "ema."))})
    live = {k: v for k, v in state.state_dict().items()
            if k.startswith(("model.", "ema."))}
    picked = {}
    for name in live:
        group, rest = name.split(".", 1)
        alt = f"{group}.backbone.{rest}"
        picked[name] = src[name] if name in src else src.get(alt)
        if picked[name] is None:
            raise ValueError(f"checkpoint is missing leaf '{name}' (has "
                             f"{sorted(src)[:8]}...)")
    check_leaves(picked, live, "eval weights")
    with torch.no_grad():
        for name, dst in live.items():
            dst.copy_(picked[name])
    return payload.get("extra", {})


def peek_extra(path: str) -> Dict[str, Any]:
    """Only the ``extra`` dict (it / eval / algorithm / best_*)."""
    return read_payload(path).get("extra", {})
