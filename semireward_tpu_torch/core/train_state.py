"""Training state (port of ``semireward_tpu/core/train_state.py``).

The JAX package threads one immutable pytree through a donated jitted step.
Here the state is a plain object whose tensors the step updates in place:
the model's parameters, the EMA shadow, the optimizer moments. The step
count is a host int, so every schedule and stage condition is a Python
branch that never waits for the device. BatchNorm running statistics (the
JAX package's ``batch_stats``) are model buffers that the forwards update
in place; the EMA shadows parameters only, and eval runs the EMA
parameters with the live running statistics, as the JAX package does.

``TrainState.state_dict()`` flattens every field to ``{name: tensor}``
(the checkpoint's payload); ``load_state_dict`` checks each leaf's name,
shape and dtype against the live state before it copies anything.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch
from torch import nn


@dataclass
class SRState:
    """SemiReward online-training state. The generator never moves: in the
    reference its output passes through ``.long()`` before reaching the
    rewarder, so no gradient reaches it."""

    rewarder: nn.Module
    rewarder_opt: Any                 # core.optim.Optimizer (Adam)
    rewarder_ema: Optional[List[torch.Tensor]]  # EMA shadow, None if sr_ema off
    generator: nn.Module
    max_reward: torch.Tensor          # f32 scalar on the device, init -inf


@dataclass
class TrainState:
    step: int
    model: nn.Module
    ema: List[torch.Tensor]           # EMA shadow of model.parameters()
    opt: Any                          # core.optim.Optimizer
    algo: Any                         # per-algorithm statistics
    sr: Optional[SRState]
    # the trainer's generator (augmentation, drop path, dropout): the JAX
    # state's ``rng``
    rng: Optional[torch.Generator] = None
    # where the parameters, EMA and moments live on a mesh
    # (parallel/mesh.py:Layout); None on one device
    layout: Any = None

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Every field as ``{name: tensor}``, the tensors the live ones
        (no copy), the generator's state as a uint8 tensor."""
        out = {"step": torch.tensor(self.step, dtype=torch.int64)}
        if self.rng is not None:
            out["rng"] = self.rng.get_state()
        _module_leaves("model.", self.model, out)
        names = [n for n, _ in self.model.named_parameters()]
        out.update(zip((f"ema.{n}" for n in names), self.ema))
        _prefixed("opt.", self.opt.state_dict(), out)
        _flatten("algo", self.algo, out)
        if self.sr is not None:
            sr = self.sr
            _module_leaves("sr.rewarder.", sr.rewarder, out)
            _prefixed("sr.rewarder_opt.", sr.rewarder_opt.state_dict(), out)
            if sr.rewarder_ema is not None:
                rnames = [n for n, _ in sr.rewarder.named_parameters()]
                out.update(zip((f"sr.rewarder_ema.{n}" for n in rnames),
                               sr.rewarder_ema))
            _module_leaves("sr.generator.", sr.generator, out)
            out["sr.max_reward"] = sr.max_reward
        return out

    @torch.no_grad()
    def load_state_dict(self, src: Mapping[str, torch.Tensor]) -> None:
        """Restore every field from ``src`` (a :meth:`state_dict`, on any
        device). Names, shapes and dtypes must match the live state leaf for
        leaf, or this raises naming the leaf and changes nothing."""
        live = self.state_dict()
        check_leaves(src, live)
        # parameters, buffers and EMA in place (the optimizers hold them);
        # the optimizers load themselves; the step count and the generator
        # by value; the algorithm state and max_reward, which the step
        # replaces rather than writes, as fresh tensors
        by_value = ("step", "rng", "opt.", "sr.rewarder_opt.", "algo",
                    "sr.max_reward")
        for name, dst in live.items():
            if not name.startswith(by_value):
                dst.copy_(src[name])
        self.step = int(src["step"])
        if self.rng is not None:
            self.rng.set_state(src["rng"].cpu())
        self.opt.load_state_dict({k[4:]: v for k, v in src.items()
                                  if k.startswith("opt.")})
        self.algo = _rebuild("algo", self.algo, src)
        if self.sr is not None:
            self.sr.rewarder_opt.load_state_dict(
                {k[16:]: v for k, v in src.items()
                 if k.startswith("sr.rewarder_opt.")})
            self.sr.max_reward = _fresh(self.sr.max_reward,
                                        src["sr.max_reward"])


def _prefixed(prefix: str, leaves: Mapping[str, torch.Tensor],
              out: Dict[str, torch.Tensor]) -> None:
    out.update((prefix + k, v) for k, v in leaves.items())


def _module_leaves(prefix: str, module: nn.Module,
                   out: Dict[str, torch.Tensor]) -> None:
    """Parameters and buffers (BatchNorm running statistics) by name."""
    _prefixed(prefix, module.state_dict(keep_vars=False), out)


def _fresh(like: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(like).copy_(value)


def _children(obj):
    """(name, child) pairs of an algorithm-state node: dataclass fields,
    NamedTuple fields, dict keys or tuple indices (an imbalanced-SSL
    wrapper's ``(base_state, imb_state)`` is ``algo.0.*`` / ``algo.1.*``)."""
    if isinstance(obj, dict):
        return list(obj.items())
    if dataclasses.is_dataclass(obj):
        return [(f.name, getattr(obj, f.name))
                for f in dataclasses.fields(obj)]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return list(zip(obj._fields, obj))
    if isinstance(obj, tuple):
        return [(str(i), v) for i, v in enumerate(obj)]
    raise TypeError(f"cannot flatten a {type(obj).__name__} state node")


def _flatten(prefix: str, obj, out: Dict[str, torch.Tensor]) -> None:
    """The tensors of the algorithm state as ``{prefix.path: tensor}``."""
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj
        return
    for name, child in _children(obj):
        _flatten(f"{prefix}.{name}", child, out)


def _rebuild(prefix: str, obj, src: Mapping[str, torch.Tensor]):
    """``obj``'s structure with each tensor leaf a fresh copy of
    ``src[prefix.path]`` on the live leaf's device."""
    if isinstance(obj, torch.Tensor):
        return _fresh(obj, src[prefix])
    new = {name: _rebuild(f"{prefix}.{name}", child, src)
           for name, child in _children(obj)}
    if isinstance(obj, dict):
        return new
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **new)
    if hasattr(obj, "_fields"):
        return obj._replace(**new)
    return tuple(new[str(i)] for i in range(len(obj)))


def check_leaves(src: Mapping[str, torch.Tensor],
                 live: Mapping[str, torch.Tensor], what: str = "state"
                 ) -> None:
    """Raise ``ValueError`` naming the first leaf of ``live`` that ``src``
    lacks or holds at another shape or dtype, or a leaf ``src`` has and
    ``live`` does not."""
    for name, dst in live.items():
        got = src.get(name)
        if got is None:
            raise ValueError(f"checkpoint {what} is missing leaf '{name}'")
        if tuple(got.shape) != tuple(dst.shape):
            raise ValueError(f"{what} leaf '{name}' shape {tuple(got.shape)}"
                             f" != expected {tuple(dst.shape)}")
        if got.dtype != dst.dtype:
            raise ValueError(f"{what} leaf '{name}' dtype {got.dtype} != "
                             f"expected {dst.dtype}")
    extra = sorted(set(src) - set(live))
    if extra:
        raise ValueError(f"checkpoint {what} has leaves the live state "
                         f"lacks: {extra[:8]}")


@torch.no_grad()
def tree_ema(shadow: Sequence[torch.Tensor], new: Sequence[torch.Tensor],
             decay: float) -> None:
    """shadow <- decay*shadow + (1-decay)*new, in place."""
    if decay == 0.0:
        torch._foreach_copy_(list(shadow), list(new))
        return
    torch._foreach_mul_(list(shadow), decay)
    torch._foreach_add_(list(shadow), list(new), alpha=1.0 - decay)
