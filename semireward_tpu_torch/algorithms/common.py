"""Shared SSL building blocks (port of the parts of
``semireward_tpu/algorithms/common.py`` that FixMatch and FlexMatch use).

State updates are functional (they return new tensors) and stay on the
device: no step reads a value back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class ForwardOut(NamedTuple):
    logits_x_lb: torch.Tensor
    logits_x_ulb_w: torch.Tensor
    logits_x_ulb_s: torch.Tensor
    feats_x_lb: torch.Tensor
    feats_x_ulb_w: torch.Tensor
    feats_x_ulb_s: torch.Tensor


def batch_dim(x) -> int:
    """Rows of a view: an image tensor or a dict of token tensors."""
    return (next(iter(x.values())) if isinstance(x, dict) else x).shape[0]


def cat_views(*xs):
    """Concatenate views along the batch; token dicts key by key (the JAX
    package's pytree concat)."""
    if isinstance(xs[0], dict):
        return {k: torch.cat([x[k] for x in xs]) for k in xs[0]}
    return torch.cat(xs)


def ssl_forward(model, x_lb, x_ulb_w, x_ulb_s, generator=None,
                train: bool = True, use_cat: bool = True,
                stop_grad_w: bool = True) -> ForwardOut:
    """Concat [x_lb, x_ulb_w, x_ulb_s] -> one model pass -> split. Views
    are image tensors or token dicts. ``use_cat=False`` runs three passes,
    the weak one without gradient; each draws its own dropout from the
    generator's stream."""
    n_lb, n_ulb = batch_dim(x_lb), batch_dim(x_ulb_w)
    if use_cat:
        out = model(cat_views(x_lb, x_ulb_w, x_ulb_s), train=train,
                    generator=generator)
        l_lb, l_w, l_s = torch.split(out["logits"], [n_lb, n_ulb, n_ulb])
        f_lb, f_w, f_s = torch.split(out["feat"], [n_lb, n_ulb, n_ulb])
    else:
        o_lb = model(x_lb, train=train, generator=generator)
        o_s = model(x_ulb_s, train=train, generator=generator)
        with torch.no_grad():
            o_w = model(x_ulb_w, train=train, generator=generator)
        l_lb, f_lb = o_lb["logits"], o_lb["feat"]
        l_s, f_s = o_s["logits"], o_s["feat"]
        l_w, f_w = o_w["logits"], o_w["feat"]
    if stop_grad_w:
        l_w, f_w = l_w.detach(), f_w.detach()
    return ForwardOut(l_lb, l_w, l_s, f_lb, f_w, f_s)


def compute_prob(logits):
    return F.softmax(logits.float(), dim=-1)


def fixed_threshold_mask(probs, p_cutoff: float):
    return (probs.max(-1).values >= p_cutoff).to(probs.dtype)


# ---------------------------------------------------------------------------
# FlexMatch curriculum pseudo labeling
# ---------------------------------------------------------------------------

@dataclass
class FlexState:
    selected_label: torch.Tensor  # int64 [ulb_dest_len], init -1
    classwise_acc: torch.Tensor   # f32 [num_classes], init 0


def flex_init(ulb_dest_len: int, num_classes: int, device=None) -> FlexState:
    return FlexState(
        selected_label=torch.full((ulb_dest_len,), -1, dtype=torch.long,
                                  device=device),
        classwise_acc=torch.zeros(num_classes, dtype=torch.float32,
                                  device=device))


def flex_mask(state: FlexState, probs, idx_ulb, p_cutoff: float,
              thresh_warmup: bool = True) -> Tuple[FlexState, torch.Tensor]:
    """Mask with the convex curriculum threshold (from the PREVIOUS
    ``classwise_acc``), then set ``selected_label[idx_ulb[select]]`` and
    recompute ``classwise_acc`` from the label counts."""
    n = state.selected_label.shape[0]
    num_classes = state.classwise_acc.shape[0]
    max_probs, max_idx = probs.max(-1)
    acc = state.classwise_acc[max_idx]
    mask = (max_probs >= p_cutoff * (acc / (2.0 - acc))).to(probs.dtype)
    select = max_probs >= p_cutoff

    # unselected rows write to a spare slot past the end (JAX's mode="drop")
    upd_idx = torch.where(select, idx_ulb.long(), torch.full_like(max_idx, n))
    ext = torch.cat([state.selected_label,
                     state.selected_label.new_full((1,), -1)])
    selected = ext.scatter(0, upd_idx, max_idx)[:n]

    counts = torch.zeros(num_classes + 1, dtype=torch.long,
                         device=selected.device).scatter_add_(
        0, selected + 1, torch.ones_like(selected))
    count_all_max = counts.max()
    denom = count_all_max if thresh_warmup else counts[1:].max()
    new_acc = counts[1:].float() / denom.clamp(min=1).float()
    # no update while every entry still holds the same value
    new_acc = torch.where(count_all_max < n, new_acc, state.classwise_acc)
    return FlexState(selected_label=selected, classwise_acc=new_acc), mask
