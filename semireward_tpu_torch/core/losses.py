"""Losses (port of ``semireward_tpu/core/losses.py``).

Every loss upcasts to float32 before the log-softmax and the reductions,
whatever the compute dtype, so masking thresholds stay exact.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def ce_loss(logits, targets, reduction: str = "none"):
    """Cross-entropy with hard (int [B]) or soft ([B, C]) targets."""
    log_pred = F.log_softmax(logits.float(), dim=-1)
    if logits.shape == targets.shape:
        nll = -(targets.float() * log_pred).sum(-1)
    else:
        nll = -log_pred.gather(-1, targets.long().unsqueeze(-1)).squeeze(-1)
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def consistency_loss(logits, targets, name: str = "ce",
                     mask: Optional[torch.Tensor] = None,
                     mask2: Optional[torch.Tensor] = None):
    """Consistency loss; ``mask`` is the confidence mask, ``mask2`` the
    SemiReward reward filter. The mean runs over the whole batch, masked-out
    entries included."""
    if name not in ("ce", "mse", "l1"):
        raise ValueError(f"unknown consistency loss '{name}'")
    if name == "mse":
        loss = ((F.softmax(logits.float(), -1) - targets.float()) ** 2).mean(-1)
    elif name == "l1":
        loss = (logits.float() - targets.float()).abs().mean(-1)
    else:
        loss = ce_loss(logits, targets, reduction="none")
    if mask is not None:
        loss = loss * mask.to(loss.dtype)
    if mask2 is not None:
        loss = loss * mask2.to(loss.dtype)
    return loss.mean()


# ---------------------------------------------------------------------------
# pseudo-label targets
# ---------------------------------------------------------------------------

def smooth_targets(logits, targets, smoothing: float = 0.1):
    n_cls = logits.shape[-1]
    off = smoothing / (n_cls - 1)
    return F.one_hot(targets.long(), n_cls).float() * (1.0 - smoothing - off) + off


def gen_ulb_targets(logits, use_hard_label: bool = True, T: float = 1.0,
                    softmax: bool = True, label_smoothing: float = 0.0):
    """Pseudo labels from ``logits`` (or probabilities with
    ``softmax=False``): int labels when hard, else probability vectors."""
    logits = logits.detach().float()
    if use_hard_label:
        pseudo = logits.argmax(-1)
        if label_smoothing > 0:
            return smooth_targets(logits, pseudo, label_smoothing)
        return pseudo
    if softmax:
        return F.softmax(logits / T, dim=-1)
    return logits
