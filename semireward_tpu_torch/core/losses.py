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
# regression losses (the JAX package's core/losses.py:70-136)
# ---------------------------------------------------------------------------

def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def l1_loss(logits, target, reduction="mean", **kw):
    return _reduce((logits - target).abs(), reduction)


def l2_loss(logits, target, reduction="mean", **kw):
    return _reduce((logits - target) ** 2, reduction)


def _focal_weight(logits, target, activate, beta, gamma):
    d = (logits - target).abs()
    if activate == "tanh":
        return torch.tanh(beta * d) ** gamma
    return (2.0 * torch.sigmoid(beta * d) - 1.0) ** gamma


def focal_l1_loss(logits, target, reduction="mean", activate="sigmoid",
                  beta=0.2, gamma=1.0, **kw):
    loss = (logits - target).abs() * _focal_weight(logits, target, activate,
                                                   beta, gamma)
    return _reduce(loss, reduction)


def focal_l2_loss(logits, target, reduction="mean", activate="sigmoid",
                  beta=0.2, gamma=1.0, **kw):
    loss = (logits - target) ** 2 * _focal_weight(logits, target, activate,
                                                  beta, gamma)
    return _reduce(loss, reduction)


def huber_loss(logits, target, reduction="mean", beta=1.0, **kw):
    l1 = (logits - target).abs()
    loss = torch.where(l1 < beta, 0.5 * l1 ** 2 / beta, l1 - 0.5 * beta)
    return _reduce(loss, reduction)


REG_LOSSES = {
    "l1_loss": l1_loss,
    "l2_loss": l2_loss,
    "focal_l1_loss": focal_l1_loss,
    "focal_l2_loss": focal_l2_loss,
    "huber_loss": huber_loss,
    # the configs' short names
    "l1": l1_loss,
    "l2": l2_loss,
    "mse": l2_loss,
    "huber": huber_loss,
}


def reg_loss(logits, targets, mode: str = "l1_loss", reduction: str = "mean",
             **kw):
    """Regression loss by name (``REG_LOSSES``), in float32 whatever the
    compute dtype, the targets reshaped to the logits."""
    logits = logits.float()
    targets = targets.reshape(logits.shape).float()
    return REG_LOSSES[mode](logits, targets, reduction=reduction, **kw)


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
