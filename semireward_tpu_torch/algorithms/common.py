"""Shared SSL building blocks (port of the parts of
``semireward_tpu/algorithms/common.py`` that the ported algorithms use).

State updates are functional (they return new tensors) and stay on the
device: no step reads a value back to the host. Under an active mesh
(``parallel/mesh.py``) the state updates read the global batch: FlexMatch's
``flex_mask`` writes the selections of every batch rank, all-gathered in
global row order (``concat_all_gather``, no gradient), so that
``selected_label`` and ``classwise_acc`` are the same on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from semireward_tpu_torch import rng
from semireward_tpu_torch.models.batchnorm import frozen_bn
from semireward_tpu_torch.parallel.mesh import concat_all_gather


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
    each drawing its own dropout from the generator's stream. BatchNorm, as
    in the JAX package: with ``use_cat`` the one pass updates the running
    statistics over every row; without it the lb pass and then the strong
    pass update them, and the weak pass (no gradient) normalizes by its own
    batch moments and leaves them as they were."""
    n_lb, n_ulb = batch_dim(x_lb), batch_dim(x_ulb_w)
    if use_cat:
        out = model(cat_views(x_lb, x_ulb_w, x_ulb_s), train=train,
                    generator=generator)
        l_lb, l_w, l_s = torch.split(out["logits"], [n_lb, n_ulb, n_ulb])
        f_lb, f_w, f_s = torch.split(out["feat"], [n_lb, n_ulb, n_ulb])
    else:
        o_lb = model(x_lb, train=train, generator=generator)
        o_s = model(x_ulb_s, train=train, generator=generator)
        with torch.no_grad(), frozen_bn(model):
            o_w = model(x_ulb_w, train=train, generator=generator)
        l_lb, f_lb = o_lb["logits"], o_lb["feat"]
        l_s, f_s = o_s["logits"], o_s["feat"]
        l_w, f_w = o_w["logits"], o_w["feat"]
    if stop_grad_w:
        l_w, f_w = l_w.detach(), f_w.detach()
    return ForwardOut(l_lb, l_w, l_s, f_lb, f_w, f_s)


def write_last(dst, dim: int, idx, src):
    """``dst.index_copy(dim, idx, src)`` where an index that repeats keeps
    its last row, on every device (CUDA leaves the winner of a repeated
    ``index_copy`` or ``scatter`` undefined; the CPU and the JAX package's
    ``.at[].set`` keep the last). Each index's last position comes from an
    order-free ``scatter_reduce(amax)``; every other row is sent to a
    spare slot past the end, which is dropped, so no index is written
    twice. ``idx`` may name that spare slot (``dst.shape[dim]``) for a row
    that is not to be written."""
    n = dst.shape[dim]
    idx = idx.long()
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((n + 1,), -1, dtype=torch.long,
                      device=idx.device).scatter_reduce(0, idx, pos, "amax")
    tgt = torch.where(last[idx] == pos, idx, torch.full_like(idx, n))
    spare = list(dst.shape)
    spare[dim] = 1
    ext = torch.cat([dst, dst.new_zeros(spare)], dim)
    return ext.index_copy(dim, tgt, src.to(dst.dtype)).narrow(dim, 0, n)


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

    # unselected rows write to a spare slot past the end (JAX's mode="drop");
    # an index drawn twice keeps its last selected row
    upd_idx = torch.where(select, idx_ulb.long(), torch.full_like(max_idx, n))
    # every batch rank's rows in global order (the last of a repeated index
    # is the last in that order)
    selected = write_last(state.selected_label, 0, concat_all_gather(upd_idx),
                          concat_all_gather(max_idx))

    counts = torch.zeros(num_classes + 1, dtype=torch.long,
                         device=selected.device).scatter_add_(
        0, selected + 1, torch.ones_like(selected))
    count_all_max = counts.max()
    denom = count_all_max if thresh_warmup else counts[1:].max()
    new_acc = counts[1:].float() / denom.clamp(min=1).float()
    # no update while every entry still holds the same value
    new_acc = torch.where(count_all_max < n, new_acc, state.classwise_acc)
    return FlexState(selected_label=selected, classwise_acc=new_acc), mask


# ---------------------------------------------------------------------------
# EMA statistics applied n times toward fixed targets (the SemiReward remask)
# ---------------------------------------------------------------------------

def ema_repeat(s0, t, momentum: float, n: int = 1):
    """``n`` steps of ``s <- s * m + (1 - m) * t`` with ``t`` fixed, in
    closed form: ``a^n s0 + b (1 - a^n) / (1 - a) t``. ``a`` and ``b`` are
    ``m`` and ``1 - m`` as float32 holds them (the step's own constants; a
    float32 ``a + b`` is not 1), and the powers are taken in float64 on the
    host. At n = 1 this is the single step, term for term. A float32
    loop stalls up to ~ulp / (1 - m) from its fixed point, so after
    thousands of steps it sits up to ~1e-4 of the value away from this
    exact recurrence."""
    a = float(np.float32(momentum))
    b = float(np.float32(1.0 - momentum))
    an = a ** n
    return s0 * an + t * (b * ((1.0 - an) / (1.0 - a)))


# ---------------------------------------------------------------------------
# FreeMatch self-adaptive thresholding
# ---------------------------------------------------------------------------

@dataclass
class FreeState:
    p_model: torch.Tensor     # f32 [C]
    label_hist: torch.Tensor  # f32 [C]
    time_p: torch.Tensor      # f32 scalar


def free_init(num_classes: int, device=None) -> FreeState:
    u = torch.ones(num_classes, dtype=torch.float32, device=device) / num_classes
    return FreeState(p_model=u, label_hist=u.clone(), time_p=u.mean())


def free_mask(state: FreeState, probs, momentum: float = 0.999,
              use_quantile: bool = False, clip_thresh: bool = False,
              repeat: int = 1) -> Tuple[FreeState, torch.Tensor]:
    """EMA updates of (time_p, p_model, label_hist) toward this batch's
    statistics, ``repeat`` times on the same ``probs`` (``ema_repeat``),
    then the mask from the UPDATED statistics. The iterates move
    monotonically, so clipping ``time_p`` once at the end equals clipping
    it at every step."""
    max_probs, max_idx = probs.max(-1)
    stat = (torch.quantile(max_probs, 0.8) if use_quantile
            else max_probs.mean())
    hist = torch.bincount(max_idx, minlength=probs.shape[-1]).float()
    time_p = ema_repeat(state.time_p, stat, momentum, repeat)
    if clip_thresh:
        time_p = time_p.clamp(0.0, 0.95)
    new = FreeState(
        p_model=ema_repeat(state.p_model, probs.mean(0), momentum, repeat),
        label_hist=ema_repeat(state.label_hist, hist / hist.sum(), momentum,
                              repeat),
        time_p=time_p)
    mod = new.p_model / new.p_model.max()
    return new, (max_probs >= new.time_p * mod[max_idx]).to(probs.dtype)


def free_entropy_loss(mask, logits_s, p_model, label_hist):
    """FreeMatch's self-adaptive fairness loss. The reference indexes
    ``logits_s[mask]``; here the select is a mask-weighted sum, and the loss
    is 0 when the mask selects nothing."""
    logits_s = logits_s.float()
    maskf = mask.float()
    n_sel = maskf.sum()
    prob_s = F.softmax(logits_s, dim=-1)
    pred_s = prob_s.argmax(-1)
    n_cls = logits_s.shape[-1]
    hist_s = torch.zeros(n_cls, dtype=torch.float32,
                         device=logits_s.device).index_add_(0, pred_s,
                                                            maskf.detach())
    hist_s_n = hist_s / hist_s.sum().clamp(min=1e-12)

    def inv0(x):
        return torch.where(x == 0, torch.zeros_like(x),
                           1.0 / x.clamp(min=1e-30))

    mod_pm = p_model.reshape(1, -1) * inv0(label_hist.reshape(1, -1))
    mod_pm = mod_pm / mod_pm.sum(-1, keepdim=True)
    mean_prob_s = ((prob_s * maskf[:, None]).sum(0)
                   / n_sel.clamp(min=1e-12))
    mod_mp = mean_prob_s.reshape(1, -1) * inv0(hist_s_n.reshape(1, -1))
    mod_mp = mod_mp / mod_mp.sum(-1, keepdim=True).clamp(min=1e-12)
    loss = (mod_pm * torch.log(mod_mp + 1e-12)).sum(1).mean()
    return torch.where(n_sel > 0, loss, torch.zeros_like(loss))


# ---------------------------------------------------------------------------
# SoftMatch truncated-Gaussian weighting
# ---------------------------------------------------------------------------

@dataclass
class SoftMatchState:
    prob_max_mu_t: torch.Tensor   # f32 scalar, or [C] with per_class
    prob_max_var_t: torch.Tensor


def softmatch_init(num_classes: int, per_class: bool = False,
                   device=None) -> SoftMatchState:
    if per_class:
        return SoftMatchState(
            prob_max_mu_t=torch.ones(num_classes, device=device) / num_classes,
            prob_max_var_t=torch.ones(num_classes, device=device))
    return SoftMatchState(
        prob_max_mu_t=torch.tensor(1.0 / num_classes, device=device),
        prob_max_var_t=torch.tensor(1.0, device=device))


def _softmatch_targets(probs, n_cls: int, per_class: bool):
    """Batch mean and unbiased variance of the max probability, globally or
    per argmax class (a class with at most one sample targets (0, 1))."""
    max_probs, max_idx = probs.max(-1)
    if not per_class:
        return max_probs, max_idx, max_probs.mean(), max_probs.var(
            correction=1)
    onehot = F.one_hot(max_idx, n_cls).float()
    cnt = onehot.sum(0)
    s1 = (onehot * max_probs[:, None]).sum(0)
    s2 = (onehot * (max_probs ** 2)[:, None]).sum(0)
    mean_c = s1 / cnt.clamp(min=1.0)
    var_c = (s2 - cnt * mean_c ** 2) / (cnt - 1.0).clamp(min=1.0)
    mu_t = torch.where(cnt > 1, mean_c, torch.zeros_like(mean_c))
    var_t = torch.where(cnt > 1, var_c, torch.ones_like(var_c))
    return max_probs, max_idx, mu_t, var_t


def softmatch_mask(state: SoftMatchState, probs, n_sigma: float = 2.0,
                   momentum: float = 0.999, per_class: bool = False,
                   repeat: int = 1) -> Tuple[SoftMatchState, torch.Tensor]:
    """EMA updates of (mu, var), ``repeat`` times on the same ``probs``
    (``ema_repeat``), then the weights from the updated statistics: 1 above
    mu, a Gaussian falloff below."""
    max_probs, max_idx, mu_t, var_t = _softmatch_targets(
        probs, state.prob_max_mu_t.numel() if per_class else 0, per_class)
    new = SoftMatchState(ema_repeat(state.prob_max_mu_t, mu_t, momentum,
                                    repeat),
                         ema_repeat(state.prob_max_var_t, var_t, momentum,
                                    repeat))
    return new, softmatch_weights(new, max_probs, max_idx, n_sigma,
                                  per_class).to(probs.dtype)


def softmatch_weights(state: SoftMatchState, max_probs, max_idx,
                      n_sigma: float = 2.0, per_class: bool = False):
    mu, var = state.prob_max_mu_t, state.prob_max_var_t
    if per_class:
        mu, var = mu[max_idx], var[max_idx]
    diff = (max_probs - mu).clamp(max=0.0)
    return torch.exp(-(diff ** 2) / (2 * var / (n_sigma ** 2)))


# ---------------------------------------------------------------------------
# Distribution alignment, EMA form
# ---------------------------------------------------------------------------

@dataclass
class DistAlignEMAState:
    p_target: torch.Tensor
    p_model: torch.Tensor
    initialized: torch.Tensor  # bool scalar: p_model starts as the plain mean


def dist_align_ema_init(num_classes: int,
                        p_target: Optional[torch.Tensor] = None,
                        update_target: bool = False, device=None
                        ) -> Tuple[DistAlignEMAState, bool]:
    if p_target is None:
        p_target = torch.ones(num_classes, device=device) / num_classes
    state = DistAlignEMAState(
        p_target=p_target.float().to(device),
        p_model=torch.zeros(num_classes, device=device),
        initialized=torch.zeros((), dtype=torch.bool, device=device))
    return state, update_target


def dist_align_ema(state: DistAlignEMAState, probs_x_ulb,
                   probs_x_lb=None, momentum: float = 0.999,
                   update_target: bool = False
                   ) -> Tuple[DistAlignEMAState, torch.Tensor]:
    m = momentum
    mean_ulb = probs_x_ulb.mean(0)
    p_model = torch.where(state.initialized,
                          state.p_model * m + mean_ulb * (1 - m), mean_ulb)
    p_target = state.p_target
    if update_target:
        p_target = p_target * m + probs_x_lb.mean(0) * (1 - m)
    # the state keeps values only; the aligned probs keep the gradient
    new = replace(state, p_target=p_target.detach(), p_model=p_model,
                  initialized=torch.ones_like(state.initialized))
    aligned = probs_x_ulb * (p_target + 1e-6) / (p_model + 1e-6)
    return new, aligned / aligned.sum(-1, keepdim=True)


# ---------------------------------------------------------------------------
# Distribution alignment, queue form (CoMatch, SimMatch)
# ---------------------------------------------------------------------------

@dataclass
class DistAlignQueueState:
    p_target: torch.Tensor      # [L, C]
    p_model: torch.Tensor       # [L, C]
    p_model_ptr: torch.Tensor   # int64 scalar
    p_target_ptr: torch.Tensor  # int64 scalar, -1: a fixed target


def dist_align_queue_init(num_classes: int, queue_length: int = 128,
                          p_target_type: str = "uniform",
                          p_target: Optional[torch.Tensor] = None,
                          device=None) -> DistAlignQueueState:
    """Rings of ``queue_length`` rows. ``p_target_type``: ``uniform`` (a
    fixed uniform target), ``model`` (the target tracks the labeled
    batches' mean probabilities, from zeros) or any other name with
    ``p_target`` (that fixed distribution)."""
    if p_target_type == "uniform":
        tgt = torch.full((queue_length, num_classes), 1.0 / num_classes,
                         device=device)
        tptr = -1
    elif p_target_type == "model":
        tgt = torch.zeros(queue_length, num_classes, device=device)
        tptr = 0
    else:
        tgt = p_target.reshape(1, -1).float().to(device).repeat(
            queue_length, 1)
        tptr = -1
    return DistAlignQueueState(
        p_target=tgt,
        p_model=torch.zeros(queue_length, num_classes, device=device),
        p_model_ptr=torch.zeros((), dtype=torch.long, device=device),
        p_target_ptr=torch.full((), tptr, dtype=torch.long, device=device))


def dist_align_queue(state: DistAlignQueueState, probs_x_ulb,
                     probs_x_lb=None
                     ) -> Tuple[DistAlignQueueState, torch.Tensor]:
    """Write this batch's mean unlabeled probabilities at ``p_model_ptr``
    (and, with ``probs_x_lb`` and a tracking target, the labeled ones at
    ``p_target_ptr``), advance the pointers round the ring, then scale
    ``probs_x_ulb`` by the ratio of the rings' means, renormalized. The
    pointers stay on the device."""
    L = state.p_model.shape[0]
    row = probs_x_ulb.detach().mean(0, keepdim=True)
    p_model = state.p_model.index_copy(0, state.p_model_ptr.reshape(1), row)
    p_model_ptr = (state.p_model_ptr + 1) % L
    p_target, p_target_ptr = state.p_target, state.p_target_ptr
    if probs_x_lb is not None:
        track = p_target_ptr >= 0
        upd = p_target.index_copy(0, p_target_ptr.clamp(min=0).reshape(1),
                                  probs_x_lb.detach().mean(0, keepdim=True))
        p_target = torch.where(track, upd, p_target)
        p_target_ptr = torch.where(track, (p_target_ptr + 1) % L,
                                   p_target_ptr)
    new = DistAlignQueueState(p_target, p_model, p_model_ptr, p_target_ptr)
    aligned = (probs_x_ulb * (p_target.mean(0) + 1e-6)
               / (p_model.mean(0) + 1e-6))
    return new, aligned / aligned.sum(-1, keepdim=True)


# ---------------------------------------------------------------------------
# MixUp and the reference's interleave
# ---------------------------------------------------------------------------

def interleave(xy, batch: int):
    """Swap the i-th of ``len(xy)`` near-equal row groups between part 0 and
    part i (the reference marks it unused; kept for parity)."""
    nu = len(xy) - 1
    groups = [batch // (nu + 1)] * (nu + 1)
    for x in range(batch - sum(groups)):
        groups[-x - 1] += 1
    offsets = [0]
    for g in groups:
        offsets.append(offsets[-1] + g)
    xy = [[v[offsets[p]:offsets[p + 1]] for p in range(nu + 1)] for v in xy]
    for i in range(1, nu + 1):
        xy[0][i], xy[i][i] = xy[i][i], xy[0][i]
    return [torch.cat(v, 0) for v in xy]


def draw_mixup(n: int, alpha: float, is_bias: bool = False,
               generator: Optional[torch.Generator] = None, device=None):
    """The draws of one MixUp on the device: ``lam ~ Beta(alpha, alpha)``
    (1 when ``alpha`` is 0; ``max(lam, 1 - lam)`` with ``is_bias``) as a
    float32 scalar, and a permutation of the ``n`` rows."""
    if alpha > 0:
        conc = torch.full((2,), float(alpha), device=device)
        lam = rng.dirichlet(conc, generator)[0]
    else:
        lam = torch.ones((), device=device)
    if is_bias:
        lam = torch.maximum(lam, 1 - lam)
    return lam, rng.randperm(n, generator=generator, device=device)


def mixup_one_target(x, y, lam, index):
    """``lam * x + (1 - lam) * x[index]``, the same for the targets ``y``."""
    return (lam * x + (1 - lam) * x[index], lam * y + (1 - lam) * y[index])
