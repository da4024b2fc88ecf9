"""DARP (port of ``semireward_tpu/imb/darp.py``): distribution-aligned
refinement of pseudo-labels. ``pseudo_orig [N, C]`` holds each unlabeled
sample's last weak probabilities, written at ``idx_ulb`` every step (an
index drawn twice keeps its last row, ``common.write_last``). Past
``darp_warmup_epochs``, every ``darp_num_refine_iter`` steps the whole
matrix is refined toward the target class counts (``estimate_pseudo``,
then ``opt_solver``: an entropy-regularized transport solved by Newton's
method with its analytic derivative, ``iter_T`` outer iterations of 30
Newton steps over all classes at once, float32, the JAX package's fixed
counts), and the base's unsupervised loss is recomputed against the
refined rows of the batch. All of it stays on the device."""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.imb.base import ImbAlgorithm
from semireward_tpu_torch.registry import IMB_ALGORITHMS

NEWTON_STEPS = 30


@dataclass
class DARPState:
    pseudo_orig: torch.Tensor    # [N, C]
    pseudo_refine: torch.Tensor  # [N, C]


def estimate_pseudo(q_y, saved_q, alpha: float, num_classes: int):
    """Per class: the sum of the ``int(alpha * q_y[c])`` largest
    probabilities of column c; returns ``(q_y + 1e-6) / (that + 1e-6)``."""
    N = saved_q.shape[0]
    num = (alpha * q_y).to(torch.int32).long()              # [C]
    sorted_q = saved_q.sort(0, descending=True).values      # [N, C]
    take = torch.arange(N, device=saved_q.device)[:, None] < num[None, :]
    k_probs = (sorted_q * take).sum(0)
    return (q_y + 1e-6) / (k_probs + 1e-6)


def opt_solver(probs, target_distb, num_iter: int = 10,
               num_newton: int = NEWTON_STEPS):
    """The rows of ``A_e X Y`` (``A_e = probs / e``) whose column sums meet
    ``target_distb``: ``num_iter`` outer iterations, each ``num_newton``
    Newton steps on ``y`` and one closed-form step on ``x``."""
    probs = probs.float()
    entropy = (-probs * torch.log(probs + 1e-6)).sum(1)
    w = 1.0 / entropy                                        # [N]
    A_e = probs / math.e
    c = target_distb.float()
    r = torch.ones(probs.shape[0], device=probs.device)
    inv_w = (-1.0 / w)[:, None]
    y = torch.zeros(probs.shape[1], device=probs.device)
    X = r / (A_e * torch.exp(-torch.zeros_like(y)[None, :]
                             / w[:, None])).sum(1)
    for _ in range(num_iter):
        B = A_e * X[:, None]
        for _ in range(num_newton):
            E = torch.exp(-y[None, :] / w[:, None])
            f = (B * E).sum(0) - c
            fp = (B * E * inv_w).sum(0)
            y = y - f / torch.where(fp.abs() > 1e-12, fp,
                                    torch.full_like(fp, 1e-12))
        X = r / (A_e * torch.exp(-y[None, :] / w[:, None])).sum(1)
    return A_e * X[:, None] * torch.exp(-y[None, :] / w[:, None])


@IMB_ALGORITHMS.register("darp")
class DARP(ImbAlgorithm):
    NAME = "darp"
    DEFAULTS = {"darp_warmup_epochs": 200, "darp_alpha": 2.0,
                "darp_iter_T": 10, "darp_num_refine_iter": 10}
    READS_FWD = True

    def __init__(self, cfg, data_info=None, device=None, base_cls=None):
        super().__init__(cfg, data_info, device, base_cls)
        x = cfg.extra
        self.warmup_epochs = int(x.get("darp_warmup_epochs", 200))
        self.alpha = float(x.get("darp_alpha", 2.0))
        self.iter_T = int(x.get("darp_iter_T", 10))
        self.num_refine_iter = int(x.get("darp_num_refine_iter", 10))
        dist = np.asarray(self.data_info.get(
            "lb_class_dist", np.full(cfg.num_classes, 1 / cfg.num_classes)))
        self.target_disb = self._const(
            dist * self.data_info.get("ulb_dest_len", 1) / dist.sum())
        self.BATCH_KEYS = tuple(dict.fromkeys(self.BATCH_KEYS + ("idx_ulb",)))

    def init_imb_state(self):
        N = self.data_info.get("ulb_dest_len", 1)
        n = self.cfg.num_classes
        u = torch.full((N, n), 1.0 / n, device=self.device)
        return DARPState(pseudo_orig=u, pseudo_refine=u.clone())

    def refine(self, pseudo_orig):
        weights_u = estimate_pseudo(self.target_disb, pseudo_orig, self.alpha,
                                    self.cfg.num_classes)
        scaled = pseudo_orig * (pseudo_orig * weights_u[None, :]) + 1e-6
        scaled = scaled / scaled.sum(1, keepdim=True)
        return opt_solver(scaled, self.target_disb, self.iter_T)

    def loss(self, ctx):
        st: DARPState = ctx.algo_state[1]
        self._cell = {}
        out = self.base_loss(ctx, st)
        idx = ctx.batch["idx_ulb"].long()
        with torch.no_grad():
            probs_w = self.base.compute_prob(out.fwd.logits_x_ulb_w.detach())
            pseudo_orig = C.write_last(st.pseudo_orig, 0, idx, probs_w)
            past_warmup = self.epoch_of(ctx.step) > self.warmup_epochs
            pseudo_refine = st.pseudo_refine
            if past_warmup and ctx.step % self.num_refine_iter == 0:
                pseudo_refine = self.refine(pseudo_orig)
            refined = pseudo_refine[idx]
            refined = refined / refined.sum(1, keepdim=True).clamp(min=1e-12)
        pl = out.pseudo_label
        if pl is not None and out.mask is not None and past_warmup:
            target = (refined if pl.is_floating_point()
                      else refined.argmax(-1))
            unsup = self.base.consistency_loss(out.fwd.logits_x_ulb_s, target,
                                               "ce", mask=out.mask)
            total = out.total_loss + out.unsup_weight * (unsup
                                                         - out.unsup_loss)
            out = out._replace(total_loss=total, unsup_loss=unsup,
                               metrics={**out.metrics, "total_loss": total,
                                        "unsup_loss": unsup})
        new_imb = DARPState(pseudo_orig=pseudo_orig,
                            pseudo_refine=pseudo_refine)
        return out._replace(new_algo_state=(out.new_algo_state, new_imb))
