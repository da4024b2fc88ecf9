"""TRAS (port of ``semireward_tpu/imb/tras.py``): an auxiliary head
(``AuxHeadNet``) trained with the logit-adjusted CE (``la = log
dist^tro``) and a temperature KL from the main head's adjusted weak
logits, once the warm-up epochs are over; evaluation switches to the
auxiliary head then (``eval_out_key``). ``compute_prob`` is logit-adjusted
everywhere. FixMatch only."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.core.losses import ce_loss, gen_ulb_targets
from semireward_tpu_torch.imb.abc import aux_logits_of
from semireward_tpu_torch.imb.base import ImbAlgorithm
from semireward_tpu_torch.models.wrappers import AuxHeadNet
from semireward_tpu_torch.registry import IMB_ALGORITHMS


def tras_kl_loss(outputs, targets, T: float, mask):
    """``-mean(sum q log p * mask) T^2``, ``p`` the outputs at T and ``q``
    the targets at 2T."""
    p = F.log_softmax(outputs.float() / T, dim=1)
    q = F.softmax(targets.float() / (T * 2), dim=1)
    return -torch.mean((q * p).sum(1) * mask) * T * T


@IMB_ALGORITHMS.register("tras")
class TRAS(ImbAlgorithm):
    NAME = "tras"
    DEFAULTS = {"tras_warmup_epochs": 10, "tras_A": 2, "tras_B": 2,
                "tras_tro": 1.0}
    SUPPORTED_BASES = ("fixmatch",)
    READS_FWD = True

    def __init__(self, cfg, data_info=None, device=None, base_cls=None):
        super().__init__(cfg, data_info, device, base_cls)
        x = cfg.extra
        self.A = float(x.get("tras_A", 2))
        self.B = float(x.get("tras_B", 2))
        self.tro = float(x.get("tras_tro", 1.0))
        self.warmup_epochs = int(x.get("tras_warmup_epochs", 10))
        cnt = self.lb_class_counts()
        dist = self._const(cnt.min() / cnt)
        self.la = torch.log(dist ** self.tro + 1e-12)
        self.T_logit = self.A * F.softmax(-self.la, dim=0) + self.B

    def eval_out_key(self, step: int) -> str:
        return ("logits" if self.epoch_of(step) < self.warmup_epochs
                else "logits_aux")

    def wrap_model(self, model, generator=None):
        return AuxHeadNet(self.base.wrap_model(model, generator),
                          self.cfg.num_classes, generator)

    def override_names(self):
        return ("compute_prob",)

    def imb_compute_prob(self, logits):
        return C.compute_prob(logits.float() - self.la)

    def post_loss(self, out, imb_state, ctx):
        if self.epoch_of(ctx.step) < self.warmup_epochs:
            # the JAX package computes the term and multiplies it by 0
            zero = torch.zeros((), device=out.total_loss.device)
            return self._add_loss(out, zero, "tras_loss", zero)
        cfg = self.cfg
        logits_lb, logits_s, logits_w = aux_logits_of(ctx, out.fwd)
        sup = ce_loss(logits_lb + self.la, ctx.batch["y_lb"], "mean")
        probs_w = F.softmax(logits_w.float(), dim=-1)
        mask = C.fixed_threshold_mask(probs_w, cfg.p_cutoff)
        pl = gen_ulb_targets(probs_w, use_hard_label=cfg.hard_label, T=cfg.T,
                             softmax=False)
        pl = pl if not pl.is_floating_point() else pl.argmax(-1)
        la_u = self.la[None, :] * self.T_logit[pl][:, None]
        unsup = tras_kl_loss(logits_s, logits_w - la_u, 1.0, mask)
        tras_loss = sup + unsup
        return self._add_loss(out, tras_loss, "tras_loss", tras_loss)
