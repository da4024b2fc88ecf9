"""ABC (port of ``semireward_tpu/imb/abc.py``): an auxiliary balanced
classifier (``models/wrappers.py:AuxHeadNet``) trained on the features of
the base's forward with Bernoulli class-balancing masks: the labeled rows
kept with probability ``min count / count``, the unlabeled ones above
``abc_p_cutoff`` kept with a probability that anneals from 1 toward the
same ratios over the epochs. Its loss is added to the base's; evaluation
reads the auxiliary head (``EVAL_OUT_KEY``). The Bernoulli draws compare
uniforms from ``draw_uniform`` (the JAX package: ``uniform < p``)."""
from __future__ import annotations

import torch

from semireward_tpu_torch import rng
from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.core.losses import ce_loss
from semireward_tpu_torch.imb.base import ImbAlgorithm
from semireward_tpu_torch.models.wrappers import AuxHeadNet
from semireward_tpu_torch.registry import IMB_ALGORITHMS


def draw_uniform(n: int, generator=None, device=None):
    """``n`` uniforms in [0, 1), float32, from ``generator``."""
    return rng.rand(n, generator=generator, device=device)


def aux_logits_of(ctx, fwd):
    """The auxiliary head over the base forward's features: labeled and
    strong with their gradient, weak without."""
    aux = ctx.model.aux
    with torch.no_grad():
        logits_w = aux(fwd.feats_x_ulb_w.detach())
    return aux(fwd.feats_x_lb), aux(fwd.feats_x_ulb_s), logits_w


@IMB_ALGORITHMS.register("abc")
class ABC(ImbAlgorithm):
    NAME = "abc"
    DEFAULTS = {"abc_p_cutoff": 0.95, "abc_loss_ratio": 1.0}
    EVAL_OUT_KEY = "logits_aux"
    READS_FWD = True

    def __init__(self, cfg, data_info=None, device=None, base_cls=None):
        super().__init__(cfg, data_info, device, base_cls)
        cnt = self.lb_class_counts()
        self.lb_class_dist = self._const(cnt.min() / cnt)

    @property
    def abc_p_cutoff(self) -> float:
        return float(self.cfg.extra.get("abc_p_cutoff", 0.95))

    @property
    def abc_loss_ratio(self) -> float:
        return float(self.cfg.extra.get("abc_loss_ratio", 1.0))

    def wrap_model(self, model, generator=None):
        return AuxHeadNet(self.base.wrap_model(model, generator),
                          self.cfg.num_classes, generator)

    def post_loss(self, out, imb_state, ctx):
        cfg = self.cfg
        logits_lb, logits_s, logits_w = aux_logits_of(ctx, out.fwd)
        y_lb = ctx.batch["y_lb"].long()
        dev = logits_lb.device
        u_lb = draw_uniform(y_lb.shape[0], ctx.generator, dev)
        u_ulb = draw_uniform(logits_w.shape[0], ctx.generator, dev)
        mask_lb = (u_lb < self.lb_class_dist[y_lb]).float()
        abc_lb = (ce_loss(logits_lb, y_lb) * mask_lb).mean()

        probs_w = C.compute_prob(logits_w)
        max_probs, y_ulb = probs_w.max(-1)
        mask1 = (max_probs >= self.abc_p_cutoff).float()
        epochs = max(cfg.epoch, 1)
        frac = float(torch.tensor(self.epoch_of(ctx.step),
                                  dtype=torch.float32) / epochs)
        ulb_dist = 1.0 - frac * (1.0 - self.lb_class_dist)
        mask2 = (u_ulb < ulb_dist[y_ulb].clamp(0.0, 1.0)).float()
        abc_ulb = (ce_loss(logits_s, y_ulb) * (mask1 * mask2)).mean()

        abc_loss = abc_lb + abc_ulb
        return self._add_loss(out, self.abc_loss_ratio * abc_loss,
                              "abc_loss", abc_loss)
