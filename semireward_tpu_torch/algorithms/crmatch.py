"""CRMatch (port of ``semireward_tpu/algorithms/crmatch.py``): FixMatch's
masked CE, a feature-level consistency (the cosine embedding loss with
target -1 between the ``ds`` head's outputs of the strong and the detached
weak view, masked) and the 4-way rotation head on a rotated weak stream
(all four rotations of each image, ``rot_v`` 0..3 a block each), all from
one forward over [lb, w, s, rot x 4]. Total = Lx + Lu + Ld (+ Lrot)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.models.wrappers import CRMatchNet
from semireward_tpu_torch.registry import ALGORITHMS


def cosine_embedding_loss_neg(a, b):
    """``F.cosine_embedding_loss(a, b, -1, reduction='none')`` (margin 0):
    per sample ``max(0, cos(a, b))``, each row l2-normalized with a floor
    of 1e-12 on its norm."""
    an = a / torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp(min=1e-12)
    bn = b / torch.linalg.vector_norm(b, dim=1, keepdim=True).clamp(min=1e-12)
    return F.relu((an * bn).sum(1))


@ALGORITHMS.register("crmatch")
class CRMatch(Algorithm):
    NAME = "crmatch"
    DEFAULTS = {"hard_label": True, "rot_loss_ratio": 1.0, "p_cutoff": 0.95}
    BATCH_KEYS = ("x_lb", "y_lb", "x_ulb_w", "x_ulb_s", "x_ulb_rot", "rot_v")

    @property
    def use_rot(self) -> bool:
        return self.cfg.rot_loss_ratio > 0

    def wrap_model(self, model, generator=None):
        return CRMatchNet(model, self.cfg.num_classes, generator)

    def loss(self, ctx: StepCtx) -> LossOut:
        b = ctx.batch
        num_lb, num_ulb = b["y_lb"].shape[0], C.batch_dim(b["x_ulb_w"])
        use_rot = self.use_rot and "x_ulb_rot" in b
        parts = [b["x_lb"], b["x_ulb_w"], b["x_ulb_s"]]
        if use_rot:
            parts.append(b["x_ulb_rot"])
        outs = ctx.model(C.cat_views(*parts), train=True, use_rot=use_rot,
                         generator=ctx.generator)
        split = [num_lb, num_ulb, num_ulb]
        logits_x_lb, logits_w, logits_s = torch.split(
            outs["logits"][:sum(split)], split)
        feats_x_lb, feats_w, feats_s = torch.split(outs["feat"][:sum(split)],
                                                   split)
        _, ds_w, ds_s = torch.split(outs["logits_ds"][:sum(split)], split)
        logits_w, feats_w, ds_w = (t.detach() for t in
                                   (logits_w, feats_w, ds_w))

        y_ulb = logits_w.argmax(-1)
        mask = self.fixed_mask(self.compute_prob(logits_w))
        sup_loss = self.ce_loss(logits_x_lb, b["y_lb"], reduction="mean")
        unsup_loss = (self.ce_loss(logits_s, y_ulb) * mask).mean()
        ds_loss = (cosine_embedding_loss_neg(ds_s, ds_w) * mask).mean()
        extra = ds_loss
        rot_loss = torch.zeros((), device=sup_loss.device)
        if use_rot:
            rot_loss = self.ce_loss(outs["logits_rot"][sum(split):],
                                    b["rot_v"], reduction="mean")
            extra = extra + rot_loss
        fwd = C.ForwardOut(logits_x_lb, logits_w, logits_s, feats_x_lb,
                           feats_w, feats_s)
        # the reference's total is Lx + Lu + Ld (+ Lrot): lambda_u = 1
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=fwd,
                         new_algo_state=ctx.algo_state, mask=mask,
                         pseudo_label=y_ulb, lambda_u=1.0, extra_loss=extra,
                         metrics={"Ld": ds_loss, "rot_loss": rot_loss})
