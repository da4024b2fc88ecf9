"""Pi-Model and Mean Teacher (port of
``semireward_tpu/algorithms/pimodel.py``): an MSE consistency between the
second weak view's probabilities and the weak view's (detached) ones, from
the model itself (Pi) or from its EMA shadow (Mean Teacher), ramped by
``unsup_warm_up``. The unlabeled forwards run with BatchNorm frozen
(normalized by their own batch moments, running statistics left as they
were). The weak view feeds no gradient, so its forward runs without one.
"""
from __future__ import annotations

from typing import List

import torch
from torch.func import functional_call

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.models.batchnorm import frozen_bn
from semireward_tpu_torch.registry import ALGORITHMS


def ema_forward(model, ema: List[torch.Tensor], x, generator=None,
                train: bool = True):
    """``model``'s forward (training mode by default) with the EMA shadow
    in place of its parameters (the live buffers, as in the JAX
    package)."""
    names = [n for n, _ in model.named_parameters()]
    return functional_call(model, dict(zip(names, ema)), (x,),
                           {"train": train, "generator": generator})


class _UnlabeledConsistency(Algorithm):
    DEFAULTS = {"unsup_warm_up": 0.4}
    BATCH_KEYS = ("x_lb", "y_lb", "x_ulb_w", "x_ulb_s")
    WEAK_ULB_S = True
    TEACHER_EMA = False

    def loss(self, ctx: StepCtx) -> LossOut:
        b, model, gen = ctx.batch, ctx.model, ctx.generator
        outs_lb = model(b["x_lb"], train=True, generator=gen)
        with frozen_bn(model):
            with torch.no_grad():
                if self.TEACHER_EMA and ctx.ema is not None:
                    outs_w = ema_forward(model, ctx.ema, b["x_ulb_w"], gen)
                else:
                    outs_w = model(b["x_ulb_w"], train=True, generator=gen)
            outs_s = model(b["x_ulb_s"], train=True, generator=gen)
        sup_loss = self.ce_loss(outs_lb["logits"], b["y_lb"],
                                reduction="mean")
        probs_w = self.compute_prob(outs_w["logits"])
        unsup_loss = self.consistency_loss(outs_s["logits"], probs_w, "mse")
        fwd = C.ForwardOut(outs_lb["logits"], outs_w["logits"],
                           outs_s["logits"], outs_lb["feat"], outs_w["feat"],
                           outs_s["feat"])
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=fwd,
                         new_algo_state=ctx.algo_state,
                         warmup=self.unsup_warmup_factor(ctx.step))


@ALGORITHMS.register("pimodel")
class PiModel(_UnlabeledConsistency):
    NAME = "pimodel"


@ALGORITHMS.register("meanteacher")
class MeanTeacher(_UnlabeledConsistency):
    NAME = "meanteacher"
    TEACHER_EMA = True
