"""ReMixMatch (port of ``semireward_tpu/algorithms/remixmatch.py``): the
weak view's probabilities aligned to the labeled class distribution (an
EMA of the model's, ``dist_align_ema``) and sharpened; MixUp over [lb, s0,
s1, w] (``is_bias``) classified in chunks of ``num_lb`` rows; the pre-mix
CE (``u1``) of the raw s0 view against the target; and the 4-way rotation
head (``models/wrappers.py:RotNet``) on the rotated s0 view. Every forward
but the first mixed chunk's runs with BatchNorm frozen.

- Input space (images, waveforms): the inputs are mixed and each chunk is
  forwarded, the first one updating the BatchNorm running statistics. The
  JAX loss's forwards of the labeled and s1 views feed no loss and are not
  run, unless ``keep_fwd`` is set (an imbalanced-SSL wrapper that reads
  the forward: ABC, DARP, DASO): then the labeled view's forward runs too
  (with its gradient) and the loss returns the JAX package's ``fwd``
  (labeled, weak and s0 logits and features).
- Feature space (``mixup_manifold``, any net): the labeled, s0 and s1
  forwards (with their gradients) and the weak one give the features that
  are mixed, and each chunk goes through the head alone (``only_fc``).

The JAX loss fails on token dicts without ``mixup_manifold``
(``check_mixup_inputs``), and on text and waveforms wherever the rotation
head is on (``rot_loss_ratio`` > 0): their loaders give the rotated view
``x_ulb_s_0_rot`` (a strong text view, a strong clip) but no rotation
labels ``rot_v``, which the loss reads, raising ``KeyError``. The port
refuses both when it is built. With ``rot_loss_ratio`` 0 the loaders still
draw every view of ``BATCH_KEYS``, as JAX's do."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.algorithms.mixmatch import (check_mixup_inputs,
                                                      chunk_logits, sharpen)
from semireward_tpu_torch.data.modality import modality_of
from semireward_tpu_torch.models.batchnorm import frozen_bn
from semireward_tpu_torch.models.wrappers import RotNet
from semireward_tpu_torch.registry import ALGORITHMS


@ALGORITHMS.register("remixmatch")
class ReMixMatch(Algorithm):
    NAME = "remixmatch"
    DEFAULTS = {"T": 0.5, "kl_loss_ratio": 0.5, "rot_loss_ratio": 0.5,
                "unsup_warm_up": 1 / 64, "mixup_alpha": 0.75,
                "mixup_manifold": False}
    BATCH_KEYS = ("x_lb", "y_lb", "x_ulb_w", "x_ulb_s_0", "x_ulb_s_1",
                  "x_ulb_s_0_rot", "rot_v")
    # set by an imbalanced-SSL wrapper that reads the forward's outputs
    keep_fwd = False

    @classmethod
    def check_ported(cls, cfg) -> None:
        check_mixup_inputs(cls, cfg)
        if modality_of(cfg.net) != "cv" and cfg.rot_loss_ratio > 0:
            raise KeyError(
                f"rot_v: remixmatch's rotation head on {cfg.net} reads the "
                f"rotation labels, which its loader does not make (the JAX "
                f"loss raises KeyError 'rot_v'); set rot_loss_ratio 0")

    @property
    def use_rot(self) -> bool:
        return self.cfg.rot_loss_ratio > 0

    def wrap_model(self, model, generator=None):
        return RotNet(model, generator) if self.use_rot else model

    def init_state(self):
        dist = self.data_info.get("lb_class_dist")
        p_target = (torch.as_tensor(dist, dtype=torch.float32)
                    if dist is not None else None)
        return C.dist_align_ema_init(self.cfg.num_classes, p_target=p_target,
                                     device=self.device)[0]

    def loss(self, ctx: StepCtx) -> LossOut:
        cfg = self.cfg
        b, model, gen = ctx.batch, ctx.model, ctx.generator
        num_lb = b["y_lb"].shape[0]
        manifold = cfg.mixup_manifold
        with frozen_bn(model):
            with torch.no_grad():
                outs_w = model(b["x_ulb_w"], train=True, generator=gen)
                da_state, prob = C.dist_align_ema(
                    ctx.algo_state, self.compute_prob(outs_w["logits"]),
                    momentum=0.999)
                target = sharpen(prob, cfg.T)
            if self.keep_fwd or manifold:
                outs_lb = model(b["x_lb"], train=True, generator=gen)
            outs_s0 = model(b["x_ulb_s_0"], train=True, generator=gen)
            if manifold:
                outs_s1 = model(b["x_ulb_s_1"], train=True, generator=gen)

        if manifold:
            inputs = torch.cat([outs_lb["feat"], outs_s0["feat"],
                                outs_s1["feat"], outs_w["feat"]])
        else:
            inputs = torch.cat([b["x_lb"], b["x_ulb_s_0"], b["x_ulb_s_1"],
                                b["x_ulb_w"]])
        labels = torch.cat([F.one_hot(b["y_lb"].long(),
                                      cfg.num_classes).float(),
                            target, target, target])
        lam, index = C.draw_mixup(inputs.shape[0], cfg.mixup_alpha, True,
                                  gen, inputs.device)
        mixed_x, mixed_y = C.mixup_one_target(inputs, labels, lam, index)
        logits_x, logits_u = chunk_logits(model, mixed_x, num_lb, gen,
                                          only_fc=manifold)
        sup_loss = self.ce_loss(logits_x, mixed_y[:num_lb], reduction="mean")
        unsup_loss = self.consistency_loss(logits_u, mixed_y[num_lb:], "ce")
        u1_loss = self.consistency_loss(outs_s0["logits"], target, "ce")
        warm = self.unsup_warmup_factor(ctx.step)
        extra = cfg.kl_loss_ratio * warm * u1_loss
        rot_loss = torch.zeros((), device=sup_loss.device)
        if self.use_rot and "x_ulb_s_0_rot" in b:
            with frozen_bn(model):
                out_rot = model(b["x_ulb_s_0_rot"], train=True, use_rot=True,
                                generator=gen)
            rot_loss = self.ce_loss(out_rot["logits_rot"], b["rot_v"],
                                    reduction="mean")
            extra = extra + cfg.rot_loss_ratio * rot_loss
        fwd = None
        if self.keep_fwd:
            fwd = C.ForwardOut(outs_lb["logits"], outs_w["logits"],
                               outs_s0["logits"], outs_lb["feat"],
                               outs_w["feat"], outs_s0["feat"])
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=fwd,
                         new_algo_state=da_state, warmup=warm,
                         extra_loss=extra,
                         metrics={"u1_loss": u1_loss, "rot_loss": rot_loss})
