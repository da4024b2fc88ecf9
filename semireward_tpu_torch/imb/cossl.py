"""CoSSL (port of ``semireward_tpu/imb/cossl.py``): co-learning with a
tail-feature-enhanced (TFE) teacher head (``models/wrappers.py:CoSSLNet``).

- Each step, past ``cossl_warm_epoch``, the teacher head trains on the
  EMA weights' features of a class-balanced labeled stream, mixed with an
  unlabeled stream's (``x_tfe_lb`` / ``x_tfe_ulb`` from the loader's
  ``tfe_streams``; a tail class mixes more: with probability
  ``(max count - count) / max count``, lambda uniform in ``[max_lam,
  1)``; the draws come from ``draw_tfe_mix``). Its CE is added to the
  base's loss (``post_loss``).
- The teacher head is stepped twice, as in the reference: by the main
  optimizer and by its own torch-SGD (``cossl_tfe_warm_lr``, momentum,
  ``cossl_tfe_warm_wd``, nesterov) over the same gradients
  (``post_param_update``).
- At the boundary of epoch ``cossl_warm_epoch`` (the first boundary is
  epoch 1, so the corpus's 0 never reaches it, as in the JAX package) the
  teacher head is warm-started (``on_epoch_end``): EMA features and logits
  of the labeled and unlabeled sets (``tfe_view``: strong or weak views,
  seeded 0, 1, 2), the tail classes filled up to the largest by mixup with
  the most likely other samples, and ``cossl_tfe_warm_epoch`` epochs of
  Adam (lr 1e-3) on that balanced set in batches of ``cossl_tfe_warm_bs``
  (numpy draws from ``seed + 13``). The head goes into the weights and
  the EMA.
- Evaluation reads the teacher head from ``cossl_warm_epoch`` on
  (``eval_out_key``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from semireward_tpu_torch import rng
from semireward_tpu_torch.core.losses import ce_loss
from semireward_tpu_torch.core.optim import Optimizer
from semireward_tpu_torch.imb.base import (ImbAlgorithm, refuse_lazy_images,
                                           softmax_np)
from semireward_tpu_torch.models.wrappers import CoSSLNet
from semireward_tpu_torch.registry import IMB_ALGORITHMS

HEAD = "teacher_classifier"


def draw_tfe_mix(n: int, max_lam: float, generator=None, device=None):
    """The step's mixup draws: ``n`` uniforms in [0, 1) (mix where below
    the class's probability) and ``n`` lambdas uniform in [max_lam, 1)."""
    u = rng.rand(n, generator=generator, device=device)
    lam = max_lam + (1.0 - max_lam) * rng.rand(n, 1, generator=generator,
                                               device=device)
    return u, lam


def tfe_view(x, spec, strong: bool, generator):
    """A strong (RandAugment) or weak view of a uint8 image batch on the
    device, for the warm-start's feature passes."""
    from semireward_tpu_torch.data.augment.pipeline import (
        draw_crop, draw_randaug, draw_strong_crop, strong_augment,
        weak_augment)

    B, dev = x.shape[0], x.device
    if strong:
        return strong_augment(x, spec, draw_strong_crop(B, spec, generator,
                                                        dev),
                              draw_randaug(B, spec, generator, dev))
    return weak_augment(x, spec, draw_crop(B, spec, generator, dev))


def balanced_features(lb_feats, lb_probs, y_lb, ulb_feats, ulb_probs,
                      num_classes: int, rs: np.random.RandomState):
    """The labeled features plus, for each class short of the largest, as
    many mixes of its own features (drawn with replacement) with the other
    samples most likely to be of it; one-hot targets (float32)."""
    cnt = np.bincount(y_lb, minlength=num_classes)
    feats, tgts = [lb_feats], [np.eye(num_classes)[y_lb]]
    for c in range(num_classes):
        need = cnt.max() - cnt[c]
        cur = lb_feats[y_lb == c]
        if need <= 0 or len(cur) == 0:
            continue
        other_f = np.concatenate([lb_feats[y_lb != c], ulb_feats])
        other_p = np.concatenate([lb_probs[y_lb != c], ulb_probs])[:, c]
        other_f = other_f[np.argsort(-other_p)]
        a_idx = rs.choice(len(cur), need, replace=True)
        b_idx = np.arange(min(need, len(other_f)))
        lam = rs.beta(0.75, 0.75, size=len(b_idx))[:, None]
        feats.append(lam * cur[a_idx[:len(b_idx)]] + (1 - lam) * other_f[b_idx])
        t = np.zeros((len(b_idx), num_classes))
        t[:, c] = 1
        tgts.append(t)
    return (np.concatenate(feats).astype(np.float32),
            np.concatenate(tgts).astype(np.float32))


@IMB_ALGORITHMS.register("cossl")
class CoSSL(ImbAlgorithm):
    NAME = "cossl"
    DEFAULTS = {"cossl_max_lam": 0.6, "cossl_tfe_augment": "strong",
                "cossl_tfe_u_ratio": 1, "cossl_warm_epoch": 0,
                "cossl_tfe_warm_epoch": 1, "cossl_tfe_warm_lr": 0.02,
                "cossl_tfe_warm_ema_decay": 0.999, "cossl_tfe_warm_wd": 5e-4,
                "cossl_tfe_warm_bs": 64}
    EXTRA_STREAMS = ("tfe_lb", "tfe_ulb")

    def __init__(self, cfg, data_info=None, device=None, base_cls=None):
        super().__init__(cfg, data_info, device, base_cls)
        x = cfg.extra
        self.max_lam = float(x.get("cossl_max_lam", 0.6))
        self.tfe_augment = str(x.get("cossl_tfe_augment", "strong"))
        self.tfe_u_ratio = int(x.get("cossl_tfe_u_ratio", 1))
        self.warm_epoch = int(x.get("cossl_warm_epoch", 0))
        cnt = self.lb_class_counts()
        self.mixup_prob = self._const((cnt.max() - cnt) / cnt.max())
        self.BATCH_KEYS = tuple(dict.fromkeys(
            self.BATCH_KEYS + ("x_tfe_lb", "y_tfe_lb", "x_tfe_ulb")))
        self.warmed = False

    def wrap_model(self, model, generator=None):
        self._num_features = int(model.num_features)
        return CoSSLNet(self.base.wrap_model(model, generator),
                        self.cfg.num_classes, generator)

    def init_imb_state(self):
        nf = int(getattr(self, "_num_features", self.data_info.get(
            "num_features", self.cfg.feature_dim)))
        n = self.cfg.num_classes
        # torch-SGD momentum of the teacher head, under the flax names
        return {"tfe_momentum": {
            "kernel": torch.zeros(nf, n, device=self.device),
            "bias": torch.zeros(n, device=self.device)}}

    def active(self, step: int) -> bool:
        return self.epoch_of(step) >= self.warm_epoch

    def eval_out_key(self, step: int) -> str:
        return "logits_tfe" if self.active(step) else "logits"

    @torch.no_grad()
    def post_param_update(self, params: Dict[str, torch.Tensor],
                          grads: Dict[str, torch.Tensor], algo_state,
                          step: int):
        """``d = g + wd p; buf = mu buf + d; d += mu buf; p -= lr d`` on
        the teacher head (weights in place), from ``cossl_warm_epoch``
        on; the momentum is kept as the flax ``[in, out]`` kernel."""
        base_state, imb_state = algo_state
        if not self.active(step):
            return algo_state
        cfg = self.cfg
        lr = float(cfg.extra.get("cossl_tfe_warm_lr", 0.02))
        wd = float(cfg.extra.get("cossl_tfe_warm_wd", 5e-4))
        mu = float(cfg.momentum)
        prefix = next(n for n in params if n.endswith(f"{HEAD}.weight"))[
            :-len("weight")]
        buf = imb_state["tfe_momentum"]
        new_buf = {}
        for leaf, name, t in (("kernel", "weight", True),
                              ("bias", "bias", False)):
            p = params[prefix + name]
            g, b = grads[prefix + name].float(), buf[leaf]
            if t:
                g, pv = g.T, p.T
            else:
                pv = p
            d = g + wd * pv
            nb = mu * b + d
            d = d + mu * nb
            pv.sub_(lr * d)
            new_buf[leaf] = nb
        return base_state, {**imb_state, "tfe_momentum": new_buf}

    @torch.no_grad()
    def pre_loss(self, ctx):
        """The EMA weights' features of the TFE streams, with the running
        statistics of before the step (as the JAX loss reads them)."""
        b = ctx.batch
        if "x_tfe_lb" not in b:
            return {}
        from semireward_tpu_torch.algorithms import pimodel

        return {k: pimodel.ema_forward(ctx.model, ctx.ema, b[x],
                                       train=False)["feat"]
                for k, x in (("feat_x", "x_tfe_lb"), ("feat_u", "x_tfe_ulb"))}

    def post_loss(self, out, imb_state, ctx):
        b = ctx.batch
        if "x_tfe_lb" not in b:
            return out
        feat_x, feat_u = self._cell["feat_x"], self._cell["feat_u"]
        y_x = b["y_tfe_lb"].long()
        n = y_x.shape[0]
        feat_u = feat_u[:n]
        u, lam = draw_tfe_mix(n, self.max_lam, ctx.generator, feat_x.device)
        do_mix = u < self.mixup_prob[y_x]
        mixed = torch.where(do_mix[:, None], lam * feat_x + (1 - lam) * feat_u,
                            feat_x)
        teacher_loss = ce_loss(ctx.model.teacher(mixed), y_x, "mean")
        term = (teacher_loss if self.active(ctx.step)
                else torch.zeros((), device=teacher_loss.device))
        return self._add_loss(out, term, "tea_loss", teacher_loss)

    # ---- the teacher head's warm start -----------------------------------
    @torch.no_grad()
    def _feats_logits(self, trainer, data, strong: bool, seed: int):
        bs = int(self.cfg.extra.get("cossl_tfe_warm_bs", 64))
        names = [n for n, _ in trainer.model.named_parameters()]
        ema = dict(zip(names, trainer.state.ema))
        # on the run's generator's device (``Trainer(rng_device=)``)
        rng_dev = getattr(trainer.state.rng, "device", trainer.device)
        g = torch.Generator(device=rng_dev).manual_seed(seed)
        feats, logits = [], []
        for s in range(0, len(data), bs):
            x = trainer._to_device(np.asarray(data[s:s + bs]))
            out = torch.func.functional_call(
                trainer.model, ema, (tfe_view(x, trainer.aug_spec, strong, g),),
                {"train": False})
            feats.append(out["feat"].float().cpu().numpy())
            logits.append(out["logits"].float().cpu().numpy())
        return np.concatenate(feats), np.concatenate(logits)

    def on_epoch_end(self, trainer, state):
        cfg = self.cfg
        if self.epoch_of(int(state.step)) != self.warm_epoch or self.warmed:
            return state
        self.warmed = True
        trainer.logger.info("CoSSL: TFE classifier warm-up")
        lb, ulb = trainer.bundle.train_lb, trainer.bundle.train_ulb
        for ds in (lb, ulb):
            refuse_lazy_images(ds, "CoSSL's teacher warm start")
        lb_feats, lb_logits = self._feats_logits(
            trainer, lb.data, self.tfe_augment == "strong", 0)
        ulb_feats, _ = self._feats_logits(trainer, ulb.data, True, 1)
        _, ulb_logits = self._feats_logits(trainer, ulb.data, False, 2)
        y_lb = np.asarray(lb.targets, np.int64)
        rs = np.random.RandomState(cfg.seed + 13)
        F_, T_ = balanced_features(lb_feats, softmax_np(lb_logits), y_lb,
                                   ulb_feats, softmax_np(ulb_logits),
                                   cfg.num_classes, rs)
        head = state.model.get_submodule(self._head_path(state.model))
        w = head.weight.detach().clone()
        b = head.bias.detach().clone()
        adam = Optimizer([w, b], "adam", lambda count: 1e-3)
        bs = int(cfg.extra.get("cossl_tfe_warm_bs", 64))
        dev = w.device
        Ft, Tt = torch.from_numpy(F_).to(dev), torch.from_numpy(T_).to(dev)
        for _ in range(int(cfg.extra.get("cossl_tfe_warm_epoch", 1))):
            perm = rs.permutation(len(F_))
            for s in range(0, len(F_) - bs + 1, bs):
                idx = torch.from_numpy(perm[s:s + bs]).to(dev)
                with torch.enable_grad():
                    wg, bg = w.detach().requires_grad_(), \
                        b.detach().requires_grad_()
                    logp = F.log_softmax(Ft[idx] @ wg.T + bg, dim=-1)
                    loss = -(Tt[idx] * logp).sum(-1).mean()
                    grads = torch.autograd.grad(loss, [wg, bg])
                adam.step(grads)
        names = [n for n, _ in state.model.named_parameters()]
        with torch.no_grad():
            head.weight.copy_(w)
            head.bias.copy_(b)
            for n, e in zip(names, state.ema):
                if n.endswith(f"{HEAD}.weight"):
                    e.copy_(w)
                elif n.endswith(f"{HEAD}.bias"):
                    e.copy_(b)
        trainer.logger.info(f"CoSSL: teacher head warm-start done "
                            f"({len(F_)} balanced features)")
        return state

    @staticmethod
    def _head_path(model) -> str:
        return next(n for n, _ in model.named_modules()
                    if n.split(".")[-1] == HEAD)
