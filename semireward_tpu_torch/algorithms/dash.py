"""Dash (port of ``semireward_tpu/algorithms/dash.py``): a loss-based
dynamic threshold rho, decayed geometrically every 10 epochs, with hard
pseudo labels once it reaches ``rho_min`` and soft ones before. The
supervised warm-up that sets ``rho_init`` from the eval loss runs in the
trainer (``Trainer.warmup``). The update condition is a host branch on the
step; the state stays on the device."""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.registry import ALGORITHMS


@dataclass
class DashState:
    rho_init: torch.Tensor        # f32, set by the warm-up (eval CE loss)
    rho: torch.Tensor             # f32
    rho_update_cnt: torch.Tensor  # int32
    use_hard_label: torch.Tensor  # bool


@ALGORITHMS.register("dash")
class Dash(Algorithm):
    NAME = "dash"
    DEFAULTS = {"T": 0.5, "gamma": 1.27, "C": 1.0001, "rho_min": 0.05,
                "num_wu_iter": 2048, "num_wu_eval_iter": 100}
    BATCH_KEYS = ("x_lb", "y_lb", "x_ulb_w", "x_ulb_s")
    NEEDS_WARMUP = True

    def init_state(self):
        rho0 = float(self.cfg.extra.get("rho_init", 1.0))
        return DashState(
            rho_init=torch.tensor(rho0, device=self.device),
            rho=torch.tensor(rho0, device=self.device),
            rho_update_cnt=torch.zeros((), dtype=torch.int32,
                                       device=self.device),
            use_hard_label=torch.zeros((), dtype=torch.bool,
                                       device=self.device))

    def set_rho_init(self, state: DashState, rho_init: float) -> DashState:
        """After the supervised warm-up: rho_init = the eval CE loss."""
        v = torch.tensor(rho_init, dtype=torch.float32,
                         device=state.rho.device)
        return replace(state, rho_init=v, rho=v.clone(),
                       rho_update_cnt=torch.zeros_like(state.rho_update_cnt))

    def loss(self, ctx: StepCtx) -> LossOut:
        cfg = self.cfg
        st: DashState = ctx.algo_state
        fwd = self.forward(ctx)
        sup_loss = self.ce_loss(fwd.logits_x_lb, ctx.batch["y_lb"],
                                reduction="mean")
        rho, cnt = st.rho, st.rho_update_cnt
        per_epoch = max(cfg.num_train_iter // max(cfg.epoch, 1), 1)
        if ctx.step % (10 * per_epoch) == 0:
            gamma = torch.tensor(cfg.gamma, device=rho.device)
            rho = torch.clamp(cfg.C * gamma.pow(-cnt.float()) * st.rho_init,
                              min=cfg.rho_min)
            cnt = cnt + 1
        use_hard = rho == cfg.rho_min

        logits_w = fwd.logits_x_ulb_w.float()
        hard_pl = logits_w.argmax(-1)
        soft_pl = F.softmax(logits_w / cfg.T, dim=-1)
        # the mask: ce(logits_w, pseudo label) <= rho
        loss_w = torch.where(use_hard, self.ce_loss(logits_w, hard_pl),
                             self.ce_loss(logits_w, soft_pl))
        mask = (loss_w <= rho).float()
        unsup_loss = torch.where(
            use_hard,
            self.consistency_loss(fwd.logits_x_ulb_s, hard_pl, "ce",
                                  mask=mask),
            self.consistency_loss(fwd.logits_x_ulb_s, soft_pl, "ce",
                                  mask=mask))
        new_state = DashState(rho_init=st.rho_init, rho=rho,
                              rho_update_cnt=cnt, use_hard_label=use_hard)
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=fwd,
                         new_algo_state=new_state, mask=mask,
                         pseudo_label=hard_pl, metrics={"rho": rho})
