"""DASO (port of ``semireward_tpu/imb/daso.py``): class prototypes from a
queue of the EMA weights' labeled features; past
``daso_num_pretrain_iter`` the pseudo-labels blend the model's
probabilities with prototype-similarity ones, weighted by the
temperature-scaled running pseudo-label distribution; plus an assignment
loss between the strong view's and the weak view's prototype
similarities.

The per-class queues are ``[C, L, D]`` rings with per-class pointers and
counts, written on the device before the base loss (a row's slot is its
class's pointer plus its rank among the batch's rows of that class; a slot
written twice in one batch, when a class has more than L rows, keeps its
last row: ``common.write_last``). The ``probs_sim`` mixed into the
pseudo-labels is the previous step's, as in the reference.
``gen_ulb_targets`` is the hook it swaps: ReMixMatch never calls it, so
over ReMixMatch DASO leaves the pseudo-labels alone and only adds its
queue and assignment loss, as in the JAX package."""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms import pimodel
from semireward_tpu_torch.core.losses import ce_loss, gen_ulb_targets
from semireward_tpu_torch.imb.base import ImbAlgorithm
from semireward_tpu_torch.registry import IMB_ALGORITHMS


@dataclass
class DASOState:
    bank: torch.Tensor           # [C, L, D]
    bank_ptr: torch.Tensor       # [C] int32
    bank_cnt: torch.Tensor       # [C] int32, saturates at L
    prototypes: torch.Tensor     # [C, D]
    pl_counts_acc: torch.Tensor  # [C] counts since the last snapshot
    pl_dist: torch.Tensor        # [C] the last snapshot
    probs_sim: torch.Tensor      # [uB, C] the previous step's


def enqueue(st: DASOState, feats, y) -> DASOState:
    """Write ``feats`` into their classes' rings at the pointers, advance
    the pointers and counts, and recompute the prototypes (the mean of
    each ring's valid rows)."""
    n_cls, L, D = st.bank.shape
    y = y.long()
    onehot = F.one_hot(y, n_cls).int()                      # [B, C]
    order = onehot.cumsum(0) - onehot                        # rank in class
    pos = (st.bank_ptr[None, :] + order) % L                 # [B, C]
    sel = pos.gather(1, y[:, None])[:, 0].long()
    flat = C.write_last(st.bank.reshape(n_cls * L, D), 0, y * L + sel, feats)
    bank = flat.reshape(n_cls, L, D)
    added = onehot.sum(0).int()
    ptr = (st.bank_ptr + added) % L
    cnt = torch.clamp(st.bank_cnt + added, max=L)
    valid = (torch.arange(L, device=bank.device)[None, :]
             < cnt[:, None]).float()
    protos = ((bank * valid[..., None]).sum(1)
              / cnt[:, None].float().clamp(min=1.0))
    return replace(st, bank=bank, bank_ptr=ptr, bank_cnt=cnt,
                   prototypes=protos)


@IMB_ALGORITHMS.register("daso")
class DASO(ImbAlgorithm):
    NAME = "daso"
    DEFAULTS = {"daso_queue_len": 256, "daso_T_proto": 0.05,
                "daso_T_dist": 1.5, "daso_interp_alpha": 0.5,
                "daso_with_dist_aware": True, "daso_assign_loss_ratio": 1.0,
                "daso_num_pl_dist_iter": 100, "daso_num_pretrain_iter": 5120}
    READS_FWD = True

    def __init__(self, cfg, data_info=None, device=None, base_cls=None):
        super().__init__(cfg, data_info, device, base_cls)
        x = cfg.extra
        self.T_proto = float(x.get("daso_T_proto", 0.05))
        self.T_dist = float(x.get("daso_T_dist", 1.5))
        self.queue_len = int(x.get("daso_queue_len", 256))
        self.interp_alpha = float(x.get("daso_interp_alpha", 0.5))
        self.with_dist_aware = bool(x.get("daso_with_dist_aware", True))
        self.lambda_f = float(x.get("daso_assign_loss_ratio", 1.0))
        self.num_pl_dist_iter = int(x.get("daso_num_pl_dist_iter", 100))
        self.num_pretrain_iter = int(x.get("daso_num_pretrain_iter", 5120))

    def init_imb_state(self):
        cfg, dev = self.cfg, self.device
        D = int(self.data_info.get("num_features", cfg.feature_dim))
        n = cfg.num_classes

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return DASOState(
            bank=zeros(n, self.queue_len, D),
            bank_ptr=zeros(n, dtype=torch.int32),
            bank_cnt=zeros(n, dtype=torch.int32),
            prototypes=zeros(n, D), pl_counts_acc=zeros(n), pl_dist=zeros(n),
            probs_sim=torch.full((cfg.ulb_batch_size, n), 1.0 / n,
                                 device=dev))

    def override_names(self):
        return ("gen_ulb_targets",)

    def _sim(self, feats, prototypes):
        f = feats / torch.linalg.vector_norm(
            feats, dim=-1, keepdim=True).clamp(min=1e-8)
        p = prototypes / torch.linalg.vector_norm(
            prototypes, dim=-1, keepdim=True).clamp(min=1e-8)
        sim = (f @ p.T) / self.T_proto
        return sim, F.softmax(sim, dim=1)

    def imb_gen_ulb_targets(self, logits, use_hard_label=True, T=1.0,
                            softmax=True, label_smoothing=0.0):
        st: DASOState = self._imb_state
        logits = logits.detach().float()
        probs = F.softmax(logits, dim=1) if softmax else logits
        base_pl = probs.argmax(-1)
        pretrain = self._cell["step"] < self.num_pretrain_iter
        if pretrain:
            self._cell["pl_for_count"] = base_pl
            if use_hard_label:
                return base_pl
            return gen_ulb_targets(logits, use_hard_label, T, softmax,
                                   label_smoothing)
        pl_dist = st.pl_dist / st.pl_dist.sum().clamp(min=1e-12)
        pl_dist = pl_dist ** (1.0 / self.T_dist)
        pl_dist = pl_dist / pl_dist.sum().clamp(min=1e-12)
        pl_dist = pl_dist / pl_dist.max().clamp(min=1e-12)
        w = (pl_dist[base_pl][:, None] if self.with_dist_aware
             else self.interp_alpha)
        probs_mixup = (1.0 - w) * probs + w * st.probs_sim
        mixed_pl = probs_mixup.argmax(-1)
        self._cell["pl_for_count"] = mixed_pl
        return mixed_pl if use_hard_label else probs_mixup

    def loss(self, ctx):
        base_state, st = ctx.algo_state
        n_cls = self.cfg.num_classes
        # the EMA weights' labeled features go in before the step
        with torch.no_grad():
            feats_lb = pimodel.ema_forward(ctx.model, ctx.ema,
                                           ctx.batch["x_lb"],
                                           train=False)["feat"].float()
        st = enqueue(st, feats_lb, ctx.batch["y_lb"])
        self._cell = {"step": ctx.step}
        out = self.base_loss(ctx, st)

        pl = self._cell.get("pl_for_count")
        pl_acc = st.pl_counts_acc
        if pl is not None:
            pl_acc = pl_acc + torch.bincount(pl, minlength=n_cls).float()
        pl_dist = st.pl_dist
        if (ctx.step + 1) % self.num_pl_dist_iter == 0:
            pl_dist, pl_acc = pl_acc, torch.zeros_like(pl_acc)

        feats_w = out.fwd.feats_x_ulb_w.detach().float()
        _, prob_sim_w = self._sim(feats_w, st.prototypes)
        sim_s, _ = self._sim(out.fwd.feats_x_ulb_s.float(), st.prototypes)
        assign = ce_loss(sim_s, prob_sim_w.detach(), "mean")
        active = (ctx.step + 1) >= self.num_pretrain_iter
        term = (self.lambda_f * assign if active
                else torch.zeros((), device=assign.device))
        out = self._add_loss(out, term, "assign_loss", assign)
        new_imb = replace(st, pl_counts_acc=pl_acc, pl_dist=pl_dist,
                          probs_sim=prob_sim_w.detach())
        return out._replace(new_algo_state=(out.new_algo_state, new_imb))
