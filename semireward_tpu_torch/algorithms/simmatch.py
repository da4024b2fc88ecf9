"""SimMatch (port of ``semireward_tpu/algorithms/simmatch.py``): semantic
and instance consistency against a bank of labeled embeddings
``mem_bank [proj_size, K]`` (``K = lb_dest_len``) indexed by ``idx_lb``,
with distribution alignment over a queue and the ``SimMatchNet`` head.

One forward of ``[x_lb, x_ulb_w, x_ulb_s]`` (whatever ``use_cat`` says, as
in the JAX package). The bank's labels spread each sample's similarities
over the classes with a product against their one-hot labels (a fixed
summation order on every device), and an index drawn twice in one batch
writes the bank with its last row, as the JAX package's ``.at[].set``
does on the CPU (``common.write_last``).
The first epoch has no instance loss and no smoothing (a Python branch on
the host's step count). On the datasets outside ``_EMA_BANK_DATASETS`` the
labeled bank entries come from the EMA weights (a forward of ``x_lb`` in
eval mode, with the running BatchNorm statistics of before the step:
it runs before the student's forward), and are written as they are; on
the others from the student's labeled features, mixed into the old entry
at 0.3 and renormalized.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from semireward_tpu_torch import rng
from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms import pimodel
from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.algorithms.comatch import epochs_done
from semireward_tpu_torch.models.wrappers import SimMatchNet
from semireward_tpu_torch.registry import ALGORITHMS

_EMA_BANK_DATASETS = ("cifar10", "cifar100", "svhn", "superks", "tissuemnist",
                      "eurosat", "superbks", "esc50", "gtzan", "urbansound8k",
                      "aclImdb", "ag_news", "dbpedia", "synthetic")


@dataclass
class SimMatchState:
    mem_bank: torch.Tensor     # [proj_size, K]
    labels_bank: torch.Tensor  # [K] int64
    dist_align: C.DistAlignQueueState


def class_similarity(teacher_prob, labels_bank, num_classes: int):
    """``agg[i, c] = sum_{k: labels_bank[k] = c} teacher_prob[i, k]``, as
    the product with the bank's one-hot labels: one fixed summation order
    on every run (a float ``index_add_`` on CUDA adds in no fixed order)."""
    onehot = F.one_hot(labels_bank.long(), num_classes).to(teacher_prob.dtype)
    return teacher_prob @ onehot


@ALGORITHMS.register("simmatch")
class SimMatch(Algorithm):
    NAME = "simmatch"
    DEFAULTS = {"T": 0.5, "p_cutoff": 0.95, "proj_size": 128,
                "in_loss_ratio": 1.0, "smoothing_alpha": 0.9, "da_len": 256}
    BATCH_KEYS = ("idx_lb", "x_lb", "y_lb", "x_ulb_w", "x_ulb_s")
    EMA_BANK = 0.7

    def __init__(self, cfg, data_info=None, device=None):
        super().__init__(cfg, data_info, device)
        self.use_ema_teacher = cfg.dataset not in _EMA_BANK_DATASETS
        self.K = int(self.data_info.get("lb_dest_len", 128))

    def wrap_model(self, model, generator=None):
        return SimMatchNet(model, self.cfg.proj_size, generator)

    def init_state(self):
        """The bank: columns of a normal draw from a CPU generator seeded
        with ``seed + 11`` (one bank on every device), each scaled to unit
        norm."""
        cfg, dev = self.cfg, self.device
        g = torch.Generator().manual_seed(cfg.seed + 11)
        bank = rng.randn(cfg.proj_size, self.K, generator=g, device=dev)
        return SimMatchState(
            mem_bank=bank / torch.linalg.vector_norm(bank, dim=0,
                                                     keepdim=True),
            labels_bank=torch.zeros(self.K, dtype=torch.long, device=dev),
            dist_align=C.dist_align_queue_init(
                cfg.num_classes, queue_length=cfg.da_len, device=dev))

    def loss(self, ctx: StepCtx) -> LossOut:
        cfg = self.cfg
        st: SimMatchState = ctx.algo_state
        b = ctx.batch
        n_lb, n_ulb = C.batch_dim(b["x_lb"]), C.batch_dim(b["x_ulb_w"])
        bank = st.mem_bank
        teacher_lb = None
        if self.use_ema_teacher and ctx.ema is not None:
            with torch.no_grad():
                teacher_lb = pimodel.ema_forward(
                    ctx.model, ctx.ema, b["x_lb"], train=False)["feat"]
        out = ctx.model(C.cat_views(b["x_lb"], b["x_ulb_w"], b["x_ulb_s"]),
                        train=True, generator=ctx.generator)
        logits_lb, logits_w, logits_s = torch.split(out["logits"],
                                                    [n_lb, n_ulb, n_ulb])
        feats_lb, feats_w, feats_s = torch.split(out["feat"],
                                                 [n_lb, n_ulb, n_ulb])
        logits_w, feats_w = logits_w.detach(), feats_w.detach()
        if teacher_lb is not None:
            feats_lb = teacher_lb

        sup_loss = self.ce_loss(logits_lb, b["y_lb"], reduction="mean")
        probs_w = F.softmax(logits_w.float(), dim=-1)
        da_state, probs_w = C.dist_align_queue(st.dist_align, probs_w)

        if epochs_done(cfg, ctx.step) == 0:
            # the first epoch: no instance loss, plain probabilities
            in_loss = torch.zeros((), device=sup_loss.device)
        else:
            teacher_prob_orig = F.softmax(feats_w @ bank / cfg.T, dim=1)
            teacher_prob = teacher_prob_orig * probs_w[:, st.labels_bank]
            teacher_prob = teacher_prob / teacher_prob.sum(1, keepdim=True)
            if cfg.smoothing_alpha < 1:
                agg = class_similarity(teacher_prob_orig, st.labels_bank,
                                       cfg.num_classes)
                probs_w = (probs_w * cfg.smoothing_alpha
                           + agg * (1 - cfg.smoothing_alpha))
            student_prob = F.softmax(feats_s @ bank / cfg.T, dim=1)
            in_loss = (-teacher_prob.detach()
                       * torch.log(student_prob)).sum(1).mean()

        mask = self.fixed_mask(probs_w)
        unsup_loss = self.consistency_loss(logits_s, probs_w, "ce", mask=mask)

        # the bank's columns at idx_lb
        k = feats_lb.detach().float().T
        idx = b["idx_lb"].long()
        if not self.use_ema_teacher:
            mixed = self.EMA_BANK * bank[:, idx] + (1 - self.EMA_BANK) * k
            k = mixed / torch.linalg.vector_norm(mixed, dim=0, keepdim=True)
        # an index drawn twice in the batch keeps its last row
        new_state = SimMatchState(
            mem_bank=C.write_last(bank, 1, idx, k),
            labels_bank=C.write_last(st.labels_bank, 0, idx, b["y_lb"]),
            dist_align=da_state)
        fwd = C.ForwardOut(logits_lb, logits_w, logits_s, feats_lb, feats_w,
                           feats_s)
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=fwd,
                         new_algo_state=new_state, mask=mask,
                         pseudo_label=probs_w,
                         extra_loss=cfg.in_loss_ratio * in_loss,
                         metrics={"in_loss": in_loss})
