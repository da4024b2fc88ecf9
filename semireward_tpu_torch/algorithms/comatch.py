"""CoMatch (port of ``semireward_tpu/algorithms/comatch.py``): the
projection-head net (``ProjectionNet``), distribution alignment over a
queue, pseudo-probabilities smoothed over a memory queue of embeddings, and
a contrastive loss over the pseudo-label graph.

One forward of ``[x_lb, x_ulb_w, x_ulb_s_0, x_ulb_s_1]`` (whatever
``use_cat`` says, as in the JAX package). The queue is a ring of
``queue_batch * (uratio + 1) * batch_size`` rows on the device, written at
``queue_ptr`` with the weak features and the aligned probabilities, then
the labeled features and the labels' one-hots. Its size is a multiple of
the rows written a step, so a write never runs past the end (JAX's
``dynamic_update_slice`` would clamp it there; the port raises instead).
Memory smoothing starts once the step is past the first epoch and past
``queue_batch``: a Python branch on the host's step count.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.models.wrappers import ProjectionNet
from semireward_tpu_torch.registry import ALGORITHMS


@dataclass
class CoMatchState:
    queue_feats: torch.Tensor  # [queue_size, proj_size]
    queue_probs: torch.Tensor  # [queue_size, num_classes]
    queue_ptr: torch.Tensor    # int64 scalar
    dist_align: C.DistAlignQueueState


def comatch_contrastive_loss(f0, f1, Q, T: float = 0.2):
    """Cross-entropy of the row-softmax of ``f0 f1^T / T`` against the
    graph ``Q`` (1e-7 inside the log)."""
    sim = torch.exp(f0 @ f1.T / T)
    sim_probs = sim / sim.sum(1, keepdim=True)
    return (-(torch.log(sim_probs + 1e-7) * Q).sum(1)).mean()


def pseudo_label_graph(probs, cutoff: float):
    """``probs probs^T`` with its diagonal set to 1, the entries below
    ``cutoff`` zeroed, each row normalized to sum 1."""
    Q = probs @ probs.T
    Q = Q.fill_diagonal_(1.0)
    Q = Q * (Q >= cutoff).to(Q.dtype)
    return Q / Q.sum(1, keepdim=True)


def memory_smoothing(probs, feats_w, queue_feats, queue_probs, T: float,
                     alpha: float):
    """``alpha probs + (1 - alpha) A queue_probs`` with ``A`` the
    row-softmax of the weak features' similarities to the queue at
    ``T``."""
    A = torch.exp(feats_w @ queue_feats.T / T)
    A = A / A.sum(1, keepdim=True)
    return alpha * probs + (1 - alpha) * (A @ queue_probs)


def epochs_done(cfg, step: int) -> int:
    """Whole epochs before host step ``step``: ``num_train_iter // epoch``
    steps an epoch."""
    return step // max(cfg.num_train_iter // max(cfg.epoch, 1), 1)


@ALGORITHMS.register("comatch")
class CoMatch(Algorithm):
    NAME = "comatch"
    DEFAULTS = {"hard_label": True, "T": 0.5, "p_cutoff": 0.95,
                "contrast_p_cutoff": 0.8, "contrast_loss_ratio": 1.0,
                "proj_size": 128, "queue_batch": 128,
                "smoothing_alpha": 0.9, "da_len": 256}
    BATCH_KEYS = ("x_lb", "y_lb", "x_ulb_w", "x_ulb_s_0", "x_ulb_s_1")

    def wrap_model(self, model, generator=None):
        return ProjectionNet(model, self.cfg.proj_size, generator)

    @property
    def queue_size(self) -> int:
        cfg = self.cfg
        return int(cfg.queue_batch * (cfg.uratio + 1) * cfg.batch_size)

    def init_state(self):
        cfg, dev = self.cfg, self.device
        return CoMatchState(
            queue_feats=torch.zeros(self.queue_size, cfg.proj_size,
                                    device=dev),
            queue_probs=torch.zeros(self.queue_size, cfg.num_classes,
                                    device=dev),
            queue_ptr=torch.zeros((), dtype=torch.long, device=dev),
            dist_align=C.dist_align_queue_init(
                cfg.num_classes, queue_length=cfg.da_len, device=dev))

    def loss(self, ctx: StepCtx) -> LossOut:
        cfg = self.cfg
        st: CoMatchState = ctx.algo_state
        b = ctx.batch
        n_lb, n_ulb = C.batch_dim(b["x_lb"]), C.batch_dim(b["x_ulb_w"])
        out = ctx.model(C.cat_views(b["x_lb"], b["x_ulb_w"], b["x_ulb_s_0"],
                                    b["x_ulb_s_1"]),
                        train=True, generator=ctx.generator)
        logits_lb, logits_w, logits_s0, _ = torch.split(
            out["logits"], [n_lb, n_ulb, n_ulb, n_ulb])
        feats_lb, feats_w, feats_s0, feats_s1 = torch.split(
            out["feat"], [n_lb, n_ulb, n_ulb, n_ulb])
        logits_w, feats_w = logits_w.detach(), feats_w.detach()

        sup_loss = self.ce_loss(logits_lb, b["y_lb"], reduction="mean")
        probs = self.compute_prob(logits_w)
        da_state, probs = C.dist_align_queue(st.dist_align, probs)
        probs_orig = probs
        # memory smoothing once the queue has warmed up
        if epochs_done(cfg, ctx.step) > 0 and ctx.step > cfg.queue_batch:
            probs = memory_smoothing(probs, feats_w, st.queue_feats,
                                     st.queue_probs, cfg.T,
                                     cfg.smoothing_alpha)
        mask = self.fixed_mask(probs)

        # the queue: [weak features, aligned probs; lb features, one-hots]
        n_ins = n_lb + n_ulb
        if self.queue_size % n_ins:
            raise ValueError(f"CoMatch's queue of {self.queue_size} rows "
                             f"is not a multiple of the {n_ins} written a "
                             f"step")
        rows = st.queue_ptr + torch.arange(n_ins, device=st.queue_ptr.device)
        queue_feats = st.queue_feats.index_copy(
            0, rows, torch.cat([feats_w, feats_lb.detach()]).float())
        queue_probs = st.queue_probs.index_copy(
            0, rows, torch.cat([probs_orig, F.one_hot(
                b["y_lb"].long(), cfg.num_classes).float()]))
        queue_ptr = (st.queue_ptr + n_ins) % self.queue_size

        unsup_loss = self.consistency_loss(logits_s0, probs, "ce", mask=mask)
        Q = pseudo_label_graph(probs, cfg.contrast_p_cutoff)
        contrast_loss = comatch_contrastive_loss(feats_s0, feats_s1, Q,
                                                 T=cfg.T)
        new_state = CoMatchState(queue_feats, queue_probs, queue_ptr,
                                 da_state)
        fwd = C.ForwardOut(logits_lb, logits_w, logits_s0, feats_lb, feats_w,
                           feats_s0)
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=fwd,
                         new_algo_state=new_state, mask=mask,
                         pseudo_label=probs,
                         extra_loss=cfg.contrast_loss_ratio * contrast_loss,
                         metrics={"contrast_loss": contrast_loss})
