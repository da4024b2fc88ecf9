"""Golden-learning validation (port of ``semireward_tpu/validation.py``):
do the port's algorithms *learn*, not only run?

Minutes-scale synthetic checks with loose but real accuracy bounds, the
same experiments as the JAX package's, on the port's Trainer:

- ``ssl_gain``: an SSL algorithm with unlabeled data beats the same
  configuration with the unlabeled loss zeroed (the label budget held).
- ``sr_noise_experiment``: SemiReward's claim. Under pseudo-label noise
  injected after the pseudo-labels are made, the reward filter recovers
  accuracy against the same noisy base algorithm, and the trained rewarder
  is probed at class level (``rewarder_class_probe``).
- ``imb_gain``: an imbalanced-SSL wrapper against its base algorithm's
  balanced accuracy on a long-tailed split.

The task is ``synthetic_orbit`` (``data/datasets.py:make_synthetic_orbit``)
on a WideResNet of depth 10 and width 2; ``imb_gain`` runs on the blob task
(``dataset='synthetic'``), whose split takes the imbalance ratios. Every
run goes on the card unless the caller passes ``device='cpu'``, and draws
from a CPU generator (``run_golden``).
``python -m semireward_tpu_torch.golden_quality`` writes the sweep's report.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

GOLDEN_NET_KWARGS = {"depth": 10, "widen_factor": 2}  # tiny WRN, 128 feats


# The hard tier: more classes (8, three labels each), a narrower labeled
# wedge (8 degrees), an orbit out to 160 degrees and more pixel noise, so
# that the strongest families do not saturate at 1.0 as they do on the base
# tier. The base tier stays the default.
HARD_TIER = dict(num_classes=8, labels=24, noise=70)
HARD_TIER_EXTRA = dict(orbit_rot_lab=8.0, orbit_rot_max=160.0)


def golden_config(algorithm: str, *, iters: int = 400, labels: int = None,
                  num_classes: int = None, seed: int = 0,
                  lambda_u: float = 1.0,
                  imb_algorithm: Optional[str] = None,
                  lb_imb_ratio: float = 1.0, ulb_imb_ratio: float = 1.0,
                  save_dir: Optional[str] = None, noise: int = None,
                  dataset: str = "synthetic_orbit", tier: str = "base",
                  **overrides):
    """The shared small, learnable synthetic setup. ``lambda_u=0`` turns
    any algorithm into its labeled-only baseline at the same label budget
    ('fullysupervised' would see every label). On ``synthetic_orbit`` the
    labeled data covers only the small-angle end of each class's rotation
    orbit, so the labeled-only ceiling is set by geometry and SSL has room
    at every seed; ``dataset='synthetic'`` is the blob task. ``save_dir``
    defaults to ``srt_golden`` under the temporary directory."""
    from semireward_tpu_torch.config import get_config

    if tier == "hard":
        if dataset != "synthetic_orbit":
            raise ValueError("the hard tier is an orbit tier")
        if num_classes is None:
            num_classes = HARD_TIER["num_classes"]
        if labels is None:
            labels = HARD_TIER["labels"]
        if noise is None:
            noise = HARD_TIER["noise"]
    elif tier != "base":
        raise ValueError(f"unknown golden tier {tier!r}")
    if num_classes is None:
        num_classes = 6 if dataset == "synthetic_orbit" else 4
    if labels is None:
        labels = 24 if dataset == "synthetic_orbit" else 8
    if noise is None:
        noise = 40 if dataset == "synthetic_orbit" else 110
    if save_dir is None:
        save_dir = os.path.join(tempfile.gettempdir(), "srt_golden")
    cfg_dict = dict(
        algorithm=algorithm, ulb_loss_ratio=lambda_u,
        net="wrn_28_2", dataset=dataset,
        num_classes=num_classes, num_labels=labels,
        batch_size=8, uratio=4, eval_batch_size=64, img_size=32,
        num_train_iter=iters, num_eval_iter=iters,
        num_log_iter=max(iters // 2, 1),
        optim="SGD", lr=0.03, ema_m=0.0, p_cutoff=0.95, seed=seed,
        save_dir=save_dir, save_name=f"{algorithm}_{seed}_{lambda_u}",
        imb_algorithm=imb_algorithm or "",
        lb_imb_ratio=lb_imb_ratio, ulb_imb_ratio=ulb_imb_ratio,
        feature_dim=128, mesh_shape=(1,))
    cfg_dict.update(overrides)
    cfg = get_config(cfg_dict)
    # colour RandAugment ops would scramble the colour-defined classes
    cfg.extra.update(synthetic_train=2048, synthetic_test=512,
                     bn_momentum=0.9, synthetic_noise=noise,
                     randaug_no_color=True,
                     net_kwargs=dict(GOLDEN_NET_KWARGS),
                     num_wu_iter=64, num_wu_eval_iter=64)
    if tier == "hard":
        cfg.extra.update(HARD_TIER_EXTRA)
    return cfg


def run_golden(algorithm: str, alg_factory=None, return_trainer=False,
               device=None, rng_device="cpu", **kw) -> Dict[str, Any]:
    """Train ``golden_config(algorithm, **kw)`` on the port's Trainer
    (``alg_factory(cfg, data_info, device)`` builds the algorithm when
    given) and return the final eval's accuracy and balanced accuracy.

    The run draws from a CPU generator (``rng_device``), so a seed names
    one run on the CPU and on the card, as a JAX key does on every backend,
    and the bounds hold the same experiment wherever it runs;
    ``rng_device=None`` draws from the training device's own generator."""
    from semireward_tpu_torch.core.trainer import Trainer

    cfg = golden_config(algorithm, **kw)
    tr = Trainer(cfg, device=device, alg_factory=alg_factory,
                 rng_device=rng_device)
    res = tr.train()
    out = {"acc": res.get("eval/top-1-acc"),
           "balanced_acc": res.get("eval/balanced_acc"),
           "results": res}
    if return_trainer:
        out["trainer"] = tr
    return out


def ssl_gain(algorithm: str, **kw) -> Dict[str, float]:
    """acc(algorithm with ulb) - acc(same config, unsup loss zeroed)."""
    sup = run_golden(algorithm, lambda_u=0.0, **kw)
    ssl = run_golden(algorithm, lambda_u=1.0, **kw)
    return {"algorithm": algorithm, "supervised_acc": sup["acc"],
            "ssl_acc": ssl["acc"], "gain": ssl["acc"] - sup["acc"]}


# ---------------------------------------------------------------------------
# SemiReward under pseudo-label noise
# ---------------------------------------------------------------------------

def _polluted(labels, noise_frac: float, classes):
    """Which rows the noise touches: those whose label is in ``classes``,
    or, with ``classes=None``, the leading ``noise_frac`` of the batch
    (batch order is random each step, so this is uniform noise)."""
    if classes is not None:
        return torch.isin(labels, torch.tensor(list(classes),
                                               device=labels.device))
    n_bad = int(round(labels.shape[0] * noise_frac))
    return torch.arange(labels.shape[0], device=labels.device) < n_bad


def make_noisy_flexmatch(noise_frac: float, classes=None, shift: int = 1):
    """FlexMatch with its pseudo-labels corrupted (shifted ``shift``
    classes) after they are made: a leading ``noise_frac`` of each batch
    with ``classes=None``, else only the pseudo-labels in ``classes``
    (class-conditional noise, the filter the Rewarder can express: see
    ``rewarder_class_probe``). The SemiReward wrapper composes over it
    unchanged, scoring the corrupted labels like any pseudo-label, and
    reports its keep rate on the polluted and the clean rows
    (``sr_keep_polluted``, ``sr_keep_clean``, ``sr_polluted_n``)."""
    from semireward_tpu_torch.algorithms.flexmatch import FlexMatch
    from semireward_tpu_torch.algorithms.semireward import (SR_DEFAULTS,
                                                            SemiRewardWrapper)

    class NoisyFlexMatch(FlexMatch):
        NAME = "flexmatch"  # the SR wrapper picks its remask by base NAME

        def gen_ulb_targets(self, logits, use_hard_label=True, T=1.0,
                            softmax=True, label_smoothing=0.0):
            pl = super().gen_ulb_targets(logits, use_hard_label, T, softmax,
                                         label_smoothing)
            bad = _polluted(pl, noise_frac, classes)
            return torch.where(bad, (pl + shift) % self.cfg.num_classes, pl)

    class SRNoisyFlexMatch(SemiRewardWrapper):
        NAME = "srflexmatch"
        BASE_CLS = NoisyFlexMatch
        DEFAULTS = {**FlexMatch.DEFAULTS, **SR_DEFAULTS}

        def loss(self, ctx):
            out = super().loss(ctx)
            # the keep rate split by whether the noise touched a row (its
            # weak argmax in ``classes``, or among the leading rows): the
            # wrapper's reward and mask2 rule again, a small MLP forward
            fwd = out.fwd
            bad = _polluted(fwd.logits_x_ulb_w.argmax(-1), noise_frac,
                            classes).float()
            pl_int = self._int_labels(out.pseudo_label).long()
            with torch.no_grad():
                reward = ctx.sr_state.rewarder(fwd.feats_x_ulb_w.detach(),
                                               pl_int)
            mask2 = (reward >= reward.mean()).squeeze(-1).float()
            keep = (mask2 if ctx.step > self.cfg.start_timing
                    else torch.ones_like(bad))
            pol_n, cln_n = bad.sum(), (1.0 - bad).sum()
            metrics = dict(out.metrics)
            metrics.update(
                sr_keep_polluted=(keep * bad).sum() / pol_n.clamp(min=1),
                sr_keep_clean=(keep * (1 - bad)).sum() / cln_n.clamp(min=1),
                sr_polluted_n=pol_n)
            return out._replace(metrics=metrics)

    return NoisyFlexMatch, SRNoisyFlexMatch


def _rank(x):
    """Average ranks for ties (the keep-rate vectors are tie-heavy: an
    argsort of an argsort would rank ties by class index)."""
    x = np.asarray(x, np.float64)
    order = np.argsort(x, kind="stable")
    ranks = np.empty_like(x)
    i = 0
    while i < len(x):
        j = i
        while j + 1 < len(x) and x[order[j + 1]] == x[order[i]]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j)
        i = j + 1
    return ranks


def _spearman(a, b) -> float:
    """Spearman rank correlation with tie-corrected (average) ranks."""
    ra, rb = _rank(a), _rank(b)
    ra -= ra.mean()
    rb -= rb.mean()
    den = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / den) if den > 0 else 0.0


def rewarder_class_probe(trainer, batch: int = 64, rounds: int = 16,
                         noise_frac: float = 0.5, classes=None,
                         shift: int = 1) -> Dict[str, Any]:
    """Class-level probe of the trained rewarder. Its reward is
    ``MLP(batch-shared context + label_embedding[label])``: two samples
    with one pseudo-label in a batch get one reward whatever their
    features, so the ``reward >= mean`` filter selects per label. On
    ``rounds`` batches of the eval split (the live weights' features),
    their labels corrupted as the noise does:

    - ``per_label_keep_rate`` / ``per_label_reward``: how the filter treats
      each label value;
    - ``per_label_pair_accuracy``: the share of pairs carrying label c
      whose feature is of class c;
    - ``spearman_reward_vs_accuracy`` / ``spearman_keep_vs_accuracy``: rank
      correlations of the two over the label values seen."""
    from semireward_tpu_torch.algorithms.semireward import score_pseudo_labels
    from semireward_tpu_torch.data.augment import normalize

    cfg = trainer.cfg
    C = cfg.num_classes
    ds = trainer.bundle.eval
    rs = np.random.RandomState(0)
    kept = np.zeros(C)
    rew_sum = np.zeros(C)
    correct = np.zeros(C)
    n = np.zeros(C)
    for _ in range(rounds):
        idx = rs.choice(len(ds), batch, replace=False)
        x = normalize(trainer._to_device(ds.data[idx]), trainer.aug_spec.mean,
                      trainer.aug_spec.std)
        with torch.no_grad():
            feats = trainer.model(x, train=False)["feat"]
        y = np.asarray(ds.targets[idx], np.int64)
        if classes is not None:
            bad = np.isin(y, np.asarray(list(classes)))
        else:
            bad = rs.rand(batch) < noise_frac
        labels = np.where(bad, (y + shift) % C, y)
        reward, keep = score_pseudo_labels(
            trainer.state.sr, feats, torch.as_tensor(labels,
                                                     device=feats.device))
        reward = reward.squeeze(-1).cpu().numpy()
        keep = keep.cpu().numpy()
        for c in range(C):
            sel = labels == c
            if sel.any():
                kept[c] += keep[sel].sum()
                rew_sum[c] += reward[sel].sum()
                correct[c] += (~bad[sel]).sum()
                n[c] += sel.sum()
    nz = np.maximum(n, 1)
    keep_rate = kept / nz
    mean_reward = rew_sum / nz
    pair_acc = correct / nz
    occ = n > 0  # rank correlations over the label values seen only
    polluted = sorted({(c + shift) % C for c in classes}) if classes else None
    out = {
        "per_label_keep_rate": keep_rate.tolist(),
        "per_label_reward": mean_reward.tolist(),
        "per_label_pair_accuracy": pair_acc.tolist(),
        "spearman_reward_vs_accuracy": _spearman(mean_reward[occ],
                                                 pair_acc[occ]),
        "spearman_keep_vs_accuracy": _spearman(keep_rate[occ], pair_acc[occ]),
    }
    out["per_label_count"] = n.tolist()
    if polluted is not None:
        # the shift empties the source labels: only the clean labels seen
        # belong in the comparison
        clean = [c for c in range(C) if c not in polluted and n[c] > 0]
        out["polluted_labels"] = polluted
        out["keep_rate_polluted_labels"] = float(keep_rate[polluted].mean())
        out["keep_rate_clean_labels"] = float(keep_rate[clean].mean())
    return out


def sr_noise_experiment(noise_frac: float = 0.4, iters: int = 500,
                        start_timing: int = 120, seed: int = 0,
                        classes=None, shift: int = 1,
                        **kw) -> Dict[str, Any]:
    """SemiReward's experiment: corrupt the pseudo-labels (uniformly, or
    class-conditionally with ``classes``), train the same noisy FlexMatch
    with and without the reward filter, and probe the trained rewarder at
    class level."""
    NoisyFlex, SRNoisyFlex = make_noisy_flexmatch(noise_frac, classes=classes,
                                                  shift=shift)
    base = run_golden(
        "flexmatch", alg_factory=lambda c, d, dev: NoisyFlex(c, d, dev),
        iters=iters, seed=seed, **kw)
    sr = run_golden(
        "srflexmatch", alg_factory=lambda c, d, dev: SRNoisyFlex(c, d, dev),
        iters=iters, seed=seed, start_timing=start_timing, N_k=10,
        return_trainer=True, **kw)
    probe = rewarder_class_probe(sr["trainer"], noise_frac=noise_frac,
                                 classes=classes, shift=shift)
    return {"noise_frac": noise_frac,
            "corrupt_classes": list(classes) if classes else None,
            "shift": shift,
            "noisy_flexmatch_acc": base["acc"],
            "sr_noisy_flexmatch_acc": sr["acc"],
            "sr_gain": sr["acc"] - base["acc"], **probe}


# ---------------------------------------------------------------------------
# Imbalanced tier
# ---------------------------------------------------------------------------

def imb_gain(imb_algorithm: str, base_algorithm: str = "fixmatch",
             gamma: float = 10.0, iters: int = 500, labels: int = 40,
             num_classes: int = 4, **kw) -> Dict[str, float]:
    """balanced_acc(imb_algorithm over base) - balanced_acc(base) on a
    long-tailed split (labeled and unlabeled imbalanced by ``gamma``) of
    the blob task, whose loader takes the imbalanced split (the orbit task
    makes balanced coverage splits)."""
    # in the imbalanced setting lb / ulb_num_labels are the head class's
    # counts
    shared = dict(labels=labels, num_classes=num_classes, iters=iters,
                  dataset=kw.pop("dataset", "synthetic"),
                  lb_imb_ratio=gamma, ulb_imb_ratio=gamma,
                  ulb_num_labels=int(kw.pop("ulb_num_labels", 400)), **kw)
    base = run_golden(base_algorithm, **shared)
    imb = run_golden(base_algorithm, imb_algorithm=imb_algorithm, **shared)
    return {"imb_algorithm": imb_algorithm, "base": base_algorithm,
            "gamma": gamma,
            "base_balanced_acc": base["balanced_acc"],
            "imb_balanced_acc": imb["balanced_acc"],
            "gain": imb["balanced_acc"] - base["balanced_acc"]}
