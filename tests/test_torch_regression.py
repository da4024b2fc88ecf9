"""The regression task in the port (``num_classes`` 1: ``core/losses.py``'s
regression losses, the regression branches of FullySupervised, PseudoLabel
and SemiReward, the ``agedb`` / ``imdb_wiki`` / ``rcf_mnist`` npz sets, the
Trainer's regression eval) held against the JAX package on the same seeded
numpy inputs.

- Each regression loss and alias, each reduction, within 1e-6 of the
  largest magnitude (float32; bfloat16 logits are taken in float32, the
  targets reshaped to the logits).
- The three sets' splits (labeled, unlabeled, eval; with and without
  ``include_lb_to_ulb``) bit-equal to JAX's, float32 targets.
- Three steps of FullySupervised and PseudoLabel and four of
  SRPseudoLabel (stage 1, then stage 2 with the filter) on the
  2-block ViT of ``test_torch_step.py`` with one output, from the same
  weights on the same views and float targets, with
  ``run_three_sr_steps``' tolerances: losses 1e-5 of their magnitude,
  ``util_ratio`` and ``sr_keep_ratio`` exact, every parameter, the EMA and
  the rewarder as ``_check_leaf`` holds them. PseudoLabel's noise is JAX's
  own draw, recomputed from the step's key and injected
  (``pseudolabel.draw_noise``). SRPseudoLabel shows the JAX package's
  arithmetic: every sample's pseudo class is the one-column argmax, 0, so
  every sample takes one reward and the stage-2 filter keeps all of them
  (``sr_keep_ratio`` 1.0 in this run; none where the float32 mean of the
  equal rewards rounds above them, which happens in both packages);
  stage 1 trains the rewarder against one-hots over ``extra['range']``
  values.
- ``sr_per_sample`` on a regression task raises ``ValueError`` in both.

The Trainer and the eval CLI on a regression set:
``tests/test_torch_regression_trainer.py``.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_rel_close
from semireward_tpu.config import get_config as jax_config
from semireward_tpu.core import losses as jlosses
from semireward_tpu.core.step import init_train_state as jax_init
from semireward_tpu.core.step import make_train_step as jax_make_step
from semireward_tpu.data import datasets as jdatasets
from semireward_tpu.models import vit as jvit
from semireward_tpu.registry import ALGORITHMS as JALGS
from semireward_tpu_torch.algorithms import pseudolabel as tpl
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.convert import load_flax_params
from semireward_tpu_torch.core import losses as tlosses
from semireward_tpu_torch.core.step import init_train_state as torch_init
from semireward_tpu_torch.core.step import make_train_step as torch_make_step
from semireward_tpu_torch.data import datasets as tdatasets
from semireward_tpu_torch.models import vit as tvit
from semireward_tpu_torch.registry import ALGORITHMS as TALGS
from test_torch_step import ARCH, B, CFG, S, _check_leaf, _flat, _perturb

@pytest.mark.parametrize("mode", sorted(jlosses._REG_LOSSES))
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_regression_losses_match_jax(mode, reduction):
    rs = np.random.RandomState(0)
    logits = (rs.randn(8, 1) * 3).astype(np.float32)
    target = (rs.randn(8) * 3).astype(np.float32)      # reshaped to [8, 1]
    want = jlosses.reg_loss(jnp.asarray(logits), jnp.asarray(target), mode,
                            reduction)
    got = tlosses.reg_loss(torch.from_numpy(logits), torch.from_numpy(target),
                           mode, reduction)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert_rel_close(got, np.asarray(want), 1e-6, mode)
    # bf16 logits are taken in float32 on both sides
    want = jlosses.reg_loss(jnp.asarray(logits, jnp.bfloat16),
                            jnp.asarray(target), mode, reduction)
    got = tlosses.reg_loss(torch.from_numpy(logits).bfloat16(),
                           torch.from_numpy(target), mode, reduction)
    assert got.dtype == torch.float32
    assert_rel_close(got, np.asarray(want), 1e-6, mode)


@pytest.mark.parametrize("activate", ["sigmoid", "tanh"])
def test_focal_losses_take_their_options_as_jax(activate):
    rs = np.random.RandomState(1)
    logits = rs.randn(6, 1).astype(np.float32) * 4
    target = rs.randn(6, 1).astype(np.float32) * 4
    for mode in ("focal_l1_loss", "focal_l2_loss"):
        want = jlosses.reg_loss(jnp.asarray(logits), jnp.asarray(target),
                                mode, activate=activate, beta=0.5, gamma=2.0)
        got = tlosses.reg_loss(torch.from_numpy(logits),
                               torch.from_numpy(target), mode,
                               activate=activate, beta=0.5, gamma=2.0)
        assert_rel_close(got, np.asarray(want), 1e-6, mode)
    want = jlosses.reg_loss(jnp.asarray(logits), jnp.asarray(target),
                            "huber_loss", beta=2.0)
    got = tlosses.reg_loss(torch.from_numpy(logits), torch.from_numpy(target),
                           "huber_loss", beta=2.0)
    assert_rel_close(got, np.asarray(want), 1e-6)


def _write_npz(root, name, n_train=40, n_test=12, size=8, seed=0):
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, name), exist_ok=True)
    np.savez(os.path.join(root, name, f"{name}.npz"),
             train_x=rs.randint(0, 255, (n_train, size, size, 3), np.uint8),
             train_y=rs.uniform(1, 90, n_train),              # float64
             test_x=rs.randint(0, 255, (n_test, size, size, 3), np.uint8),
             test_y=rs.uniform(1, 90, n_test).astype(np.float32))


@pytest.mark.parametrize("name", ["agedb", "imdb_wiki", "rcf_mnist"])
@pytest.mark.parametrize("include", [True, False])
def test_regression_splits_are_bit_equal(tmp_path, name, include):
    _write_npz(str(tmp_path), name)
    kw = dict(dataset=name, data_dir=str(tmp_path), num_classes=1,
              num_labels=8, seed=3, include_lb_to_ulb=include)
    jb = jdatasets.get_dataset(jax_config(**kw))
    tb = tdatasets.get_dataset(torch_config(**kw))
    assert tb.num_classes == jb.num_classes == 1
    assert tb.mean == jb.mean and tb.std == jb.std
    assert len(tb.train_lb) == 8
    assert len(tb.train_ulb) == (40 if include else 32)
    for split in ("train_lb", "train_ulb", "eval"):
        for k in ("data", "targets"):
            got = getattr(getattr(tb, split), k)
            want = getattr(getattr(jb, split), k)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert getattr(tb, split).targets.dtype == np.float32


def test_seeded_writer_gives_the_npz_layout(tmp_path):
    path = tdatasets.write_synthetic_regression(str(tmp_path), "agedb",
                                                n_train=6, n_test=3, size=16)
    assert path == os.path.join(str(tmp_path), "agedb", "agedb.npz")
    d = np.load(path)
    assert d["train_x"].shape == (6, 16, 16, 3)
    assert d["train_x"].dtype == np.uint8
    assert d["test_y"].dtype == np.float32 and d["test_y"].shape == (3,)
    assert 1.0 <= d["train_y"].min() and d["train_y"].max() < 101.0
    again = tdatasets.write_synthetic_regression(
        str(tmp_path / "b"), "agedb", n_train=6, n_test=3, size=16)
    for k in d.files:
        np.testing.assert_array_equal(np.load(again)[k], d[k])


# ---------------------------------------------------------------------------
# three-step trajectories
# ---------------------------------------------------------------------------

REG_CFG = dict(CFG, num_classes=1, p_cutoff=0.95, unsup_warm_up=0.4)
DATA_INFO = {"ulb_dest_len": 16, "lb_dest_len": 8}


def _jax_noise(jstate, step, shape):
    """PseudoLabel's regression noise in the JAX step: the third key of the
    step key's split, times 0.05."""
    key = jax.random.split(jax.random.fold_in(jstate.rng, step), 3)[2]
    return np.asarray(jax.random.normal(key, shape, jnp.float32) * 0.05)


def run_regression_steps(name, monkeypatch, steps=3, over=None,
                         trained_at=()):
    """``steps`` steps of ``name`` in both packages on one-output nets from
    the same weights on the same views and float targets, ``over`` on top
    of ``REG_CFG``; compared after each step (module docstring), the
    rewarder moved at the steps ``trained_at`` and only there. Returns the
    metrics of both."""
    cfg = dict(REG_CFG, algorithm=name, **(over or {}))
    jcfg, tcfg = jax_config(**cfg), torch_config(**cfg)
    assert jcfg.is_regression and tcfg.is_regression
    jalg = JALGS.get(name)(jcfg, DATA_INFO)
    talg = TALGS.get(name)(tcfg, DATA_INFO, torch.device("cpu"))
    jmodel = jvit.vit_small_patch2_32(num_classes=1, dtype=jnp.float32,
                                      **ARCH)
    jstate, tx = jax_init(jcfg, jalg, jmodel, jax.random.PRNGKey(0),
                          jnp.zeros((2, S, S, 3)),
                          builder=jvit.vit_small_patch2_32)
    params = _perturb(jstate.params, 0.02)
    jstate = jstate.replace(params=params, ema_params=params)
    jstep = jax.jit(jax_make_step(jcfg, jalg, jmodel, tx))
    tmodel = tvit.vit_small_patch2_32(num_classes=1, dtype=torch.float32,
                                      **ARCH)
    load_flax_params(tmodel, jax.device_get(params))
    tstate = torch_init(tcfg, talg, tmodel, builder=tvit.vit_small_patch2_32)
    sr = getattr(talg, "HAS_SR", False)
    if sr:
        load_flax_params(tstate.sr.rewarder,
                         jax.device_get(jstate.sr.rewarder_params))
        load_flax_params(tstate.sr.generator,
                         jax.device_get(jstate.sr.gen_params))
    tstep = torch_make_step(tcfg, talg)
    noise = {}
    monkeypatch.setattr(tpl, "draw_noise", lambda x, g: noise["x"])

    rs = np.random.RandomState(0)
    names = [n for n, _ in tmodel.named_parameters()]
    seen = []
    for step in range(steps):
        views = {k: rs.randn(B, S, S, 3).astype(np.float32)
                 for k in ("x_lb", "x_ulb_w")}
        views = {k: v for k, v in views.items() if k in talg.BATCH_KEYS}
        y = rs.uniform(1.0, 101.0, B).astype(np.float32)
        idx = rs.choice(DATA_INFO["ulb_dest_len"], B, replace=False)
        jbatch = {**{k: jnp.asarray(v) for k, v in views.items()},
                  "y_lb": jnp.asarray(y), "idx_ulb": jnp.asarray(idx,
                                                                 jnp.int32)}
        tbatch = {**{k: torch.from_numpy(v) for k, v in views.items()},
                  "y_lb": torch.from_numpy(y),
                  "idx_ulb": torch.from_numpy(idx)}
        if "x_ulb_w" in views:
            noise["x"] = torch.from_numpy(
                _jax_noise(jstate, step, views["x_ulb_w"].shape).copy())
        rewarder_before = ([p.detach().clone()
                            for p in tstate.sr.rewarder.parameters()]
                           if sr else [])
        jstate, jm = jstep(jstate, jbatch)
        tm = tstep(tstate, tbatch)
        assert sorted(tm) == sorted(jm), (sorted(tm), sorted(jm))
        for k, v in jm.items():
            if k in ("util_ratio", "sr_keep_ratio"):
                assert float(tm[k]) == float(v), (step, k)
            elif k == "max_reward":
                jmax, tmax = float(v), float(tm[k])
                assert (jmax == tmax == -math.inf) or abs(jmax - tmax) < 1e-5
            else:
                assert_rel_close(tm[k], np.asarray(v), 1e-5, f"{step} {k}")
        seen.append((tm, jm))
        bound = 2 * REG_CFG["lr"] * (step + 1) + 1e-6
        want, want_ema = _flat(jstate.params), _flat(jstate.ema_params)
        for n, p, e in zip(names, tmodel.parameters(), tstate.ema):
            _check_leaf(n, p.detach().numpy(), want[n], bound)
            _check_leaf(n, e.numpy(), want_ema[n], bound)
        if sr:
            want_r = _flat(jstate.sr.rewarder_params)
            for n, p in tstate.sr.rewarder.named_parameters():
                _check_leaf(n, p.detach().numpy(), want_r[n], bound)
            moved = any(not torch.equal(a, b) for a, b in
                        zip(rewarder_before, tstate.sr.rewarder.parameters()))
            assert moved == (step in trained_at), step
    assert tstate.step == steps and int(jstate.step) == steps
    return seen


def test_three_fullysupervised_regression_steps_match_jax(monkeypatch):
    seen = run_regression_steps("fullysupervised", monkeypatch)
    # an L1 loss of targets in [1, 101) against near-zero outputs
    assert all(float(tm["sup_loss"]) > 10.0 for tm, _ in seen)
    assert all(float(tm["unsup_loss"]) == 0.0 for tm, _ in seen)


def test_three_pseudolabel_regression_steps_match_jax(monkeypatch):
    seen = run_regression_steps("pseudolabel", monkeypatch)
    for tm, _ in seen:
        assert float(tm["util_ratio"]) == 1.0          # the mask of ones
        assert 0.0 < float(tm["unsup_loss"]) < 1.0     # L1 of the noise's effect


def test_three_srpseudolabel_regression_steps_match_jax(monkeypatch):
    """At ``start_timing`` 2 and ``N_k`` 1: step 1 trains the rewarder in
    stage 1 (one-hots over ``extra['range']``), step 2 tracks the reward,
    step 3 applies the filter and trains it in stage 2 (four steps)."""
    seen = run_regression_steps("srpseudolabel", monkeypatch, steps=4,
                                over={"start_timing": 2}, trained_at=(1, 3))
    # the filter keeps every sample: one pseudo class, one reward
    assert [float(jm["sr_keep_ratio"]) for _, jm in seen] == [1.0] * 4
    assert math.isfinite(float(seen[2][0]["max_reward"]))


def test_unlabeled_forwards_share_their_masks(monkeypatch):
    """The noisy and the clean unlabeled forwards draw one set of dropout
    and drop-path masks (JAX gives both ``k_ulb``): with drop path on and
    zero noise the pseudo label equals the noisy forward's logits."""
    cfg = torch_config(**dict(REG_CFG, algorithm="pseudolabel"))
    alg = TALGS.get("pseudolabel")(cfg, DATA_INFO, torch.device("cpu"))
    model = tvit.vit_small_patch2_32(
        num_classes=1, dtype=torch.float32,
        generator=torch.Generator().manual_seed(0),
        **dict(ARCH, drop_path_rate=0.5, depth=4))
    monkeypatch.setattr(tpl, "draw_noise", lambda x, g: torch.zeros_like(x))
    rs = np.random.RandomState(0)
    batch = {"x_lb": torch.from_numpy(rs.randn(B, S, S, 3).astype(np.float32)),
             "x_ulb_w": torch.from_numpy(
                 rs.randn(B, S, S, 3).astype(np.float32)),
             "y_lb": torch.from_numpy(rs.uniform(1, 101, B).astype(
                 np.float32))}
    from semireward_tpu_torch.algorithms.base import StepCtx

    gen = torch.Generator().manual_seed(1)
    out = alg.loss(StepCtx(model=model, batch=batch, algo_state=(),
                           generator=gen, step=5, sr_state=None, ema=None))
    assert torch.equal(out.pseudo_label, out.fwd.logits_x_ulb_w.detach())
    assert float(out.unsup_loss.detach()) == 0.0
    # a fresh draw would differ: the masks are not all kept
    other = model(batch["x_ulb_w"], train=True, generator=gen)["logits"]
    assert not torch.equal(other, out.pseudo_label)


def test_the_filter_keeps_all_or_none_of_equal_rewards():
    """One reward for every sample (the one-column pseudo label's class 0):
    ``reward >= reward.mean()`` keeps all of them where the float32 mean
    of the equal values rounds to them, and none where it rounds above
    them. Both happen in both packages over 16 equal values."""
    seen = {"torch": set(), "jax": set()}
    for v in np.random.RandomState(0).uniform(0.3, 0.7, 200).astype(
            np.float32):
        t = torch.full((16, 1), float(v))
        seen["torch"].add(float((t >= t.mean()).float().mean()))
        j = jnp.full((16, 1), v)
        seen["jax"].add(float((j >= j.mean()).astype(jnp.float32).mean()))
    assert seen == {"torch": {0.0, 1.0}, "jax": {0.0, 1.0}}


def test_sr_per_sample_refuses_regression_in_both():
    kw = dict(REG_CFG, algorithm="srpseudolabel", sr_per_sample=True)
    with pytest.raises(ValueError, match="regression"):
        JALGS.get("srpseudolabel")(jax_config(**kw), DATA_INFO)
    with pytest.raises(ValueError, match="regression"):
        TALGS.get("srpseudolabel")(torch_config(**kw), DATA_INFO)
