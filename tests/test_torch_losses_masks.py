"""Losses and masks of the port against the JAX package on the same inputs
(numpy, seeded): ce_loss, consistency_loss with mask/mask2, gen_ulb_targets,
fixed_threshold_mask and K-step FlexMatch flex_mask trajectories.

Float results: 1e-6 of the largest magnitude (float32, sums in another
order). Integer state (selected_label, hard pseudo labels) and masks:
exact. classwise_acc is a ratio of the same integer counts: exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_rel_close
from semireward_tpu.algorithms import common as JC
from semireward_tpu.core import losses as JL
from semireward_tpu_torch.algorithms import common as TC
from semireward_tpu_torch.core import losses as TL

B, NC = 16, 10


def _logits(seed, scale=3.0):
    return (np.random.RandomState(seed).randn(B, NC) * scale).astype(np.float32)


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_ce_loss(soft, reduction):
    lg = _logits(0)
    rs = np.random.RandomState(1)
    tgt = (np.abs(rs.randn(B, NC)).astype(np.float32) if soft
           else rs.randint(0, NC, B))
    if soft:
        tgt /= tgt.sum(-1, keepdims=True)
    want = JL.ce_loss(jnp.asarray(lg), jnp.asarray(tgt), reduction)
    got = TL.ce_loss(torch.from_numpy(lg), torch.from_numpy(tgt), reduction)
    assert_rel_close(got, want, 1e-6)


@pytest.mark.parametrize("name", ["ce", "mse", "l1"])
def test_consistency_loss_with_masks(name):
    lg = _logits(2)
    rs = np.random.RandomState(3)
    tgt = (rs.randint(0, NC, B) if name == "ce"
           else rs.rand(B, NC).astype(np.float32))
    mask = (rs.rand(B) > 0.4).astype(np.float32)
    mask2 = (rs.rand(B) > 0.5).astype(np.float32)
    for m, m2 in ((None, None), (mask, None), (mask, mask2)):
        want = JL.consistency_loss(jnp.asarray(lg), jnp.asarray(tgt), name,
                                   None if m is None else jnp.asarray(m),
                                   None if m2 is None else jnp.asarray(m2))
        got = TL.consistency_loss(torch.from_numpy(lg), torch.from_numpy(tgt),
                                  name,
                                  None if m is None else torch.from_numpy(m),
                                  None if m2 is None else torch.from_numpy(m2))
        assert_rel_close(got, want, 1e-6)


@pytest.mark.parametrize("hard,smooth", [(True, 0.0), (True, 0.1),
                                         (False, 0.0)])
def test_gen_ulb_targets(hard, smooth):
    lg = _logits(4)
    want = np.asarray(JL.gen_ulb_targets(jnp.asarray(lg), hard, 0.5, True,
                                         smooth))
    got = TL.gen_ulb_targets(torch.from_numpy(lg), hard, 0.5, True,
                             smooth).numpy()
    if hard and not smooth:
        np.testing.assert_array_equal(got, want)
    else:
        assert_rel_close(got, want, 1e-6)


def test_fixed_threshold_mask_exact():
    probs = np.array(JC.compute_prob(jnp.asarray(_logits(5))))
    want = np.asarray(JC.fixed_threshold_mask(jnp.asarray(probs), 0.6))
    got = TC.fixed_threshold_mask(torch.from_numpy(probs), 0.6).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < B


@pytest.mark.parametrize("thresh_warmup", [True, False])
def test_flex_mask_trajectory_exact(thresh_warmup):
    """K steps of curriculum masking over a 40-sample unlabeled set; the
    probabilities are sharp enough that some rows pass the cutoff."""
    n_ulb, K = 40, 8
    rs = np.random.RandomState(6)
    js = JC.flex_init(n_ulb, NC)
    ts = TC.flex_init(n_ulb, NC)
    for k in range(K):
        lg = (rs.randn(B, NC) * 4.0).astype(np.float32)
        probs = np.array(JC.compute_prob(jnp.asarray(lg)))
        idx = rs.choice(n_ulb, B, replace=False).astype(np.int32)
        js, jm = JC.flex_mask(js, jnp.asarray(probs), jnp.asarray(idx), 0.9,
                              thresh_warmup)
        ts, tm = TC.flex_mask(ts, torch.from_numpy(probs),
                              torch.from_numpy(idx), 0.9, thresh_warmup)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(ts.selected_label.numpy(),
                                      np.asarray(js.selected_label))
        np.testing.assert_array_equal(ts.classwise_acc.numpy(),
                                      np.asarray(js.classwise_acc))
    assert (np.asarray(js.selected_label) >= 0).sum() > 0
    assert np.asarray(js.classwise_acc).max() > 0
