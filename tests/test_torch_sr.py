"""SemiReward of the port against the JAX package: the Rewarder (faithful
batch-dim cross-attention) and score_pseudo_labels on converted weights, and
sr_update over K steps across the stage boundary (stage 1 every step,
stage 2 max-reward tracking with an N_k rewarder update, EMA shadow).

Tolerances: float32, sums in another order. Rewards: 1e-6. After Adam steps
on the same gradients: 1e-5 of each leaf's largest magnitude. Keep masks and
max_reward's -inf resets: exact.

One leaf is exempt: ``cross_attention_fc.bias``. The softmax over the batch
is shift-invariant, so its true gradient is zero and both sides step on
rounding noise, which Adam scales up to +-lr per step; the value never
changes the rewards. It is held to that bound instead.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import assert_rel_close
from semireward_tpu.algorithms import semireward as JSR
from semireward_tpu.config import get_config as jax_config
from semireward_tpu.registry import ALGORITHMS as JALGS
from semireward_tpu_torch.algorithms import semireward as TSR
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.convert import flax_to_torch, load_flax_params
from semireward_tpu_torch.registry import ALGORITHMS as TALGS

B, FD, NC = 8, 32, 10
CFG = dict(algorithm="srflexmatch", num_classes=NC, feature_dim=FD,
           start_timing=3, N_k=2, sr_ema=True, sr_ema_m=0.9,
           num_train_iter=50, sr_lr=0.01)
DATA_INFO = {"ulb_dest_len": 64, "lb_dest_len": 32}
NOISE_LEAF = "cross_attention_fc.bias"


def _pair():
    jcfg, tcfg = jax_config(**CFG), torch_config(**CFG)
    jsr = JSR.init_sr_state(jcfg, jax.random.PRNGKey(0))
    # the flax init zeroes biases; perturb so every parameter matters
    perturb = lambda t: jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(
            np.random.RandomState(p.size % 991).randn(*p.shape), p.dtype), t)
    jsr = jsr.replace(rewarder_params=perturb(jsr.rewarder_params),
                      gen_params=perturb(jsr.gen_params))
    jsr = jsr.replace(rewarder_ema_params=jsr.rewarder_params)
    tsr = TSR.init_sr_state(tcfg)
    load_flax_params(tsr.rewarder, jax.device_get(jsr.rewarder_params))
    load_flax_params(tsr.generator, jax.device_get(jsr.gen_params))
    tsr.rewarder_ema = [p.detach().clone() for p in tsr.rewarder.parameters()]
    return jcfg, tcfg, jsr, tsr


def _flat(tree):
    return flax_to_torch(jax.tree_util.tree_map(np.asarray, tree))


def test_rewarder_and_scoring_match():
    jcfg, _, jsr, tsr = _pair()
    rs = np.random.RandomState(1)
    feats = rs.randn(B, FD).astype(np.float32)
    labels = rs.randint(0, NC, B)
    jr, jkeep = JSR.score_pseudo_labels(jcfg, jsr, jnp.asarray(feats),
                                        jnp.asarray(labels))
    tr, tkeep = TSR.score_pseudo_labels(tsr, torch.from_numpy(feats),
                                        torch.from_numpy(labels))
    assert_rel_close(tr, np.asarray(jr), 1e-6)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert 0 < float(np.asarray(jkeep).sum()) < B


def test_sr_update_trajectory_across_stages():
    jcfg, tcfg, jsr, tsr = _pair()
    jalg = JALGS.get("srflexmatch")(jcfg, DATA_INFO)
    talg = TALGS.get("srflexmatch")(tcfg, DATA_INFO, torch.device("cpu"))

    @jax.jit
    def jax_update(sr, fl, fu, pl, y, step):
        out = SimpleNamespace(fwd=SimpleNamespace(feats_x_lb=fl,
                                                  feats_x_ulb_w=fu),
                              pseudo_label=pl)
        return jalg.sr_update(sr, out, {"y_lb": y}, step,
                              jax.random.PRNGKey(0))[0]

    rs = np.random.RandomState(2)
    names = [n for n, _ in tsr.rewarder.named_parameters()]
    trained = 0
    for step in range(7):  # stage 1: 1, 2; stage 2: 3..6, N_k updates at 4, 6
        fl = rs.randn(B, FD).astype(np.float32)
        fu = rs.randn(B, FD).astype(np.float32)
        pl = rs.randint(0, NC, B)
        y = rs.randint(0, NC, B)
        tout = SimpleNamespace(fwd=SimpleNamespace(
            feats_x_lb=torch.from_numpy(fl), feats_x_ulb_w=torch.from_numpy(fu)),
            pseudo_label=torch.from_numpy(pl))
        before = [p.detach().clone() for p in tsr.rewarder.parameters()]
        jsr = jax_update(jsr, jnp.asarray(fl), jnp.asarray(fu),
                         jnp.asarray(pl, jnp.int32), jnp.asarray(y),
                         jnp.asarray(step, jnp.int32))
        talg.sr_update(tsr, tout, {"y_lb": torch.from_numpy(y)}, step)
        trained += any(not torch.equal(a, b) for a, b in
                       zip(before, tsr.rewarder.parameters()))

        want = _flat(jsr.rewarder_params)
        adam = jsr.rewarder_opt[0]
        mu, nu = _flat(adam.mu), _flat(adam.nu)
        ema = _flat(jsr.rewarder_ema_params)
        assert int(adam.count) == tsr.rewarder_opt.count
        for n, p, m, v, e in zip(names, tsr.rewarder.parameters(),
                                 tsr.rewarder_opt.mu, tsr.rewarder_opt.nu,
                                 tsr.rewarder_ema):
            if n == NOISE_LEAF:
                bound = 2 * CFG["sr_lr"] * tsr.rewarder_opt.count + 1e-6
                assert abs(float(p.detach()) - float(want[n][0])) <= bound
                continue
            assert_rel_close(p, want[n], 1e-5, f"step {step} {n}")
            assert_rel_close(m, mu[n], 1e-5, f"step {step} mu {n}")
            assert_rel_close(v, nu[n], 1e-5, f"step {step} nu {n}")
            assert_rel_close(e, ema[n], 1e-5, f"step {step} ema {n}")
        jmax, tmax = float(jsr.max_reward), float(tsr.max_reward)
        assert (jmax == tmax == -np.inf) or abs(jmax - tmax) < 1e-6, \
            (step, jmax, tmax)
        # the generator never moves
        gen = _flat(jsr.gen_params)
        for n, p in tsr.generator.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), gen[n])
    assert trained == 4  # steps 1, 2 (stage 1) and 4, 6 (N_k in stage 2)
