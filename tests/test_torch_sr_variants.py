"""FreeMatch, SoftMatch and PseudoLabel and their SemiReward variants in the
port, held against the JAX package on the same inputs (numpy, seeded).

- The state and mask functions (``free_mask``, ``free_entropy_loss``,
  ``softmatch_mask`` global and per class, ``dist_align_ema``), K steps
  each: masks and histograms exact, the rest within 1e-6 of the largest
  magnitude (float32, sums in another order).
- The stateful remask: the port's closed form (``free_mask`` and
  ``softmatch_mask`` with ``repeat=n``) against the JAX wrapper's ``fori_loop`` over
  the same hook. At n = 8 and 11: state within 1e-6, FreeMatch's mask
  exact, SoftMatch's weights within 1e-6. At n = 18,619 the float32 loop
  has stalled near its fixed point: each step moves a statistic by
  ``(1 - m) (t - s)`` through two roundings (the product and the sum, half
  an ulp each), so once that is below an ulp the value stops moving, up to
  ``ulp / (1 - m)`` from the recurrence's exact value (1000 ulp at m =
  0.999, ~6e-5 of a value in [0.5, 1)). There the closed form is held to
  the exact recurrence run in float64 (1e-6) and to the JAX loop within
  that stall band; FreeMatch's mask stays exact, and SoftMatch's weights
  are held on each side to the weights of that side's state (JAX's to its
  stalled one, the port's to the exact one), within 1e-6.
- Three-step ``srfreematch``, ``srsoftmatch`` and ``srpseudolabel``
  trajectories on the 2-block ViT of ``test_torch_step.py`` with that
  file's tolerances (stage 1, the stage boundary, then the reward filter
  with the remask and an N_k rewarder update).
- SemiReward's two other modes, three-step ``srflexmatch`` trajectories
  on the same ViT and tolerances: ``sr_per_sample`` in stage 1 and in
  stage 2 (JAX's negative candidates injected), and ``sr_reforward`` 3 in
  stage 2; on the small WRN, one ``sr_reforward`` loss leaves the
  BatchNorm running statistics where JAX's leaves them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_rel_close
from semireward_tpu.algorithms import common as JC
from semireward_tpu_torch.algorithms import common as TC
from semireward_tpu_torch.algorithms import semireward as tsr
from test_torch_step import EMB as EMB_STEP
from test_torch_step import NC as NC_STEP
from test_torch_step import run_three_sr_steps

BU, NCU = 16, 10


def _probs(seed, scale=3.0):
    lg = (np.random.RandomState(seed).randn(BU, NCU) * scale).astype(
        np.float32)
    e = np.exp(lg - lg.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _same_free(t_state, j_state, rel=1e-6):
    for k in ("p_model", "label_hist", "time_p"):
        assert_rel_close(getattr(t_state, k), getattr(j_state, k), rel, k)


@pytest.mark.parametrize("use_quantile,clip_thresh",
                         [(False, False), (True, False), (False, True)])
def test_free_mask_steps(use_quantile, clip_thresh):
    j, t = JC.free_init(NCU), TC.free_init(NCU)
    mixed = False
    for step in range(4):
        p = _probs(step, scale=1.0 + step)
        j, jm = JC.free_mask(j, jnp.asarray(p), 0.5, use_quantile,
                             clip_thresh)
        t, tm = TC.free_mask(t, _t(p), 0.5, use_quantile, clip_thresh)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        _same_free(t, j)
        mixed |= 0 < float(tm.mean()) < 1
    assert mixed


@pytest.mark.parametrize("n_sel", ["some", "none"])
def test_free_entropy_loss(n_sel):
    rs = np.random.RandomState(3)
    lg = (rs.randn(BU, NCU) * 2).astype(np.float32)
    mask = ((rs.rand(BU) > 0.5) if n_sel == "some"
            else np.zeros(BU, bool)).astype(np.float32)
    pm = _probs(4).mean(0)
    lh = np.bincount(rs.randint(0, NCU - 2, 64), minlength=NCU) / 64.0
    lh = lh.astype(np.float32)  # two empty classes: inv0's zero branch
    want = JC.free_entropy_loss(jnp.asarray(mask), jnp.asarray(lg),
                                jnp.asarray(pm), jnp.asarray(lh))
    lt = _t(lg).requires_grad_()
    got = TC.free_entropy_loss(_t(mask), lt, _t(pm), _t(lh))
    assert_rel_close(got, want, 1e-6)
    jg = jax.grad(lambda x: JC.free_entropy_loss(
        jnp.asarray(mask), x, jnp.asarray(pm), jnp.asarray(lh)))(
        jnp.asarray(lg))
    (tg,) = torch.autograd.grad(got, lt)
    if n_sel == "none":
        assert float(got) == 0.0 and not tg.any()
    else:
        assert_rel_close(tg, jg, 1e-5, "grad")


@pytest.mark.parametrize("per_class", [False, True])
def test_softmatch_mask_steps(per_class):
    j = JC.softmatch_init(NCU, per_class)
    t = TC.softmatch_init(NCU, per_class)
    soft = False
    for step in range(4):
        p = _probs(10 + step, scale=1.0 + step)
        j, jm = JC.softmatch_mask(j, jnp.asarray(p), 2, 0.5, per_class)
        t, tm = TC.softmatch_mask(t, _t(p), 2, 0.5, per_class)
        assert_rel_close(tm, jm, 1e-6, "weights")
        assert_rel_close(t.prob_max_mu_t, j.prob_max_mu_t, 1e-6, "mu")
        assert_rel_close(t.prob_max_var_t, j.prob_max_var_t, 1e-6, "var")
        soft |= float(tm.min()) < 1.0
    assert soft


@pytest.mark.parametrize("update_target", [False, True])
def test_dist_align_ema_steps(update_target):
    j, _ = JC.dist_align_ema_init(NCU, update_target=update_target)
    t, _ = TC.dist_align_ema_init(NCU, update_target=update_target)
    for step in range(3):
        pu, pl = _probs(20 + step), _probs(30 + step)
        j, ja = JC.dist_align_ema(j, jnp.asarray(pu), jnp.asarray(pl), 0.9,
                                  update_target)
        t, ta = TC.dist_align_ema(t, _t(pu), _t(pl), 0.9, update_target)
        assert_rel_close(ta, ja, 1e-6, "aligned")
        assert_rel_close(t.p_model, j.p_model, 1e-6, "p_model")
        assert_rel_close(t.p_target, j.p_target, 1e-6, "p_target")
        assert bool(t.initialized)


def _jax_loop(hook, state, n):
    """The JAX wrapper's stateful remask: the hook once, then n - 1 more
    times in a fori_loop (semireward_tpu/algorithms/semireward.py)."""
    @jax.jit
    def run(st):
        st0, m0 = hook(st)
        return jax.lax.fori_loop(1, n, lambda _, c: hook(c[0]), (st0, m0))
    return run(state)


def _f64_loop(s0, t, m, n):
    """The recurrence the float32 step computes, in float64: its constants
    are m and 1 - m as float32 holds them."""
    a, b = float(np.float32(m)), float(np.float32(1 - m))
    s = np.asarray(s0, np.float64)
    t = np.asarray(t, np.float64)
    for _ in range(n):
        s = a * s + b * t
    return s


def _close_or_stalled(got, want, n, what):
    """1e-6 of the largest magnitude; past ~3 / (1 - m) steps, the float32
    loop's stall band, ulp(max) / (1 - m) with m = 0.999 as float32."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    band = (np.spacing(np.float32(scale)) / (1 - float(np.float32(0.999)))
            if n > 3000 else 1e-6 * scale)
    assert np.abs(got - want).max() <= band, (what, n,
                                              np.abs(got - want).max(), band)


@pytest.mark.parametrize("n", [8, 11, 18619])
def test_free_remask_closed_form(n):
    p = _probs(40, scale=4.0)
    j0, _ = JC.free_mask(JC.free_init(NCU), jnp.asarray(p))
    t0 = TC.FreeState(*(_t(getattr(j0, k)) for k in
                        ("p_model", "label_hist", "time_p")))
    j, jm = _jax_loop(lambda s: JC.free_mask(s, jnp.asarray(p)), j0, n)
    t, tm = TC.free_mask(t0, _t(p), repeat=n)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    hist = np.bincount(p.argmax(-1), minlength=NCU) / BU
    for k, target in (("p_model", p.mean(0)), ("label_hist", hist),
                      ("time_p", p.max(-1).mean())):
        _close_or_stalled(getattr(t, k), getattr(j, k), n, k)
        exact = _f64_loop(getattr(j0, k), target, 0.999, n)
        assert_rel_close(getattr(t, k).double(), exact, 1e-6,
                         f"{k} vs float64")


@pytest.mark.parametrize("per_class", [False, True])
@pytest.mark.parametrize("n", [8, 11, 18619])
def test_softmatch_remask_closed_form(n, per_class):
    p = _probs(41, scale=2.0)
    # start above the batch's confidences, so that weights fall below 1
    shape = (NCU,) if per_class else ()
    j0 = JC.SoftMatchState(jnp.full(shape, 0.9, jnp.float32),
                           jnp.full(shape, 0.05, jnp.float32))
    t0 = TC.SoftMatchState(_t(j0.prob_max_mu_t), _t(j0.prob_max_var_t))
    j, jm = _jax_loop(lambda s: JC.softmatch_mask(
        s, jnp.asarray(p), per_class=per_class), j0, n)
    t, tm = TC.softmatch_mask(t0, _t(p), per_class=per_class,
                               repeat=n)
    _close_or_stalled(t.prob_max_mu_t, j.prob_max_mu_t, n, "mu")
    _close_or_stalled(t.prob_max_var_t, j.prob_max_var_t, n, "var")
    max_p, idx, mu_t, var_t = TC._softmatch_targets(_t(p), NCU, per_class)
    exact = TC.SoftMatchState(
        _t(_f64_loop(j0.prob_max_mu_t, mu_t.numpy(), 0.999, n)).float(),
        _t(_f64_loop(j0.prob_max_var_t, var_t.numpy(), 0.999, n)).float())
    for k in ("prob_max_mu_t", "prob_max_var_t"):
        assert_rel_close(getattr(t, k), getattr(exact, k), 1e-6, k)

    def weights(state):
        return TC.softmatch_weights(state, max_p, idx, 2, per_class)

    if n < 3000:
        assert_rel_close(tm, jm, 1e-6, "weights")
    else:  # the weights of each side's state: JAX's stalled, the exact one
        assert_rel_close(weights(TC.SoftMatchState(
            _t(j.prob_max_mu_t), _t(j.prob_max_var_t))), jm, 1e-6)
        assert_rel_close(tm, weights(exact), 1e-6, "weights")
    assert float(tm.min()) < 1.0


# ---------------------------------------------------------------------------
# three SR steps of each variant against the JAX package
# ---------------------------------------------------------------------------

def _check_variant(name):
    def check(step, tstate, jstate, tm, jm):
        if name == "srsoftmatch":  # soft weights
            assert_rel_close(tm["util_ratio"], jm["util_ratio"], 1e-5)
            g, jg = tstate.algo.gaussian, jstate.algo.gaussian
            state = [("mu", g.prob_max_mu_t, jg.prob_max_mu_t),
                     ("var", g.prob_max_var_t, jg.prob_max_var_t),
                     ("da_p_model", tstate.algo.dist_align.p_model,
                      jstate.algo.dist_align.p_model)]
        else:
            assert float(tm["util_ratio"]) == float(jm["util_ratio"]), step
            state = []
        if name == "srfreematch":
            for k in ("ent_loss", "time_p", "max_prob_mean"):
                assert_rel_close(tm[k], np.asarray(jm[k]), 1e-5, k)
            state = [(k, getattr(tstate.algo, k), getattr(jstate.algo, k))
                     for k in ("p_model", "label_hist", "time_p")]
        for k, got, want in state:
            assert_rel_close(got, want, 1e-5, f"{step} {k}")
    return check


@pytest.mark.parametrize("name", ["srfreematch", "srsoftmatch",
                                  "srpseudolabel"])
def test_three_sr_variant_steps_match_jax(name):
    run_three_sr_steps(name, _check_variant(name))


# ---------------------------------------------------------------------------
# sr_per_sample and sr_reforward
# ---------------------------------------------------------------------------

def _check_flex(step, tstate, jstate, tm, jm):
    assert float(tm["util_ratio"]) == float(jm["util_ratio"]), step
    np.testing.assert_array_equal(tstate.algo.selected_label.numpy(),
                                  np.asarray(jstate.algo.selected_label))


@pytest.mark.parametrize("start_timing,trained_at", [(3, (1, 2)), (1, (2,))])
def test_three_per_sample_steps_match_jax(start_timing, trained_at,
                                          monkeypatch):
    """``sr_per_sample`` in stage 1 (start_timing 3: the rewarder trains at
    steps 1 and 2) and in stage 2 (start_timing 1: the reward filter from
    step 2, an N_k update there), with JAX's negative candidates (drawn
    from the step's key folded with 7) injected into the port. Two Adam
    steps of the rewarder in stage 1 leave one element of a 128-wide leaf
    (``feature_norm.bias``, 2.4e-6 apart) past 1e-4 of its leaf's largest
    magnitude: a near-zero gradient divided by its own magnitude, held to
    the Adam bound like test_torch_step.py's 0.1%. Then the
    per-sample rewarder gives two samples of one label different rewards,
    which the faithful one cannot."""
    drawn = {}
    monkeypatch.setattr(tsr, "draw_candidates", lambda y, n, g=None: drawn[0])

    def before(step, jstate, tbatch):
        key = jax.random.fold_in(jax.random.fold_in(jstate.rng, step), 7)
        drawn[0] = _t(np.asarray(jax.random.randint(
            key, tbatch["y_lb"].shape, 0, NC_STEP))).long()

    tstate, _ = run_three_sr_steps(
        "srflexmatch", _check_flex, trained_at=trained_at,
        over=dict(sr_per_sample=True, start_timing=start_timing),
        before_step=before, rewarder_far=1)
    rewarder = tstate.sr.rewarder
    assert rewarder.per_sample
    feats = torch.from_numpy(np.random.RandomState(9).randn(
        4, EMB_STEP).astype(np.float32))
    same = torch.zeros(4, dtype=torch.long)
    with torch.no_grad():
        r = rewarder(feats, same).squeeze(-1)
        rewarder.per_sample = False
        r_faithful = rewarder(feats, same).squeeze(-1)
    assert float((r - r[0]).abs().max()) > 1e-6, r
    assert torch.equal(r_faithful, r_faithful[:1].expand(4)), r_faithful


def test_three_reforward_steps_match_jax(monkeypatch):
    """``extra['sr_reforward'] = 3`` (the JAX bench's ref-equivalent arm):
    step 2, in stage 2, re-forwards the batch three times (two without
    gradient, each remasked and scored, and the last differentiated);
    steps 0 and 1 take the plain path."""
    calls = []
    reforwards = tsr.SemiRewardWrapper._reforwards

    def spy(self, ctx, *a):
        out = reforwards(self, ctx, *a)
        calls.append(ctx.step)
        return out

    monkeypatch.setattr(tsr.SemiRewardWrapper, "_reforwards", spy)
    run_three_sr_steps("srflexmatch", _check_flex,
                       extra={"sr_reforward": 3})
    assert calls == [2]


def test_reforwards_leave_the_batchnorm_statistics_on_the_wrn():
    """One stage-2 SRFlexMatch loss with ``sr_reforward`` 3 on the small WRN
    of ``test_torch_wrn.py``, the JAX loss jitted alone: the losses and
    ratios within 1e-5, and the running statistics after it equal to the
    JAX loss's new ``batch_stats`` (the base forward's: JAX discards the
    re-forwards'), within 1e-5."""
    from semireward_tpu.algorithms.base import StepCtx as JCtx
    from semireward_tpu.config import get_config as jax_config
    from semireward_tpu.models import wrn as jwrn
    from semireward_tpu.registry import ALGORITHMS as JALGS
    from semireward_tpu_torch.algorithms.base import StepCtx as TCtx
    from semireward_tpu_torch.config import get_config as torch_config
    from semireward_tpu_torch.convert import load_flax_params
    from semireward_tpu_torch.models import wrn as twrn
    from semireward_tpu_torch.registry import ALGORITHMS as TALGS
    from test_torch_wrn import ARCH, BN_MOM, S, _perturb, _same_stats

    cfg = dict(algorithm="srflexmatch", net="wrn_28_2", num_classes=NC_STEP,
               img_size=S, batch_size=4, uratio=1, start_timing=1, N_k=1,
               feature_dim=64, p_cutoff=0.3, compute_dtype="float32")
    jcfg, tcfg = jax_config(**cfg), torch_config(**cfg)
    jcfg.extra["sr_reforward"] = tcfg.extra["sr_reforward"] = 3
    info = {"ulb_dest_len": 16, "lb_dest_len": 8}
    jalg = JALGS.get("srflexmatch")(jcfg, info)
    talg = TALGS.get("srflexmatch")(tcfg, info, torch.device("cpu"))
    jnet = jwrn.wrn_28_2(NC_STEP, dtype=jnp.float32, bn_momentum=BN_MOM,
                         **ARCH)
    tnet = twrn.wrn_28_2(NC_STEP, dtype=torch.float32, bn_momentum=BN_MOM,
                         **ARCH)
    v = jax.jit(lambda k: jnet.init(k, jnp.zeros((2, S, S, 3)),
                                    train=False))(jax.random.PRNGKey(0))
    params = _perturb(v["params"])
    load_flax_params(tnet, jax.device_get(params),
                     jax.device_get(v["batch_stats"]))
    jsr = jalg.init_sr(jax.random.PRNGKey(1))
    tsr_state = talg.init_sr()
    load_flax_params(tsr_state.rewarder,
                     jax.device_get(jsr.rewarder_params))
    rs = np.random.RandomState(21)
    views = {k: rs.randn(4, S, S, 3).astype(np.float32)
             for k in ("x_lb", "x_ulb_w", "x_ulb_s")}
    y, idx = rs.randint(0, NC_STEP, 4), rs.choice(16, 4, replace=False)
    jbatch = {**{k: jnp.asarray(a) for k, a in views.items()},
              "y_lb": jnp.asarray(y), "idx_ulb": jnp.asarray(idx, jnp.int32)}
    tbatch = {**{k: _t(a) for k, a in views.items()}, "y_lb": _t(y),
              "idx_ulb": _t(idx)}

    @jax.jit
    def jloss(params, stats, batch):
        out = jalg.loss(JCtx(jnet.apply, params, stats, batch,
                             jalg.init_state(), jax.random.PRNGKey(5),
                             jnp.asarray(2, jnp.int32), sr_state=jsr))
        return out.metrics, out.new_batch_stats

    jm, new_stats = jloss(params, v["batch_stats"], jbatch)
    out = talg.loss(TCtx(tnet, tbatch, talg.init_state(), None, 2,
                         sr_state=tsr_state))
    _same_stats(tnet, new_stats, "reforward")
    for k in ("sup_loss", "unsup_loss", "total_loss"):
        assert_rel_close(out.metrics[k], np.asarray(jm[k]), 1e-5, k)
    for k in ("util_ratio", "sr_keep_ratio"):
        assert float(out.metrics[k]) == float(jm[k]), k
