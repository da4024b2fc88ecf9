"""The imbalanced-SSL wrappers (``semireward_tpu_torch/imb/``) held against
the JAX package (``semireward_tpu/imb/``) on the narrow WRN of
``test_torch_wrn.py`` (depth 10, widen 1, 16 px, float32), 4 classes,
batch 4 + 4, SGD with nesterov momentum, weights converted from flax, the
same seeded numpy views into both. The random draws are injected: the
JAX step's ABC Bernoulli uniforms, CoSSL's mixup draws and ReMixMatch's
MixUp lambda and permutation are recomputed from the JAX step's key and
handed to the port (``abc.draw_uniform``, ``cossl.draw_tfe_mix``,
``common.draw_mixup``).

- Three-step trajectories of every wrapper over FixMatch and of every
  ReMixMatch combination that JAX accepts (ADSH and TRAS take FixMatch
  only), with the trainer's epoch hook run on both sides where the JAX
  trainer runs it (``step % (num_train_iter // epoch) == 0``); four steps
  across the first boundary for SAW's and ADSH's refits from a full
  unlabeled forward and CoSSL's teacher warm start (``cossl_warm_epoch``
  1; the augmentation of its feature passes replaced by the plain
  normalization on both sides), the step after it included.
  Each step starts from JAX's weights, running statistics, EMA and SGD
  momentum (copied into the port; the algorithm state is each package's
  own): every metric within 1e-5 of its magnitude (``util_ratio``
  exact), the algorithm state (``(base_state, imb_state)``) within 1e-5
  (integers and flags exact), the BatchNorm running statistics within
  1e-5, and each parameter's and EMA leaf's update within 1e-2 of the
  update's norm (``_check_update``; a leaky-ReLU input that float32
  rounding puts on the other side of 0 in one package takes the other
  slope, and the leaves before it move by a few 1e-3 of their update;
  otherwise the updates agree to about 1e-6).
- The eval head of ABC, TRAS and CoSSL before and after the switch, and
  the trainer scoring that head.
- ``estimate_pseudo`` within 1e-6 and ``opt_solver`` within 1e-5 of JAX's
  on seeded probabilities (the same 10 x 30 Newton steps, float32);
  ``crest_split``, ``effective_weights`` and ADSH's refit bit-equal.
- A checkpoint of a nested ``(base_state, imb_state)`` (DASO over
  ReMixMatch, CoSSL over FixMatch) under the JAX key layout that resumes
  bit-equal.
- SemiReward over Dash and over a base with its own ``remask``, through
  ``_make_sr_variant`` in both packages, four steps with the reward filter
  on; and the warm-up of SemiReward over Dash through the wrapper (JAX's
  trainer raises after it).
- The wrapped ViT, nested too (ABC over ReMixMatch), against JAX's: names,
  heads and passthroughs (1e-5), layer-decay scales.
- An imb wrapper over a SemiReward variant: JAX's step fails on the
  missing SemiReward state, the port refuses it at construction.
"""
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import semireward_tpu.imb  # noqa: F401  (registers the JAX wrappers)
from _torch_port import assert_rel_close
from semireward_tpu.algorithms import fixmatch as jfix
from semireward_tpu.algorithms.semireward import _make_sr_variant as jmake_sr
from semireward_tpu.config import get_config as jax_config
from semireward_tpu.core.step import init_train_state as jax_init
from semireward_tpu.core.step import make_train_step as jax_make_step
from semireward_tpu.data import augment as jaug
from semireward_tpu.data.datasets import ArrayDataset as JArray
from semireward_tpu.imb import adsh as jadsh
from semireward_tpu.imb import crest as jcrest
from semireward_tpu.imb import darp as jdarp
from semireward_tpu.imb import saw as jsaw
from semireward_tpu.models import wrn as jwrn
from semireward_tpu.registry import ALGORITHMS as JALGS
from semireward_tpu.registry import IMB_ALGORITHMS as JIMB
from semireward_tpu_torch import imb as timb
from semireward_tpu_torch.algorithms import common as TC
from semireward_tpu_torch.algorithms import fixmatch as tfix
from semireward_tpu_torch.algorithms.semireward import \
    _make_sr_variant as tmake_sr
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.convert import (flax_to_torch, load_flax_params,
                                          torch_name)
from semireward_tpu_torch.core import checkpoint as tckpt
from semireward_tpu_torch.core.step import init_train_state as torch_init
from semireward_tpu_torch.core.step import make_train_step as torch_make_step
from semireward_tpu_torch.core.train_state import _flatten
from semireward_tpu_torch.core.trainer import Trainer as TTrainer
from semireward_tpu_torch.data.augment import AugmentSpec as TSpec
from semireward_tpu_torch.data.datasets import ArrayDataset as TArray
from semireward_tpu_torch.imb import abc as tabc
from semireward_tpu_torch.imb import adsh as tadsh
from semireward_tpu_torch.imb import cossl as tcossl
from semireward_tpu_torch.imb import crest as tcrest
from semireward_tpu_torch.imb import darp as tdarp
from semireward_tpu_torch.imb import saw as tsaw
from semireward_tpu_torch.models import wrn as twrn
from semireward_tpu_torch.registry import ALGORITHMS as TALGS
from semireward_tpu_torch.registry import IMB_ALGORITHMS as TIMB
from test_torch_step import _check_leaf
from test_torch_usb_algorithms import _JitInit, _jax_mixup_draws
from test_torch_wrn import ARCH, BN_MOM, _perturb, _same_stats

NC, S, B = 4, 16, 4
CPU = torch.device("cpu")
# three steps an epoch: the first boundary after step 3
CFG = dict(net="wrn_28_2", num_classes=NC, batch_size=B, uratio=1,
           num_train_iter=12, epoch=4, optim="SGD", lr=0.03, momentum=0.9,
           weight_decay=5e-4, layer_decay=1.0, ema_m=0.5, img_size=S,
           compute_dtype="float32", p_cutoff=0.5, eval_batch_size=6, seed=3)
LB_TARGETS = np.array([0, 0, 0, 0, 1, 1, 1, 2, 2, 3])
N_ULB = 16
DATA_INFO = {"ulb_dest_len": N_ULB, "lb_dest_len": len(LB_TARGETS),
             "lb_class_dist": np.bincount(LB_TARGETS) / len(LB_TARGETS),
             "num_features": 64}
# per wrapper, chosen so that its own path runs within four steps: one
# epoch a step where the wrapper waits for epochs (ABC's annealing, TRAS's
# and DARP's warm-up), DASO's pretraining over after step 0 and a queue of
# 3 that wraps, CoSSL's teacher from epoch 1 (its warm start after step 3)
IMB_OVER = {
    "abc": dict(num_train_iter=8, epoch=8, abc_p_cutoff=0.3),
    "tras": dict(num_train_iter=8, epoch=8, tras_warmup_epochs=1),
    "darp": dict(num_train_iter=8, epoch=8, darp_warmup_epochs=0,
                 darp_num_refine_iter=1),
    "daso": dict(daso_num_pretrain_iter=1, daso_num_pl_dist_iter=1,
                 daso_queue_len=3),
    "adsh": dict(adsh_tau_1=0.6),
    "cossl": dict(cossl_warm_epoch=1, cossl_tfe_warm_bs=4,
                  cossl_tfe_warm_epoch=2),
    "debiaspl": dict(debiaspl_tau=0.8),
}
# CReST+ in its fourth generation: the alignment target's temperature 0.7
CREST_GEN = {"crest": 0, "crest+": 3}
NAMES = ("saw", "debiaspl", "adsh", "abc", "tras", "darp", "daso", "crest",
         "crest+", "cossl")
FIXMATCH_ONLY = ("adsh", "tras")
CASES = [("fixmatch", n) for n in NAMES] + [
    ("remixmatch", n) for n in NAMES if n not in FIXMATCH_ONLY]
STEPS = 4
# the wrappers whose epoch hook feeds a step after it: four steps across
# the boundary after step 3; three for the others
HOOKED = ("saw", "adsh", "cossl")
STATE_TOL = 1e-5
UPDATE_TOL = 1e-2


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _cfg(base, name, **over):
    return dict(CFG, algorithm=base, imb_algorithm=name,
                **IMB_OVER.get(name, {}), **over)


def _jax_alg(jcfg, base, name):
    if name in CREST_GEN:
        return jcrest.CReST(jcfg, DATA_INFO, base_cls=JALGS.get(base),
                            gen=CREST_GEN[name])
    return JIMB.get(name)(jcfg, DATA_INFO, base_cls=JALGS.get(base))


def _torch_alg(tcfg, base, name):
    if name in CREST_GEN:
        return tcrest.CReST(tcfg, DATA_INFO, CPU, base_cls=TALGS.get(base),
                            gen=CREST_GEN[name])
    return TIMB.get(name)(tcfg, DATA_INFO, CPU, base_cls=TALGS.get(base))


def _jax_flat(tree, prefix="algo"):
    """``{algo.<path>: array}`` in the port's key layout."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [prefix]
        for k in path:
            parts.append(str(getattr(k, "idx", getattr(k, "key", getattr(
                k, "name", k)))))
        out[".".join(parts)] = np.asarray(leaf)
    return out


def _torch_flat(tree):
    out = {}
    _flatten("algo", tree, out)
    return out


def _compare_state(what, tstate, jstate):
    got, want = _torch_flat(tstate), _jax_flat(jstate)
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        if g.is_floating_point():
            assert_rel_close(g, w, STATE_TOL, f"{what} {k}")
        else:
            np.testing.assert_array_equal(g.numpy(), w, f"{what} {k}")


_INITS = {}


class _CachedInit:
    """``model.init`` compiled once per wrapper structure (the variables
    do not depend on the algorithm around the net)."""

    def __init__(self, model):
        self.model = model

    def init(self, rngs, x, train=False):
        key = repr(self.model)
        if key not in _INITS:
            _INITS[key] = _JitInit(self.model).init(rngs, x, train=train)
        return _INITS[key]


def _pair(jcfg, tcfg, jalg, talg):
    """Both nets under the wrapper, the JAX weights perturbed and copied
    into the port, both train states."""
    jmodel = jalg.wrap_model(jwrn.wrn_28_2(NC, dtype=jnp.float32,
                                           bn_momentum=BN_MOM, **ARCH))
    tmodel = talg.wrap_model(twrn.wrn_28_2(NC, dtype=torch.float32,
                                           bn_momentum=BN_MOM, **ARCH),
                             torch.Generator().manual_seed(0))
    jstate, tx = jax_init(jcfg, jalg, _CachedInit(jmodel),
                          jax.random.PRNGKey(0), jnp.zeros((2, S, S, 3)),
                          builder=jwrn.wrn_28_2)
    params = _perturb(jstate.params)
    jstate = jstate.replace(params=params, ema_params=params)
    load_flax_params(tmodel, jax.device_get(params),
                     jax.device_get(jstate.batch_stats))
    tstate = torch_init(tcfg, talg, tmodel, builder=twrn.wrn_28_2)
    return jmodel, tmodel, jstate, tstate, tx


def _sync(jstate, tmodel, tstate):
    """JAX's weights, running statistics, EMA and SGD momentum into the
    port's state."""
    load_flax_params(tmodel, jax.device_get(jstate.params),
                     jax.device_get(jstate.batch_stats))
    trace = next(s.trace for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
                 if isinstance(s, optax.TraceState))
    ema, mom = (flax_to_torch(jax.device_get(t))
                for t in (jstate.ema_params, trace))
    with torch.no_grad():
        for i, (n, _) in enumerate(tmodel.named_parameters()):
            tstate.ema[i].copy_(_t(ema[n]))
            tstate.opt.trace[i].copy_(_t(mom[n]))


def _check_update(name, got, want, before):
    """``got`` within ``UPDATE_TOL`` of the norm of the update
    ``want - before`` (and 1e-6 of the leaf where it does not move)."""
    err = float(np.linalg.norm(got - want))
    upd = float(np.linalg.norm(want - before))
    assert err <= UPDATE_TOL * upd + 1e-6 * float(np.abs(want).max()), (
        name, err, upd)


def _params(jstate):
    return [flax_to_torch(jax.device_get(t))
            for t in (jstate.params, jstate.ema_params)]


def _check_params(what, tmodel, tstate, jstate, before):
    want, want_ema = _params(jstate)
    for (n, p), e in zip(tmodel.named_parameters(), tstate.ema):
        _check_update(f"{what} {n}", p.detach().numpy(), want[n],
                      before[0][n])
        _check_update(f"{what} ema {n}", e.numpy(), want_ema[n],
                      before[1][n])


def _views(rs, keys, name):
    v = {k: rs.randn(B, S, S, 3).astype(np.float32)
         for k in ("x_lb", "x_ulb_w", "x_ulb_s", "x_ulb_s_0", "x_ulb_s_1")
         if k in keys}
    if "x_ulb_s_0_rot" in keys:
        rot = rs.randint(0, 4, B)
        v["x_ulb_s_0_rot"] = np.stack([np.rot90(img, k, (0, 1)) for img, k
                                       in zip(v["x_ulb_s_0"], rot)])
        v["rot_v"] = rot
    if name == "cossl":
        v["x_tfe_lb"] = rs.randn(B, S, S, 3).astype(np.float32)
        v["y_tfe_lb"] = rs.randint(0, NC, B)
        v["x_tfe_ulb"] = rs.randn(B, S, S, 3).astype(np.float32)
    v["y_lb"] = rs.randint(0, NC, B)
    # drawn with replacement: a repeated index keeps its last write
    v["idx_ulb"] = rs.randint(0, N_ULB, B).astype(np.int32)
    return {k: np.ascontiguousarray(a) for k, a in v.items()}


def _bundles(rs):
    lb = rs.randint(0, 256, (len(LB_TARGETS), S, S, 3)).astype(np.uint8)
    ulb = rs.randint(0, 256, (N_ULB, S, S, 3)).astype(np.uint8)
    tgt = np.full(N_ULB, -1)
    j = type("B", (), dict(train_lb=JArray(lb, LB_TARGETS),
                           train_ulb=JArray(ulb, tgt)))
    t = type("B", (), dict(train_lb=TArray(lb, LB_TARGETS),
                           train_ulb=TArray(ulb, tgt)))
    return j, t


MEAN, STD = (0.5, 0.4, 0.3), (0.25, 0.2, 0.3)


class _JaxTrainer:
    """What the JAX wrappers' ``on_epoch_end`` reads of its trainer."""

    def __init__(self, cfg, model, bundle):
        self.cfg, self.model, self.bundle = cfg, model, bundle
        self.aug_spec = jaug.AugmentSpec(S, 2, MEAN, STD)
        self.logger = logging.getLogger("test_torch_imb.jax")

        def fwd(state, x, out_key="logits", use_ema=True):
            v = {"params": state.ema_params if use_ema else state.params}
            if state.batch_stats:
                v["batch_stats"] = state.batch_stats
            out = model.apply(v, jaug.normalize(x, MEAN, STD), train=False)
            return out.get(out_key, out["logits"])

        self._jit_eval = jax.jit(fwd, static_argnames=("out_key", "use_ema"))


class _TorchTrainer:
    """What the port's ``on_epoch_end`` reads of its trainer: the
    ``Trainer`` methods on a state built here."""

    _to_device = TTrainer._to_device
    _logits = TTrainer._logits
    _eval_weights = TTrainer._eval_weights

    def __init__(self, cfg, state, bundle):
        self.cfg, self.state, self.model = cfg, state, state.model
        self.bundle, self.device, self.modality = bundle, CPU, "cv"
        self.eval_use_ema = True
        self.aug_spec = TSpec(S, 2, MEAN, STD)
        self.logger = logging.getLogger("test_torch_imb.port")


def _plain_views(monkeypatch):
    """CoSSL's warm-start feature passes without augmentation on both
    sides: the normalized raw images."""
    monkeypatch.setattr(jaug, "weak_augment", lambda k, x, spec:
                        jaug.normalize(x, spec.mean, spec.std))
    monkeypatch.setattr(jaug, "randaugment", lambda k, x, spec:
                        jaug.normalize(x, spec.mean, spec.std))
    from semireward_tpu_torch.data.augment import normalize as tnorm
    monkeypatch.setattr(tcossl, "tfe_view", lambda x, spec, strong, g:
                        tnorm(x, spec.mean, spec.std))


def _inject(monkeypatch, jcfg, base, name, key, draws):
    """The JAX step's draws from its key, for the port's draw functions."""
    if base == "remixmatch":
        k = jax.random.split(key, 12)[4]
        lam, index = _jax_mixup_draws(k, 4 * B, jcfg.mixup_alpha, True)
        draws["mixup"] = (_t(lam), _t(index))
    if name == "abc":
        k1, k2 = jax.random.split(jax.random.fold_in(key, 31), 2)
        draws["uniform"] = [_t(jax.random.uniform(k, (B,))) for k in (k1, k2)]
    if name == "cossl":
        k1, k2 = jax.random.split(jax.random.fold_in(key, 77))
        draws["tfe"] = (_t(jax.random.uniform(k1, (B,))),
                        _t(jax.random.uniform(k2, (B, 1), minval=0.6,
                                              maxval=1.0)))


def _install(monkeypatch, draws):
    monkeypatch.setattr(TC, "draw_mixup", lambda *a: draws["mixup"])
    monkeypatch.setattr(tabc, "draw_uniform",
                        lambda n, g=None, d=None: draws["uniform"].pop(0))
    monkeypatch.setattr(tcossl, "draw_tfe_mix", lambda *a: draws["tfe"])


def run_imb(base, name, monkeypatch, steps=STEPS):
    """``steps`` steps of ``name`` over ``base`` in both packages, compared
    after each step (and after each epoch hook) as the module docstring
    says. Returns the metrics seen and both states."""
    kw = _cfg(base, name)
    jcfg, tcfg = jax_config(**kw), torch_config(**kw)
    jalg, talg = _jax_alg(jcfg, base, name), _torch_alg(tcfg, base, name)
    jmodel, tmodel, jstate, tstate, tx = _pair(jcfg, tcfg, jalg, talg)
    jstep = jax.jit(jax_make_step(jcfg, jalg, jmodel, tx))
    tstep = torch_make_step(tcfg, talg)
    draws = {}
    _install(monkeypatch, draws)
    _plain_views(monkeypatch)
    rs = np.random.RandomState(1)
    jb, tb = _bundles(rs)
    jtr = _JaxTrainer(jcfg, jmodel, jb)
    ttr = _TorchTrainer(tcfg, tstate, tb)
    per_epoch = jcfg.num_train_iter // jcfg.epoch
    seen = []
    for step in range(steps):
        _sync(jstate, tmodel, tstate)
        before = _params(jstate)
        views = _views(rs, talg.BATCH_KEYS, name)
        _inject(monkeypatch, jcfg, base, name,
                jax.random.fold_in(jstate.rng, step), draws)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in views.items()})
        tm = tstep(tstate, {k: _t(v) for k, v in views.items()})
        assert sorted(tm) == sorted(jm), (sorted(tm), sorted(jm))
        for k, v in jm.items():
            if k == "util_ratio":
                assert float(tm[k]) == float(v), (step, k)
            else:
                assert_rel_close(tm[k], np.asarray(v), 1e-5, f"{step} {k}")
        seen.append({k: float(v) for k, v in tm.items()})
        if (step + 1) % per_epoch == 0:
            jtr.state = jstate
            jstate = jalg.on_epoch_end(jtr, jstate)
            ttr.state = tstate
            tstate = talg.on_epoch_end(ttr, tstate)
        _compare_state(f"step {step}", tstate.algo, jstate.algo)
        _same_stats(tmodel, jstate.batch_stats, f"step {step}")
        _check_params(f"step {step}", tmodel, tstate, jstate, before)
    assert tstate.step == steps == int(jstate.step)
    return seen, jstate, tstate, jalg, talg


@pytest.mark.parametrize("base,name", CASES)
def test_steps_match_jax(base, name, monkeypatch):
    seen, jstate, tstate, jalg, talg = run_imb(
        base, name, monkeypatch, STEPS if name in HOOKED else STEPS - 1)
    imb0 = _torch_flat(_torch_alg(torch_config(**_cfg(base, name)), base,
                                  name).init_state()[1])
    imb = _torch_flat(tstate.algo[1])
    moved = {k for k in imb if not torch.equal(imb[k], imb0[k])}
    # the wrapper's own state moved, where it has one that moves (ADSH's
    # refit needs class 0 among the predictions: the refit test below)
    want_moved = {
        "saw": {"algo.x_ulb_weights"}, "debiaspl": {"algo.p_hat"},
        "darp": {"algo.pseudo_orig", "algo.pseudo_refine"},
        "daso": {"algo.bank", "algo.bank_ptr", "algo.bank_cnt",
                 "algo.prototypes", "algo.probs_sim"},
        "cossl": {"algo.tfe_momentum.kernel", "algo.tfe_momentum.bias"},
        "crest": {"algo.p_model", "algo.initialized"},
        "crest+": {"algo.p_model", "algo.initialized"}}.get(name, set())
    if base == "remixmatch" and name in ("crest", "crest+"):
        want_moved = set()  # ReMixMatch never calls maybe_dist_align
    assert want_moved <= moved, (want_moved, moved)
    extra = {"abc": "abc_loss", "tras": "tras_loss", "daso": "assign_loss",
             "cossl": "tea_loss"}.get(name)
    if extra:
        assert any(m[extra] > 0 for m in seen), (extra, seen)
    if name == "adsh" or (name == "saw" and base == "fixmatch"):
        assert any(0 < m["util_ratio"] < 1 for m in seen), seen


# ---------------------------------------------------------------------------
# the eval heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,step,want", [
    ("abc", 0, "logits_aux"), ("abc", 7, "logits_aux"),
    ("tras", 0, "logits"), ("tras", 1, "logits_aux"),
    ("cossl", 2, "logits"), ("cossl", 3, "logits_tfe"),
    ("saw", 5, "logits")])
def test_eval_head_switches_where_jax_does(name, step, want):
    kw = _cfg("fixmatch", name)
    jalg = _jax_alg(jax_config(**kw), "fixmatch", name)
    talg = _torch_alg(torch_config(**kw), "fixmatch", name)

    def key(alg):
        if hasattr(alg, "eval_out_key"):
            return alg.eval_out_key(step)
        return getattr(alg, "EVAL_OUT_KEY", "logits")

    assert key(talg) == key(jalg) == want


def test_trainer_scores_the_eval_head(tmp_path, monkeypatch):
    """The port's Trainer on an ABC YAML scores ``logits_aux``; the eval
    CLI's trainer (plain FixMatch) scores ``logits``."""
    from semireward_tpu_torch import config as config_lib

    cfg = config_lib.from_yaml(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "config/classic_cv_imb/fixmatch_abc/"
        "fixmatch_abc_cifar10_lb1500_100_ulb3000_100_0.yaml"),
        dict(dataset="synthetic", use_pretrain=False, resume=False,
             num_labels=40, ulb_num_labels=80, synthetic_train=400,
             synthetic_test=8, img_size=S, eval_batch_size=8,
             net_kwargs=ARCH, save_dir=str(tmp_path)))
    tr = TTrainer(cfg, device="cpu")
    keys = []
    logits = tr._logits
    monkeypatch.setattr(tr, "_logits", lambda x, w=None, k="logits": (
        keys.append(k), logits(x, w, k))[1])
    tr.evaluate()
    assert type(tr.model).__name__ == "AuxHeadNet"
    assert keys and set(keys) == {"logits_aux"}


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------

def _probs(seed, n, c):
    lg = np.random.RandomState(seed).randn(n, c) * 2.0
    e = np.exp(lg - lg.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def test_estimate_pseudo_and_opt_solver_match_jax():
    q = _probs(4, 40, NC)
    target = np.array([18.0, 11.0, 7.0, 4.0], np.float32)
    want = jdarp.estimate_pseudo(jnp.asarray(target), jnp.asarray(q), 2.0, NC)
    got = tdarp.estimate_pseudo(_t(target), _t(q), 2.0, NC)
    assert_rel_close(got, np.asarray(want), 1e-6, "estimate_pseudo")
    want = jax.jit(lambda p, t: jdarp.opt_solver(p, t, 10))(
        jnp.asarray(q), jnp.asarray(target))
    got = tdarp.opt_solver(_t(q), _t(target), 10)
    assert_rel_close(got, np.asarray(want), 1e-5, "opt_solver")
    # the solve meets the target counts
    assert_rel_close(got.sum(0), target, 1e-3, "column sums")


def test_crest_split_effective_weights_and_refits_are_bit_equal(
        monkeypatch):
    rs = np.random.RandomState(9)
    lb = rs.randint(0, 256, (10, 4, 4, 3)).astype(np.uint8)
    ulb = rs.randint(0, 256, (30, 4, 4, 3)).astype(np.uint8)
    dist = np.bincount(LB_TARGETS) / len(LB_TARGETS)
    logits = (rs.randn(30, NC) * 3).astype(np.float32)
    pll = tcrest.pseudo_label_lists(logits, NC)
    for pl in (None, pll):
        want = jcrest.crest_split(lb, LB_TARGETS, ulb, np.full(30, -1), dist,
                                  pl, 3.0, NC)
        got = tcrest.crest_split(lb, LB_TARGETS, ulb, np.full(30, -1), dist,
                                 pl, 3.0, NC)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(got[0]) > len(lb)
    for cnt in ([100, 10, 1], [5, 5, 5, 5], np.bincount(LB_TARGETS)):
        np.testing.assert_array_equal(tsaw.effective_weights(cnt),
                                      jsaw.effective_weights(cnt))
    # the epoch-end refits of SAW and ADSH on the same logits
    monkeypatch.setattr(jadsh, "predict_ulb_logits", lambda tr: logits)
    monkeypatch.setattr(jsaw, "predict_ulb_logits", lambda tr: logits)
    kw = _cfg("fixmatch", "adsh")
    jalg = _jax_alg(jax_config(**kw), "fixmatch", "adsh")

    def state(imb):
        return type("S", (), dict(algo=((), imb),
                                  replace=lambda self, algo: algo))()

    # the JAX hook writes into np.asarray of its device array, which is
    # read-only: on its own state it raises once class 0 is predicted
    with pytest.raises(ValueError, match="read-only"):
        jalg.on_epoch_end(None, state(jalg.init_imb_state()))
    want = np.asarray(jalg.on_epoch_end(None, state(
        {"adsh_s": np.full(NC, 0.6, np.float32)}))[1]["adsh_s"])
    got = tadsh.refit_thresholds(logits, np.full(NC, 0.6, np.float32), 0.6)
    np.testing.assert_array_equal(got.astype(np.float32), want)
    assert not np.allclose(want, 0.6)
    jsaw_alg = _jax_alg(jax_config(**_cfg("fixmatch", "saw")), "fixmatch",
                        "saw")
    want = np.asarray(jsaw_alg.on_epoch_end(
        None, state(jsaw_alg.init_imb_state()))[1]["x_ulb_weights"])
    counts = np.maximum(np.bincount(logits.argmax(-1), minlength=NC), 1)
    np.testing.assert_array_equal(
        tsaw.effective_weights(counts).astype(np.float32), want)


# ---------------------------------------------------------------------------
# checkpoint of a nested state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base,name", [("remixmatch", "daso"),
                                       ("fixmatch", "cossl")])
def test_nested_state_checkpoint_resumes_bit_equal(base, name, tmp_path):
    tcfg = torch_config(**_cfg(base, name))

    def build():
        alg = _torch_alg(tcfg, base, name)
        model = alg.wrap_model(twrn.wrn_28_2(NC, dtype=torch.float32,
                                             **ARCH),
                               torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(5)
        return (alg, torch_init(tcfg, alg, model, builder=twrn.wrn_28_2,
                                generator=g), torch_make_step(tcfg, alg))

    alg, a, step_a = build()
    rs = np.random.RandomState(2)
    batches = [{k: _t(v) for k, v in _views(rs, alg.BATCH_KEYS, name).items()}
               for _ in range(3)]
    for b in batches[:2]:
        step_a(a, b, a.rng)
    path = str(tmp_path / "latest_model.ckpt")
    tckpt.save_checkpoint(path, a, {"it": 2})
    keys = tckpt.read_payload(path)["state"]
    nested = {"daso": ("algo.0.p_model", "algo.1.bank_ptr", "algo.1.bank"),
              "cossl": ("algo.1.tfe_momentum.kernel",
                        "algo.1.tfe_momentum.bias")}[name]
    assert set(nested) <= set(keys), sorted(k for k in keys
                                            if k.startswith("algo"))
    _, b_state, step_b = build()
    assert tckpt.load_checkpoint(path, b_state)["it"] == 2
    sa, sb = a.state_dict(), b_state.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    step_a(a, batches[2], a.rng)
    step_b(b_state, batches[2], b_state.rng)
    sa, sb = a.state_dict(), b_state.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# ---------------------------------------------------------------------------
# SemiReward over any base
# ---------------------------------------------------------------------------

class _JRemask(jfix.FixMatch):
    NAME = "remaskmatch"

    def remask(self, algo_state, probs_w, idx_ulb):
        return algo_state, (probs_w.max(-1) >= 0.35).astype(probs_w.dtype)


class _TRemask(tfix.FixMatch):
    NAME = "remaskmatch"
    calls = 0

    def remask(self, algo_state, probs_w, idx_ulb):
        type(self).calls += 1
        return algo_state, (probs_w.max(-1).values >= 0.35).to(probs_w.dtype)


def _registered(registry, make, name, base):
    return registry.get(name) if name in registry else make(name, base)


def _sr_classes(base):
    if base == "remaskmatch":
        for reg, cls in ((JALGS, _JRemask), (TALGS, _TRemask)):
            if base not in reg:
                reg.register(cls, name=base)
    return (_registered(JALGS, jmake_sr, f"sr{base}", base),
            _registered(TALGS, tmake_sr, f"sr{base}", base))


SR_CFG = dict(CFG, start_timing=1, N_k=2, feature_dim=64, sr_ema=False,
              sr_lr=0.01, rho_init=1.3)


@pytest.mark.parametrize("base", ["dash", "remaskmatch"])
def test_semireward_over_any_base_matches_jax(base):
    jcls, tcls = _sr_classes(base)
    _TRemask.calls = 0
    kw = dict(SR_CFG, algorithm=f"sr{base}")
    jcfg, tcfg = jax_config(**kw), torch_config(**kw)
    jalg, talg = jcls(jcfg, DATA_INFO), tcls(tcfg, DATA_INFO, CPU)
    jmodel, tmodel, jstate, tstate, tx = _pair(jcfg, tcfg, jalg, talg)
    load_flax_params(tstate.sr.rewarder,
                     jax.device_get(jstate.sr.rewarder_params))
    load_flax_params(tstate.sr.generator, jax.device_get(jstate.sr.gen_params))
    jstep = jax.jit(jax_make_step(jcfg, jalg, jmodel, tx))
    tstep = torch_make_step(tcfg, talg)
    rs = np.random.RandomState(4)
    names = [n for n, _ in tmodel.named_parameters()]
    keep = []
    for step in range(STEPS):
        views = _views(rs, talg.BATCH_KEYS, base)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in views.items()})
        tm = tstep(tstate, {k: _t(v) for k, v in views.items()})
        assert sorted(tm) == sorted(jm)
        for k, v in jm.items():
            if k in ("util_ratio", "sr_keep_ratio"):
                assert float(tm[k]) == float(v), (step, k)
            elif np.isfinite(float(v)):
                assert_rel_close(tm[k], np.asarray(v), 1e-5, f"{step} {k}")
        keep.append(float(tm["sr_keep_ratio"]))
        _compare_state(f"step {step}", tstate.algo, jstate.algo)
        bound = 2 * CFG["lr"] * (step + 1) + 1e-6
        want = flax_to_torch(jax.device_get(jstate.params))
        for n, p in zip(names, tmodel.parameters()):
            _check_leaf(n, p.detach().numpy(), want[n], bound)
        # Adam: a gradient of rounding noise (the batch softmax's own bias)
        # moves by up to lr a step (``_check_leaf``'s special case)
        rew = flax_to_torch(jax.device_get(jstate.sr.rewarder_params))
        for n, p in tstate.sr.rewarder.named_parameters():
            _check_leaf(n, p.detach().numpy(), rew[n],
                        2 * SR_CFG["sr_lr"] * (step + 1) + 1e-6)
    # stage 2 ran: the max reward is tracked, and the base's own remask
    # made the mask of the filtered steps (ctx.step 2 and 3)
    assert np.isfinite(float(tm["max_reward"])) and len(keep) == STEPS
    if base == "remaskmatch":
        assert _TRemask.calls == 2


def test_semireward_over_dash_warms_up_through_the_wrapper(tmp_path):
    """The port's Trainer warms Dash up under SemiReward (``base``'s
    ``NEEDS_WARMUP``, ``set_rho_init`` through the wrapper); the JAX
    trainer runs the warm-up too, then unpacks Dash's state as an imb
    wrapper's tuple and raises."""
    import semireward_tpu.core.trainer as jtr

    _sr_classes("dash")
    kw = dict(algorithm="srdash", net="wrn_28_2", dataset="synthetic",
              num_classes=NC, num_labels=8, batch_size=B, eval_batch_size=8,
              img_size=S, num_train_iter=1, num_eval_iter=1, num_log_iter=1,
              synthetic_train=64, synthetic_test=8, feature_dim=64,
              num_wu_iter=2, num_wu_eval_iter=1, net_kwargs=ARCH,
              optim="SGD", lr=0.01)
    tt = TTrainer(torch_config(**kw, save_dir=str(tmp_path / "port")),
                  device="cpu")
    assert tt.needs_warmup and not tt.alg.NEEDS_WARMUP
    rho = tt.warmup()
    assert float(tt.state.algo.rho_init) == float(torch.tensor(rho))
    assert tt.state.step == 0 and tt.state.opt.count == 2
    jt = jtr.Trainer(jax_config(**kw, save_dir=str(tmp_path / "jax")),
                     use_mesh=False)
    with pytest.raises(TypeError, match="unpack"):
        jt.warmup()
    jt.sink.close()


def test_imb_over_a_semireward_variant(monkeypatch):
    """JAX builds the wrapper over ``srfixmatch`` but its step carries no
    SemiReward state (``ImbAlgorithm`` sets no ``HAS_SR``) and fails when
    the base loss reads it; the port refuses the wrapper."""
    kw = _cfg("srfixmatch", "saw", feature_dim=64, start_timing=0)
    jcfg = jax_config(**kw)
    jalg = JIMB.get("saw")(jcfg, DATA_INFO, base_cls=JALGS.get("srfixmatch"))
    assert not getattr(jalg, "HAS_SR", False)
    jmodel = jalg.wrap_model(jwrn.wrn_28_2(NC, dtype=jnp.float32, **ARCH))
    jstate, tx = jax_init(jcfg, jalg, _JitInit(jmodel),
                          jax.random.PRNGKey(0), jnp.zeros((2, S, S, 3)))
    assert jstate.sr is None
    views = _views(np.random.RandomState(0), jalg.BATCH_KEYS, "saw")
    with pytest.raises(AttributeError):
        jax.jit(jax_make_step(jcfg, jalg, jmodel, tx))(
            jstate, {k: jnp.asarray(v) for k, v in views.items()})
    with pytest.raises(NotImplementedError, match="SemiReward"):
        TIMB.get("saw")(torch_config(**kw), DATA_INFO, CPU,
                        base_cls=TALGS.get("srfixmatch"))


def test_unsupported_bases_raise_as_in_jax():
    for name, base in (("adsh", "remixmatch"), ("tras", "remixmatch"),
                       ("debiaspl", "mixmatch")):
        kw = _cfg(base, name)
        with pytest.raises(AssertionError):
            JIMB.get(name)(jax_config(**kw), DATA_INFO,
                           base_cls=JALGS.get(base))
        with pytest.raises(AssertionError):
            TIMB.get(name)(torch_config(**kw), DATA_INFO, CPU,
                           base_cls=TALGS.get(base))
    assert sorted(timb.IMB_ALGORITHMS.keys()) == sorted(JIMB.keys())


# ---------------------------------------------------------------------------
# the wrapped nets, nested too
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base,name", [("remixmatch", "abc"),
                                       ("fixmatch", "cossl")])
def test_wrapped_vit_converts_matches_and_decays_as_jax(base, name):
    """The JAX wrapper's net (ABC over ReMixMatch: ``AuxHeadNet`` around
    ``RotNet``) on the 2-block ViT of ``test_torch_step.py``: the flax tree
    converts onto the port's names (``backbone.backbone.*``), every head
    and the ``use_rot`` / ``only_feat`` / ``only_fc`` passthroughs match
    JAX's within 1e-5, and the per-parameter layer-decay scales equal
    JAX's (``backbone`` first: 1.0 everywhere)."""
    from semireward_tpu.core import optim as joptim
    from semireward_tpu.models import vit as jvit
    from semireward_tpu_torch.core import optim as toptim
    from semireward_tpu_torch.models import vit as tvit
    from test_torch_usb_algorithms import ARCH as VIT_ARCH
    from test_torch_step import S as VS

    kw = _cfg(base, name, net="vit_small_patch2_32", img_size=VS)
    jalg = _jax_alg(jax_config(**kw), base, name)
    talg = _torch_alg(torch_config(**kw), base, name)
    jm = jalg.wrap_model(jvit.vit_small_patch2_32(
        num_classes=NC, dtype=jnp.float32, **VIT_ARCH))
    tm = talg.wrap_model(tvit.vit_small_patch2_32(
        num_classes=NC, dtype=torch.float32, **VIT_ARCH),
        torch.Generator().manual_seed(0))
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((2, VS, VS, 3)),
                                  train=False))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(np.random.RandomState(
            p.size % 991).randn(*p.shape), p.dtype), v["params"])
    load_flax_params(tm, jax.device_get(params))
    flat = flax_to_torch(jax.device_get(params))
    nested = "backbone.backbone." if base == "remixmatch" else "backbone."
    assert any(n.startswith(nested + "blocks.") for n in flat)
    x = np.random.RandomState(8).randn(3, VS, VS, 3).astype(np.float32)
    rot = {"use_rot": True} if base == "remixmatch" else {}
    jout = jax.jit(lambda p, x: jm.apply({"params": p}, x, train=False,
                                         **rot))(params, jnp.asarray(x))
    tout = tm(_t(x), train=False, **rot)
    assert sorted(tout) == sorted(jout)
    for k in jout:
        assert_rel_close(tout[k], np.asarray(jout[k]), 1e-5, k)
    feat = tm(_t(x), train=False, only_feat=True)
    want = jm.apply({"params": params}, jnp.asarray(x), train=False,
                    only_feat=True)
    assert_rel_close(feat, np.asarray(want), 1e-5, "only_feat")
    assert_rel_close(tm(feat, only_fc=True), np.asarray(jm.apply(
        {"params": params}, want, only_fc=True)), 1e-5, "only_fc")
    builder = jvit.vit_small_patch2_32
    scales = joptim.layer_decay_scales(params, 0.5, builder.layer_id_fn,
                                       builder.num_layers)
    want = {torch_name([k.key for k in path]): float(s) for path, s in
            jax.tree_util.tree_flatten_with_path(scales)[0]}
    got = toptim.layer_decay_scales([n for n, _ in tm.named_parameters()],
                                    0.5, tvit.layer_id, builder.num_layers)
    assert got == want and set(got.values()) == {1.0}
