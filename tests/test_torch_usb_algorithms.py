"""The USB base algorithms in the port (pimodel, meanteacher, vat, mixmatch,
remixmatch, uda, dash, adamatch, crmatch, defixmatch), held against the
JAX package on the same seeded numpy inputs, flax weights converted and
the random draws injected (the two packages' RNG streams are not matched):
MixUp's lambda and permutation and VAT's probe are JAX's own draws,
recomputed from the JAX step's key and handed to the port; VAT's
drop-path masks are injected on both sides.

- Helpers: ``mixup_one_target`` and ``interleave`` exact; the rotation
  views bit-equal; ``tsa_threshold``, Dash's rho schedule,
  ``kl_div_with_logit``, ``entropy_loss`` and
  ``cosine_embedding_loss_neg`` within 1e-6 of the largest magnitude.
- The wrappers: the converter maps the wrapped flax tree onto the wrapper's
  names and both give the same outputs (1e-5); the per-parameter
  layer-decay scales of a wrapped net equal JAX's (every backbone leaf at
  1.0: JAX's ``_layer_id`` sees ``backbone`` first, so the wrapped ViT
  trains without layer decay, as the port's does); ``use_pretrain`` on a
  wrapped net raises a ``KeyError`` in both packages.
- Three-step trajectories of all ten on the 2-block ViT of
  ``test_torch_step.py`` (its MLP unfused: see ``ARCH``) with that file's
  tolerances: losses and the algorithm's
  metrics within 1e-5 of their magnitude, mask ratios exact, algorithm
  state within 1e-5, every parameter and the EMA as ``_check_leaf``
  holds them. VAT runs with drop-path on: at drop-path 0 its probe (about
  2e-8 a pixel) leaves the logits unchanged to the bit, and the direction
  it finds is rounding noise in both packages; with the same masks on both
  sides the port's ``grad_d`` is held to JAX's by cosine similarity
  (>= 0.9999) and ``r_adv``'s norm to ``vat_eps`` (1e-5).
- The BatchNorm branches on the small WRN of ``test_torch_wrn.py``, one
  loss each with the running statistics compared to the JAX loss's new
  ``batch_stats`` (1e-5): MixMatch's and ReMixMatch's first mixed chunk
  alone moves them, VAT's and PiModel's unlabeled forwards leave them.
- JAX's VAT cannot trace through the fused MLP; the port's can.
- Dash's supervised warm-up against the JAX ``Trainer.warmup``: the same
  ``rho_init`` (1e-5), the step count back to 0, the optimizer's count
  kept, and the logged LR offset by ``num_wu_iter``.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_rel_close
from semireward_tpu.algorithms import common as JC
from semireward_tpu.algorithms import crmatch as jcr
from semireward_tpu.algorithms import uda as juda
from semireward_tpu.algorithms import vat as jvat
from semireward_tpu.config import get_config as jax_config
from semireward_tpu.core import optim as joptim
from semireward_tpu.core.step import init_train_state as jax_init
from semireward_tpu.core.step import make_train_step as jax_make_step
from semireward_tpu.data.augment import pipeline as jpipe
from semireward_tpu.models import vit as jvit
from semireward_tpu.models import wrn as jwrn
from semireward_tpu.registry import ALGORITHMS as JALGS
from semireward_tpu_torch.algorithms import common as TC
from semireward_tpu_torch.algorithms import crmatch as tcr
from semireward_tpu_torch.algorithms import uda as tuda
from semireward_tpu_torch.algorithms import vat as tvat
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.convert import (flax_to_torch, load_flax_params,
                                          torch_name)
from semireward_tpu_torch.core import optim as toptim
from semireward_tpu_torch.core.step import init_train_state as torch_init
from semireward_tpu_torch.core.step import make_train_step as torch_make_step
from semireward_tpu_torch.data.augment import pipeline as tpipe
from semireward_tpu_torch.models import vit as tvit
from semireward_tpu_torch.models import wrn as twrn
from semireward_tpu_torch.registry import ALGORITHMS as TALGS
from test_torch_step import ARCH as FUSED_ARCH
from test_torch_step import EMB, NC, S, B, _check_leaf, _perturb
from test_torch_wrn import ARCH as WRN_ARCH
from test_torch_wrn import BN_MOM, _same_stats

ALGOS = ("pimodel", "meanteacher", "vat", "mixmatch", "remixmatch", "uda",
         "dash", "adamatch", "crmatch", "defixmatch")
CFG = dict(net="vit_small_patch2_32", num_classes=NC, batch_size=B, uratio=1,
           num_train_iter=10, epoch=1, optim="AdamW", lr=0.01,
           layer_decay=0.5, weight_decay=5e-4, ema_m=0.5, img_size=S,
           compute_dtype="float32", p_cutoff=0.45)
# per algorithm: config on top of CFG, chosen so that masks are mixed
OVER = {"uda": dict(tsa_schedule="log"), "dash": dict(rho_init=1.3),
        "adamatch": dict(p_cutoff=0.95),
        "vat": dict(unsup_warm_up=0.1), "mixmatch": dict(unsup_warm_up=0.1),
        "remixmatch": dict(unsup_warm_up=0.1)}
LB_CLASS_DIST = np.array([0.4, 0.3, 0.2, 0.1])
DATA_INFO = {"ulb_dest_len": 16, "lb_dest_len": 8,
             "lb_class_dist": LB_CLASS_DIST}
EXACT = ("util_ratio", "util_ratio_lb")
# test_torch_step.py's ViT with the MLP unfused: that file holds the fused
# MLP (the JAX kernel in interpret mode) against the port's; here JAX
# compiles a step of up to nine forwards, which the interpreted kernel
# makes slow, and JAX's VAT cannot differentiate through it at all
# (test_jax_vat_does_not_trace_through_the_fused_mlp)
ARCH = dict(FUSED_ARCH, use_fused_mlp=False)
VAT_DROP_PATH = 0.5
VAT_COS = 0.9999


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _jax_mixup_draws(key, n, alpha, is_bias):
    """The lambda and permutation JAX's ``mixup_one_target`` draws from
    ``key``."""
    k1, k2 = jax.random.split(key)
    lam = jax.random.beta(k1, alpha, alpha) if alpha > 0 else jnp.asarray(1.)
    if is_bias:
        lam = jnp.maximum(lam, 1 - lam)
    return np.asarray(lam, np.float32), np.asarray(
        jax.random.permutation(k2, n))


@pytest.mark.parametrize("alpha,is_bias", [(0.5, True), (0.75, True),
                                           (0.75, False), (0.0, False)])
def test_mixup_one_target_is_exact(alpha, is_bias):
    rs = np.random.RandomState(1)
    x = rs.randn(12, S, S, 3).astype(np.float32)
    y = np.eye(NC, dtype=np.float32)[rs.randint(0, NC, 12)]
    key = jax.random.PRNGKey(7)
    jx, jy, jlam = JC.mixup_one_target(key, jnp.asarray(x), jnp.asarray(y),
                                       alpha, is_bias)
    lam, index = _jax_mixup_draws(key, 12, alpha, is_bias)
    assert lam == np.asarray(jlam)
    tx, ty = TC.mixup_one_target(_t(x), _t(y), _t(lam), _t(index))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_draw_mixup_gives_a_biased_lambda_and_a_permutation():
    g = torch.Generator().manual_seed(3)
    lams = []
    for _ in range(200):
        lam, index = TC.draw_mixup(10, 0.75, True, g)
        assert lam.dtype == torch.float32 and lam.ndim == 0
        assert sorted(index.tolist()) == list(range(10))
        lams.append(float(lam))
    assert min(lams) >= 0.5 and max(lams) <= 1.0
    # E[max(l, 1 - l)] under Beta(0.75, 0.75) is about 0.78
    assert 0.74 < np.mean(lams) < 0.82
    lam, _ = TC.draw_mixup(4, 0.0, False, g)
    assert float(lam) == 1.0


@pytest.mark.parametrize("parts,batch", [(2, 8), (3, 10), (4, 13)])
def test_interleave_is_exact(parts, batch):
    rs = np.random.RandomState(parts)
    xy = [rs.randn(batch, 5).astype(np.float32) for _ in range(parts)]
    want = JC.interleave([jnp.asarray(v) for v in xy], batch)
    got = TC.interleave([_t(v) for v in xy], batch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rotation_views_are_bit_equal():
    rs = np.random.RandomState(2)
    x = rs.randn(6, S, S, 3).astype(np.float32)
    k = rs.randint(0, 4, 6)
    np.testing.assert_array_equal(
        tpipe.rot90_per_sample(_t(x), _t(k)).numpy(),
        np.asarray(jpipe._rot90_per_sample(jnp.asarray(x), jnp.asarray(k))))
    jx = jnp.asarray(x)
    want = jnp.concatenate([jx, jnp.rot90(jx, 1, (1, 2)),
                            jnp.rot90(jx, 2, (1, 2)),
                            jnp.rot90(jx, 3, (1, 2))], 0)
    np.testing.assert_array_equal(tpipe.rot90_views(_t(x)).numpy(),
                                  np.asarray(want))


def test_augment_views_makes_the_rotation_views():
    spec = tpipe.AugmentSpec(crop_size=S, crop_pad=2, mean=(0.5,) * 3,
                             std=(0.25,) * 3, randaug_n=2)
    rs = np.random.RandomState(4)
    raw = _t(rs.randint(0, 256, (B, S, S, 3)).astype(np.uint8))
    g = torch.Generator().manual_seed(0)
    out = tpipe.augment_views(raw, raw, spec, ["x_lb", "x_ulb_w", "x_ulb_s_0",
                                               "x_ulb_s_1", "x_ulb_s_0_rot"],
                              g)
    assert torch.equal(out["x_ulb_s_0_rot"], tpipe.rot90_per_sample(
        out["x_ulb_s_0"], out["rot_v"]))
    assert out["rot_v"].shape == (B,) and int(out["rot_v"].max()) < 4
    out = tpipe.augment_views(raw, raw, spec, ["x_lb", "x_ulb_w", "x_ulb_s",
                                               "x_ulb_rot"], g)
    assert out["x_ulb_rot"].shape == (4 * B, S, S, 3)
    assert out["rot_v"].tolist() == [r for r in range(4) for _ in range(B)]
    base = out["x_ulb_rot"][:B]
    assert torch.equal(out["x_ulb_rot"], tpipe.rot90_views(base))


@pytest.mark.parametrize("schedule", ["none", "linear", "exp", "log"])
def test_tsa_threshold(schedule):
    for step in (0, 1, 7, 333, 1000):
        want = float(juda.tsa_threshold(
            schedule, jnp.asarray(step, jnp.int32), 1000, 10))
        got = tuda.tsa_threshold(schedule, step, 1000, 10)
        assert abs(got - want) <= 1e-6 * abs(want), (step, got, want)


def test_vat_and_crmatch_losses():
    rs = np.random.RandomState(5)
    q, p = (rs.randn(9, NC).astype(np.float32) * 3 for _ in range(2))
    assert_rel_close(tvat.kl_div_with_logit(_t(q), _t(p)),
                     np.asarray(jvat.kl_div_with_logit(q, p)), 1e-6, "kl")
    assert_rel_close(tvat.entropy_loss(_t(q)),
                     np.asarray(jvat.entropy_loss(q)), 1e-6, "entropy")
    a, b = rs.randn(9, 7).astype(np.float32), rs.randn(9, 7).astype(np.float32)
    b[0] = -a[0]  # cos -1: clipped to 0
    a[1] = 0.0    # the norm floor
    assert_rel_close(tcr.cosine_embedding_loss_neg(_t(a), _t(b)),
                     np.asarray(jcr.cosine_embedding_loss_neg(a, b)), 1e-6,
                     "cos")
    d = rs.randn(3, S, S, 3).astype(np.float32)
    assert_rel_close(tvat.l2_normalize(_t(d)),
                     np.asarray(jvat._l2_normalize(d)), 1e-6, "l2")


def _japply(variables, x, train=True, mutable=False, rngs=None):
    """A JAX apply_fn whose "views" are the logits."""
    return {"logits": x, "feat": x}


def _tmodel(x, train=True, generator=None):
    return {"logits": x, "feat": x}


def test_dash_rho_schedule_and_masks():
    from semireward_tpu.algorithms.base import StepCtx as JCtx
    from semireward_tpu_torch.algorithms.base import StepCtx as TCtx

    kw = dict(algorithm="dash", num_classes=NC, num_train_iter=40, epoch=40,
              T=0.5, rho_init=0.1)
    jalg = JALGS.get("dash")(jax_config(**kw))
    talg = TALGS.get("dash")(torch_config(**kw), device=torch.device("cpu"))
    jst, tst = jalg.init_state(), talg.init_state()
    rs = np.random.RandomState(6)
    hard_seen = []
    for step in range(32):
        lg = {k: (rs.randn(B, NC) * 2).astype(np.float32)
              for k in ("x_lb", "x_ulb_w", "x_ulb_s")}
        y = rs.randint(0, NC, B)
        jb = {**{k: jnp.asarray(v) for k, v in lg.items()},
              "y_lb": jnp.asarray(y)}
        tb = {**{k: _t(v) for k, v in lg.items()}, "y_lb": _t(y)}
        jout = jalg.loss(JCtx(_japply, {}, {}, jb, jst, None,
                              jnp.asarray(step, jnp.int32)))
        tout = talg.loss(TCtx(_tmodel, tb, tst, None, step))
        jst, tst = jout.new_algo_state, tout.new_algo_state
        for k in ("rho", "rho_init"):
            assert_rel_close(getattr(tst, k), np.asarray(getattr(jst, k)),
                             1e-6, f"{step} {k}")
        assert int(tst.rho_update_cnt) == int(jst.rho_update_cnt), step
        assert bool(tst.use_hard_label) == bool(jst.use_hard_label), step
        np.testing.assert_array_equal(tout.mask.numpy(),
                                      np.asarray(jout.mask), str(step))
        assert_rel_close(tout.unsup_loss, np.asarray(jout.unsup_loss), 1e-6,
                         f"{step} unsup")
        hard_seen.append(bool(tst.use_hard_label))
    # updates at steps 0, 10, 20, 30; rho reaches rho_min at the fourth
    assert int(tst.rho_update_cnt) == 4
    assert hard_seen[29] is False and hard_seen[30] is True


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _wrapped_pair(name, net="vit"):
    """The JAX package's wrapped net (initialized, perturbed) and the port's
    with the same weights."""
    cfg = dict(CFG, algorithm=name)
    jalg = JALGS.get(name)(jax_config(**cfg), DATA_INFO)
    talg = TALGS.get(name)(torch_config(**cfg), DATA_INFO,
                           torch.device("cpu"))
    if net == "vit":
        jnet = jvit.vit_small_patch2_32(num_classes=NC, dtype=jnp.float32,
                                        **ARCH)
        tnet = tvit.vit_small_patch2_32(num_classes=NC, dtype=torch.float32,
                                        **ARCH)
    else:
        jnet = jwrn.wrn_28_2(NC, dtype=jnp.float32, bn_momentum=BN_MOM,
                             **WRN_ARCH)
        tnet = twrn.wrn_28_2(NC, dtype=torch.float32, bn_momentum=BN_MOM,
                             **WRN_ARCH)
    jm = jalg.wrap_model(jnet)
    tm = talg.wrap_model(tnet, torch.Generator().manual_seed(0))
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((2, S, S, 3)), train=False))(
        jax.random.PRNGKey(0))
    params = _perturb(v["params"], 0.05)
    load_flax_params(tm, jax.device_get(params),
                     jax.device_get(v.get("batch_stats")))
    return jalg, talg, jm, tm, params, v.get("batch_stats")


@pytest.mark.parametrize("name,net", [("remixmatch", "vit"),
                                      ("crmatch", "vit"),
                                      ("crmatch", "wrn")])
def test_wrapped_net_converts_and_matches(name, net):
    _, _, jm, tm, params, stats = _wrapped_pair(name, net)
    flat = flax_to_torch(jax.device_get(params))
    assert sorted(flat) == sorted(n for n, _ in tm.named_parameters())
    assert any(n.startswith("rot_classifier.") for n in flat)
    assert all(n.startswith(("backbone.", "rot_classifier.",
                             "ds_classifier.")) for n in flat)
    x = np.random.RandomState(8).randn(3, S, S, 3).astype(np.float32)
    v = {"params": params}
    if stats:
        v["batch_stats"] = stats
    jout = jax.jit(lambda v, x: jm.apply(v, x, train=False, use_rot=True))(
        v, jnp.asarray(x))
    tout = tm(_t(x), train=False, use_rot=True)
    assert sorted(tout) == sorted(jout)
    for k in jout:
        assert_rel_close(tout[k], np.asarray(jout[k]), 1e-5, k)
    # the converted weights go back to the same flax values
    for n, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), flat[n])


def test_projection_heads_match_jax():
    from semireward_tpu.models import wrappers as jw
    from semireward_tpu_torch.models import wrappers as tw

    for jcls, tcls in ((jw.ProjectionNet, tw.ProjectionNet),
                       (jw.SimMatchNet, tw.SimMatchNet)):
        jnet = jcls(backbone=jvit.vit_small_patch2_32(
            num_classes=NC, dtype=jnp.float32, **ARCH), proj_size=16)
        tnet = tcls(tvit.vit_small_patch2_32(num_classes=NC,
                                             dtype=torch.float32, **ARCH),
                    proj_size=16)
        v = jax.jit(lambda k: jnet.init(k, jnp.zeros((2, S, S, 3)),
                                        train=False))(jax.random.PRNGKey(1))
        params = _perturb(v["params"], 0.05)
        load_flax_params(tnet, jax.device_get(params))
        x = np.random.RandomState(9).randn(3, S, S, 3).astype(np.float32)
        jout = jax.jit(lambda p, x: jnet.apply({"params": p}, x,
                                               train=False))(
            params, jnp.asarray(x))
        tout = tnet(_t(x), train=False)
        for k in ("logits", "feat"):
            assert_rel_close(tout[k], np.asarray(jout[k]), 1e-5, k)
    h = np.random.RandomState(3).randn(5, 7).astype(np.float32)
    assert_rel_close(tw.l2norm(_t(h)), np.asarray(jw.l2norm(h)), 1e-6)


@pytest.mark.parametrize("name", ["remixmatch", "crmatch"])
def test_layer_decay_scales_of_a_wrapped_net_equal_jax(name):
    _, _, _, tm, params, _ = _wrapped_pair(name)
    builder = jvit.vit_small_patch2_32
    scales = joptim.layer_decay_scales(params, 0.5, builder.layer_id_fn,
                                       builder.num_layers)
    want = {torch_name([k.key for k in path]): float(v) for path, v in
            jax.tree_util.tree_flatten_with_path(scales)[0]}
    names = [n for n, _ in tm.named_parameters()]
    got = toptim.layer_decay_scales(names, 0.5, tvit.layer_id,
                                    tvit.vit_small_patch2_32.num_layers)
    assert got == want
    # JAX's layer id sees 'backbone' first: no layer decay under a wrapper
    assert set(got.values()) == {1.0}
    bare = [n for n, _ in tvit.vit_small_patch2_32(
        num_classes=NC, dtype=torch.float32, **ARCH).named_parameters()]
    assert len(set(toptim.layer_decay_scales(
        bare, 0.5, tvit.layer_id, 3).values())) == 4


def test_use_pretrain_on_a_wrapped_vit_raises_in_both(tmp_path):
    from semireward_tpu.models.utils import load_pretrained as jload
    from semireward_tpu_torch.core.trainer import Trainer

    _, _, _, tm, params, _ = _wrapped_pair("remixmatch")
    path = str(tmp_path / "vit.pth")
    torch.save({"model": {"pos_embed": torch.zeros(1, 17, EMB),
                          "cls_token": torch.zeros(1, 1, EMB)}}, path)
    with pytest.raises(KeyError, match="pos_embed"):
        jload("vit_small_patch2_32", params, path)
    cfg = torch_config(
        algorithm="remixmatch", net="vit_small_patch2_32",
        dataset="synthetic", num_classes=NC, num_labels=8, img_size=S,
        synthetic_train=32, synthetic_test=8, use_pretrain=True,
        pretrain_path=path, save_dir=str(tmp_path),
        net_kwargs={k: v for k, v in ARCH.items() if k != "img_size"})
    with pytest.raises(KeyError, match="pos_embed"):
        Trainer(cfg, device="cpu")


# ---------------------------------------------------------------------------
# three-step trajectories
# ---------------------------------------------------------------------------

def _views(rs, keys):
    v = {k: rs.randn(B, S, S, 3).astype(np.float32)
         for k in ("x_lb", "x_lb_s", "x_ulb_w", "x_ulb_s", "x_ulb_s_0",
                   "x_ulb_s_1") if k in keys}
    if "x_ulb_s_0_rot" in keys:
        rot = rs.randint(0, 4, B)
        v["x_ulb_s_0_rot"] = np.stack([np.rot90(img, k, (0, 1)) for img, k
                                       in zip(v["x_ulb_s_0"], rot)])
        v["rot_v"] = rot
    if "x_ulb_rot" in keys:
        base = rs.randn(B, S, S, 3).astype(np.float32)
        v["x_ulb_rot"] = np.concatenate([np.rot90(base, k, (1, 2))
                                         for k in range(4)])
        v["rot_v"] = np.repeat(np.arange(4), B)
    return {k: np.ascontiguousarray(a) for k, a in v.items()}


class _Masks:
    """Drop-path masks handed out in call order, the same sequence to both
    packages (``per_step`` calls a step, repeated every step)."""

    def __init__(self, masks):
        self.masks, self.i = masks, 0

    def __call__(self, x, rate, off, *, module):
        if off or rate == 0.0:
            return x
        m = self.masks[self.i % len(self.masks)]
        self.i += 1
        keep = 1.0 - rate
        if module == "jax":
            return jnp.where(jnp.asarray(m), x / keep, jnp.zeros_like(x))
        return torch.where(_t(m), x / keep, torch.zeros_like(x))


def _vat_masks():
    """Per step: lb, ulb, probe, adversarial forwards, two drop-path calls
    each (block 1 of 2); the probe and the adversarial forward share one
    key in the JAX package, so they share their masks."""
    rs = np.random.RandomState(11)
    m = [rs.rand(B, 1, 1) >= VAT_DROP_PATH for _ in range(6)]
    return m + m[4:6]


def _install_vat_masks(monkeypatch):
    """The same masks into both packages' drop-path; returns JAX's."""
    jm, tm = _Masks(_vat_masks()), _Masks(_vat_masks())
    monkeypatch.setattr(jvit, "_drop_path",
                        lambda x, r, det, rng: jm(x, r, det, module="jax"))
    monkeypatch.setattr(tvit, "_drop_path",
                        lambda x, r, train, g: tm(x, r, not train,
                                                  module="torch"))
    return jm


def _step_key(jstate, step):
    return jax.random.fold_in(jstate.rng, step)


def _jax_vat_grad_d(jmodel, params, x_ulb, d):
    """JAX's power iteration at ``params`` (the loss's own functions); the
    caller hands out the ulb and probe forwards' masks."""
    outs = jmodel.apply({"params": params}, x_ulb, train=True,
                        rngs={"dropout": jax.random.PRNGKey(0)})
    ul_y = jax.lax.stop_gradient(outs["logits"])

    def kl(dd):
        o = jmodel.apply({"params": params}, x_ulb + dd, train=True,
                         rngs={"dropout": jax.random.PRNGKey(0)})
        return jvat.kl_div_with_logit(ul_y, o["logits"])

    return jax.grad(kl)(d)


def _compare_state(step, tstate, jstate):
    algo = tstate.algo
    if algo == ():
        return
    for f in algo.__dataclass_fields__:
        got, want = getattr(algo, f), np.asarray(getattr(jstate.algo, f))
        if got.is_floating_point():
            assert_rel_close(got, want, 1e-5, f"{step} {f}")
        else:
            np.testing.assert_array_equal(got.numpy(), want, f"{step} {f}")


class _JitInit:
    """``model`` for ``init_train_state`` with its ``init`` compiled as one
    program (the eager init compiles every operation on its own)."""

    def __init__(self, model):
        self.init = jax.jit(model.init, static_argnames="train")


def _mixup_key(name, key):
    """The key JAX's MixMatch (ReMixMatch) hands ``mixup_one_target``, and
    the rows it mixes."""
    n = 3 if name == "mixmatch" else 4
    return jax.random.split(key, 8 if name == "mixmatch" else 12)[n], n * B


def _vat_probe(key, shape):
    """JAX's VAT probe ``d`` from the step's key."""
    d = jax.random.normal(jax.random.split(key, 4)[2], shape, jnp.float32)
    return 1e-6 * jvat._l2_normalize(d)


def run_steps(name, monkeypatch, steps=3):
    """``steps`` steps of ``name`` in both packages from the same weights on
    the same views, the JAX step's MixUp and VAT draws injected into the
    port; compared after each step as the module docstring says. Returns
    the mask ratios seen and the port's state."""
    cfg = dict(CFG, algorithm=name, **OVER.get(name, {}))
    jcfg, tcfg = jax_config(**cfg), torch_config(**cfg)
    jalg = JALGS.get(name)(jcfg, DATA_INFO)
    talg = TALGS.get(name)(tcfg, DATA_INFO, torch.device("cpu"))
    arch = dict(ARCH)
    if name == "vat":
        arch["drop_path_rate"] = VAT_DROP_PATH
        jm = _install_vat_masks(monkeypatch)
    builder = jvit.vit_small_patch2_32
    jmodel = jalg.wrap_model(builder(num_classes=NC, dtype=jnp.float32,
                                     **arch))
    tmodel = talg.wrap_model(tvit.vit_small_patch2_32(
        num_classes=NC, dtype=torch.float32, **arch),
        torch.Generator().manual_seed(0))
    jstate, tx = jax_init(jcfg, jalg, _JitInit(jmodel), jax.random.PRNGKey(0),
                          jnp.zeros((2, S, S, 3)), builder=builder)
    params = _perturb(jstate.params, 0.02)
    jstate = jstate.replace(params=params, ema_params=params)
    load_flax_params(tmodel, jax.device_get(params))
    tstate = torch_init(tcfg, talg, tmodel, builder=tvit.vit_small_patch2_32)
    jstep = jax.jit(jax_make_step(jcfg, jalg, jmodel, tx))
    tstep = torch_make_step(tcfg, talg)

    draws, grads = {}, []
    if name in ("mixmatch", "remixmatch"):
        monkeypatch.setattr(TC, "draw_mixup", lambda *a: draws["mixup"])
    if name == "vat":
        grad_d_fn = jax.jit(lambda p, x, d: _jax_vat_grad_d(jmodel, p, x, d))
        monkeypatch.setattr(tvat, "draw_probe", lambda x, g: draws["d"])
        power = tvat.power_iteration
        monkeypatch.setattr(tvat, "power_iteration", lambda *a: grads.append(
            power(*a)) or grads[-1])

    rs = np.random.RandomState(0)
    names = [n for n, _ in tmodel.named_parameters()]
    mask_values = set()
    for step in range(steps):
        views = _views(rs, talg.BATCH_KEYS)
        y = rs.randint(0, NC, B)
        jbatch = {**{k: jnp.asarray(v) for k, v in views.items()},
                  "y_lb": jnp.asarray(y)}
        tbatch = {**{k: _t(v) for k, v in views.items()}, "y_lb": _t(y)}
        key = _step_key(jstate, step)
        if name in ("mixmatch", "remixmatch"):
            lam, index = _jax_mixup_draws(*_mixup_key(name, key),
                                          jcfg.mixup_alpha, True)
            draws["mixup"] = (_t(lam), _t(index))
        if name == "vat":
            d = _vat_probe(key, views["x_ulb_w"].shape)
            draws["d"] = _t(np.asarray(d))
            jm.i = 2  # calls 2-5 of the step: the ulb and probe forwards
            want_grad = np.asarray(grad_d_fn(jstate.params,
                                             jbatch["x_ulb_w"], d))
            jm.i = 0
        jstate, jm_out = jstep(jstate, jbatch)
        tm_out = tstep(tstate, tbatch)

        assert sorted(tm_out) == sorted(jm_out), (sorted(tm_out),
                                                  sorted(jm_out))
        for k, v in jm_out.items():
            if k in EXACT:
                assert float(tm_out[k]) == float(v), (step, k)
                mask_values.add(float(v))
            else:
                assert_rel_close(tm_out[k], np.asarray(v), 1e-5, f"{step} {k}")
        _compare_state(step, tstate, jstate)
        if name == "vat":
            got = grads[-1].numpy().reshape(B, -1)
            want = want_grad.reshape(B, -1)
            cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                         * np.linalg.norm(want, axis=1))
            assert cos.min() >= VAT_COS, (step, cos)
            r_adv = tcfg.vat_eps * tvat.l2_normalize(grads[-1])
            norms = r_adv.reshape(B, -1).norm(dim=1)
            assert_rel_close(norms, np.full(B, tcfg.vat_eps), 1e-5, "r_adv")
        bound = 2 * CFG["lr"] * (step + 1) + 1e-6
        want, want_ema = (flax_to_torch(jax.device_get(t)) for t in
                          (jstate.params, jstate.ema_params))
        for n, p, e in zip(names, tmodel.parameters(), tstate.ema):
            _check_leaf(n, p.detach().numpy(), want[n], bound)
            _check_leaf(n, e.numpy(), want_ema[n], bound)
    assert tstate.step == steps and int(jstate.step) == steps
    assert all(math.isfinite(float(v)) for v in tm_out.values())
    return mask_values, tstate


@pytest.mark.parametrize("name", ALGOS)
def test_three_steps_match_jax(name, monkeypatch):
    mask_values, tstate = run_steps(name, monkeypatch)
    if name in ("uda", "dash", "adamatch", "crmatch", "defixmatch"):
        # the threshold passed some samples and not others at some step
        assert any(0.0 < v < 1.0 for v in mask_values), mask_values
    if name in ("remixmatch", "adamatch"):
        assert bool(tstate.algo.initialized)
        assert not torch.equal(tstate.algo.p_model,
                               torch.zeros_like(tstate.algo.p_model))


# which forwards of one loss update the running statistics, in order
BN_MOVED = {"mixmatch": [False, False, True, False, False],
            "remixmatch": [False, False, True, False, False, False, False],
            "vat": [True, False, False, False],
            "pimodel": [True, False, False]}


@pytest.mark.parametrize("name", sorted(BN_MOVED))
def test_batchnorm_branches_on_the_wrn(name, monkeypatch):
    """One loss of each package on the WRN (the JAX loss jitted alone, no
    backward): losses within 1e-5 (VAT: the terms its noise direction does
    not reach), the port's running statistics equal to the JAX loss's new
    ``batch_stats``, and only the forwards of ``BN_MOVED`` moving them."""
    from semireward_tpu.algorithms.base import StepCtx as JCtx
    from semireward_tpu_torch.algorithms.base import StepCtx as TCtx
    from semireward_tpu_torch.models.batchnorm import BatchNorm

    jalg, talg, jm, tm, params, stats = _wrapped_pair(name, "wrn")
    rng = jax.random.PRNGKey(5)
    rs = np.random.RandomState(13)
    views = _views(rs, talg.BATCH_KEYS)
    y = rs.randint(0, NC, B)
    jbatch = {**{k: jnp.asarray(v) for k, v in views.items()},
              "y_lb": jnp.asarray(y)}
    tbatch = {**{k: _t(v) for k, v in views.items()}, "y_lb": _t(y)}
    if name in ("mixmatch", "remixmatch"):
        lam, index = _jax_mixup_draws(*_mixup_key(name, rng),
                                      jalg.cfg.mixup_alpha, True)
        monkeypatch.setattr(TC, "draw_mixup",
                            lambda *a: (_t(lam), _t(index)))
    if name == "vat":
        d = _t(np.asarray(_vat_probe(rng, views["x_ulb_w"].shape)))
        monkeypatch.setattr(tvat, "draw_probe", lambda x, g: d)

    @jax.jit
    def jloss(params, stats, batch):
        out = jalg.loss(JCtx(jm.apply, params, stats, batch,
                             jalg.init_state(), rng,
                             jnp.asarray(1, jnp.int32)))
        return out.metrics, out.new_batch_stats

    jmetrics, new_stats = jloss(params, stats, jbatch)
    moved = []
    bn = [m for m in tm.modules() if isinstance(m, BatchNorm)][-1]
    orig = twrn.WideResNet.forward

    def spy(self, x, train=True, only_fc=False, only_feat=False,
            generator=None):
        before = bn.running_mean.clone()
        out = orig(self, x, train, only_fc, only_feat, generator)
        if not only_fc:
            moved.append(not torch.equal(before, bn.running_mean))
        return out

    monkeypatch.setattr(twrn.WideResNet, "forward", spy)
    out = talg.loss(TCtx(tm, tbatch, talg.init_state(), None, 1))
    assert moved == BN_MOVED[name]
    _same_stats(tm, new_stats, name)
    keys = ("sup_loss", "loss_entmin") if name == "vat" else jmetrics
    for k in keys:
        assert_rel_close(out.metrics[k], np.asarray(jmetrics[k]), 1e-5, k)


# ---------------------------------------------------------------------------
# Dash's warm-up stage against the JAX Trainer's
# ---------------------------------------------------------------------------

WU = 3


def _dash_cfg(save_dir, jax_side):
    d = dict(algorithm="dash", net="vit_small_patch2_32", dataset="synthetic",
             num_classes=NC, num_labels=8, batch_size=B, uratio=1,
             eval_batch_size=8, img_size=S, num_train_iter=6,
             num_eval_iter=100, num_log_iter=1, epoch=1, seed=3,
             optim="AdamW", lr=0.01, layer_decay=0.5, ema_m=0.5,
             compute_dtype="float32", num_wu_iter=WU, num_wu_eval_iter=1,
             save_dir=str(save_dir))
    net_kwargs = {k: v for k, v in ARCH.items() if k != "img_size"}
    net_kwargs["use_fused_mlp"] = False
    extra = dict(synthetic_train=48, synthetic_test=8, prefetch_depth=0,
                 use_fused_mlp=False, use_flash_attention=False,
                 net_kwargs=net_kwargs)
    if jax_side:
        cfg = jax_config(dict(d, mesh_shape=(1,)))
        cfg.extra.update(extra)
        return cfg
    return torch_config(**d, **extra)


def test_dash_warmup_matches_the_jax_trainer(tmp_path, monkeypatch):
    import semireward_tpu.core.trainer as jtr
    import semireward_tpu_torch.core.trainer as ttr
    from semireward_tpu.data.augment import normalize as jnorm
    from semireward_tpu_torch.data.augment import normalize as tnorm

    # views without random draws: every view is the normalized raw image
    monkeypatch.setattr(jtr, "augment_views", lambda rng, lb, ulb, spec, keys,
                        weak_ulb_s=False: {k: jnorm(lb if k.startswith("x_lb")
                                                    else ulb, spec.mean,
                                                    spec.std) for k in keys})
    monkeypatch.setattr(ttr, "augment_views", lambda lb, ulb, spec, keys,
                        g=None, weak_ulb_s=False: {
                            k: tnorm(lb if k.startswith("x_lb") else ulb,
                                     spec.mean, spec.std) for k in keys})
    jt = jtr.Trainer(_dash_cfg(tmp_path / "jax", True), use_mesh=False)
    tt = ttr.Trainer(_dash_cfg(tmp_path / "port", False), device="cpu")
    load_flax_params(tt.model, jax.device_get(jt.state.params))
    with torch.no_grad():
        for e, p in zip(tt.state.ema, tt.model.parameters()):
            e.copy_(p)
    jt.train(num_iters=1)
    jt.sink.close()
    tt.train(num_iters=1)

    jst, tst = jt.state.algo, tt.state.algo
    assert_rel_close(tst.rho_init, np.asarray(jst.rho_init), 1e-5, "rho_init")
    assert_rel_close(tst.rho, np.asarray(jst.rho), 1e-5, "rho")
    assert int(jt.state.step) == tt.state.step == 1
    assert tt.state.opt.count == WU + 1
    want = flax_to_torch(jax.device_get(jt.state.params))
    for n, p in tt.model.named_parameters():
        _check_leaf(n, p.detach().numpy(), want[n], 2 * 0.01 * (WU + 1))

    def lrs(run_dir):
        with open(run_dir / "run" / "metrics.jsonl") as f:
            return [json.loads(line)["lr"] for line in f if "lr" in line]

    assert lrs(tmp_path / "port") == pytest.approx(lrs(tmp_path / "jax"),
                                                   rel=1e-6)
    assert lrs(tmp_path / "port")[0] == tt._schedule(1 + WU)


def test_jax_vat_does_not_trace_through_the_fused_mlp():
    """A JAX-package behaviour the port does not share: JAX's VAT step on a
    ViT with the fused MLP (its custom_vjp) fails to trace, since the power
    iteration's gradient is differentiated again under the step's; the
    port's autograd takes the fused MLP's plain version (and on a card its
    kernels) through both."""
    cfg = dict(CFG, algorithm="vat")
    jcfg, tcfg = jax_config(**cfg), torch_config(**cfg)
    jalg = JALGS.get("vat")(jcfg, DATA_INFO)
    jmodel = jvit.vit_small_patch2_32(num_classes=NC, dtype=jnp.float32,
                                      **FUSED_ARCH)
    jstate, tx = jax_init(jcfg, jalg, jmodel, jax.random.PRNGKey(0),
                          jnp.zeros((2, S, S, 3)),
                          builder=jvit.vit_small_patch2_32)
    rs = np.random.RandomState(12)
    views = {k: rs.randn(B, S, S, 3).astype(np.float32)
             for k in ("x_lb", "x_ulb_w")}
    y = rs.randint(0, NC, B)
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.jit(jax_make_step(jcfg, jalg, jmodel, tx))(
            jstate, {**{k: jnp.asarray(v) for k, v in views.items()},
                     "y_lb": jnp.asarray(y)})
    talg = TALGS.get("vat")(tcfg, DATA_INFO, torch.device("cpu"))
    tmodel = tvit.vit_small_patch2_32(num_classes=NC, dtype=torch.float32,
                                      **FUSED_ARCH)
    assert tmodel.blocks[0].mlp.use_fused
    tstate = torch_init(tcfg, talg, tmodel, builder=tvit.vit_small_patch2_32)
    m = torch_make_step(tcfg, talg)(tstate, {**{k: _t(v) for k, v in
                                                views.items()},
                                             "y_lb": _t(y)})
    assert all(math.isfinite(float(v)) for v in m.values())
