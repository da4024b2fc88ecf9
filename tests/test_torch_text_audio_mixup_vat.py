"""The text and audio forms of MixMatch, ReMixMatch and VAT in the port,
held against the JAX package on the same seeded numpy inputs, flax weights
converted and the random draws injected (MixUp's lambda and permutation
and VAT's probe recomputed from the JAX step's key, as in
``test_torch_usb_algorithms.py``).

- Three-step trajectories on the small BERT of ``test_torch_nlp_step.py``
  (token dicts) and the small HuBERT of ``test_torch_audio_step.py``
  (waveforms), both run at ``train=False`` on both sides (the dropout
  streams are not matched), float32 compute, SGD with momentum (as
  ``test_torch_comatch_simmatch.py``, whose harness and tolerances these
  are: losses within 1e-5 of their magnitude, the algorithm state within
  1e-5, every parameter and the EMA within 1e-4 of their leaf's largest
  magnitude): MixMatch and ReMixMatch with ``mixup_manifold`` (features
  mixed, chunks through ``only_fc``; ReMixMatch at ``rot_loss_ratio`` 0)
  and VAT with ``vat_embed`` on text; MixMatch, VAT and ReMixMatch
  (``rot_loss_ratio`` 0) in input space on audio.
- VAT on text: the port's power-iteration gradient held to JAX's by
  cosine (>= 0.9999, per sample) at float32 compute, and ``r_adv``'s norm
  to ``vat_eps`` (1e-5). Its consistency loss, a KL divergence computed as
  the difference of two sums of the entropy's magnitude (about 1.4 here,
  the loss itself about 1e-4), is held within 1e-5 of that magnitude:
  float32 leaves about 1e-7 of it in either package. On audio JAX's gradient is exactly 0 (the
  frozen extractor's ``stop_gradient``), so is the port's ``r_adv``, taken
  without a probed forward; the probe's forward in the port could not be
  differentiated at all (``torch.no_grad`` extractor).
- The manifold form on the WRN (BatchNorm statistics left as they were, as
  JAX's ``new_batch_stats`` is None) and on the ViT: one loss each.
- Each configuration the JAX loss fails on fails alike in the port, with
  the same exception type, when the algorithm is built.
- The text and audio loaders give JAX's batches for MixMatch's, ReMixMatch's
  and VAT's keys (``x_ulb_s_0_rot`` drawn as a strong view); RotNet over
  BERT and HuBERT converts and gives JAX's outputs.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_audio_step as AU
import test_torch_comatch_simmatch as CS
import test_torch_nlp_step as NL
from _torch_port import assert_rel_close
from semireward_tpu.algorithms import vat as jvat
from semireward_tpu.config import get_config as jax_config
from semireward_tpu.core.step import init_train_state as jax_init
from semireward_tpu.core.step import make_train_step as jax_make_step
from semireward_tpu.models import bert as jbert
from semireward_tpu.models import hubert as jhubert
from semireward_tpu.models import wrn as jwrn
from semireward_tpu.registry import ALGORITHMS as JALGS
from semireward_tpu_torch.algorithms import common as TC
from semireward_tpu_torch.algorithms import vat as tvat
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.convert import flax_to_torch, load_flax_params
from semireward_tpu_torch.core.step import init_train_state as torch_init
from semireward_tpu_torch.core.step import make_train_step as torch_make_step
from semireward_tpu_torch.models import bert as tbert
from semireward_tpu_torch.models import hubert as thubert
from semireward_tpu_torch.models import vit as tvit
from semireward_tpu_torch.models import wrn as twrn
from semireward_tpu_torch.registry import ALGORITHMS as TALGS
from test_torch_step import NC, S, B, _perturb
from test_torch_usb_algorithms import (_jax_mixup_draws, _mixup_key,
                                       _step_key, _vat_probe)
from test_torch_wrn import ARCH as WRN_ARCH
from test_torch_wrn import BN_MOM

DATA_INFO = dict(CS.DATA_INFO, lb_class_dist=np.array([0.4, 0.3, 0.2, 0.1]))
VAT_COS = 0.9999
_t = CS._t


class EvalNet(CS.TorchEvalNet):
    """The port's net at ``train=False`` with what the algorithms read off
    the net it holds."""

    @property
    def input_grad_is_zero(self):
        return getattr(self.net, "input_grad_is_zero", False)


def _pair(net):
    if net == "bert":
        jnet = NL.JaxEvalNet(jbert.ClassificationBert(
            num_classes=NC, vocab_size=NL.VOCAB, dtype=jnp.float32,
            **NL.GEOM))
        with torch.device("meta"):
            tnet = tbert.ClassificationBert(NC, vocab_size=NL.VOCAB,
                                            dtype=torch.float32, **NL.GEOM)
        sample = {"input_ids": jnp.zeros((2, NL.L), jnp.int32),
                  "attention_mask": jnp.ones((2, NL.L), jnp.int32)}
        return jnet, EvalNet(tnet.to_empty(device="cpu")), sample
    jnet = AU.JaxEvalNet(jhubert.ClassificationAudioTransformer(
        num_classes=NC, dtype=jnp.float32, **AU.GEOM))
    tnet = EvalNet(thubert.hubert_base(NC, dtype=torch.float32, **AU.GEOM))
    return jnet, tnet, jnp.zeros((2, AU.T))


def _config(name, net, over):
    return dict(CS.BASE, algorithm=name, net=CS.NETS[net], num_classes=NC,
                img_size=S, unsup_warm_up=0.1,
                feature_dim=(NL.GEOM if net == "bert" else AU.GEOM)["hidden"],
                **over)


def _jax_vat_grad_d(jmodel, params, x_ulb, d, embed):
    """JAX's power iteration at ``params`` (the loss's own functions): on
    the embeddings of the token dict with ``embed``, else on the input."""
    rngs = {"dropout": jax.random.PRNGKey(0)}
    outs = jmodel.apply({"params": params}, x_ulb, train=True, rngs=rngs,
                        **({"return_embed": True} if embed else {}))
    ul_y = jax.lax.stop_gradient(outs["logits"])
    base = jax.lax.stop_gradient(outs["embed"]) if embed else x_ulb

    def kl(dd):
        inp = ({"attention_mask": x_ulb["attention_mask"],
                "input_ids": x_ulb["input_ids"], "inputs_embeds": base + dd}
               if embed else base + dd)
        o = jmodel.apply({"params": params}, inp, train=True, rngs=rngs)
        return jvat.kl_div_with_logit(ul_y, o["logits"])

    return jax.grad(kl)(d)


def _same_state(step, tnode, jnode):
    if hasattr(tnode, "__dataclass_fields__"):
        CS._compare_state(step, tnode, jnode)


def run_steps(name, net, over, monkeypatch, steps=3):
    """``steps`` steps of ``name`` in both packages from the same weights on
    the same views, the JAX step's MixUp and VAT draws injected into the
    port; compared after each step as the module docstring says. Returns
    the port's metrics and the VAT records (``grad_d``, ``r_adv``)."""
    cfg = _config(name, net, over)
    jcfg, tcfg = jax_config(**cfg), torch_config(**cfg)
    jalg = JALGS.get(name)(jcfg, DATA_INFO)
    talg = TALGS.get(name)(tcfg, DATA_INFO, torch.device("cpu"))
    jnet, tnet, sample = _pair(net)
    jmodel = jalg.wrap_model(jnet)
    tmodel = talg.wrap_model(tnet, torch.Generator().manual_seed(0))
    txs = []

    def init(rng):
        state, tx = jax_init(jcfg, jalg, jmodel, rng, sample)
        txs.append(tx)
        return state

    jstate = jax.jit(init)(jax.random.PRNGKey(0))
    jstep = jax.jit(jax_make_step(jcfg, jalg, jmodel, txs[0]))
    load_flax_params(tmodel, jax.device_get(jstate.params))
    tstate = torch_init(tcfg, talg, tmodel)
    if name == "remixmatch":
        CS._carry(tstate.algo, jstate.algo)
    tstep = torch_make_step(tcfg, talg)

    draws, rec = {}, {"grad_d": [], "r_adv": []}
    embed = name == "vat" and net == "bert"
    if name in ("mixmatch", "remixmatch"):
        monkeypatch.setattr(TC, "draw_mixup", lambda *a: draws["mixup"])
    if name == "vat":
        grad_d_fn = jax.jit(lambda p, x, d: _jax_vat_grad_d(jmodel, p, x, d,
                                                            embed))
        monkeypatch.setattr(tvat, "draw_probe", lambda x, g: draws["d"])
        perturb = tvat.adversarial_perturbation

        def spy(*a):
            r_adv, g = perturb(*a)
            rec["r_adv"].append(r_adv)
            rec["grad_d"].append(g)
            return r_adv, g

        monkeypatch.setattr(tvat, "adversarial_perturbation", spy)

    rs = np.random.RandomState(0)
    names = [n for n, _ in tmodel.named_parameters()]
    for step in range(steps):
        views = CS._views(net, rs, talg.BATCH_KEYS)
        y = rs.randint(0, NC, B)
        jbatch = {**CS._to(views, jnp.asarray), "y_lb": jnp.asarray(y)}
        tbatch = {**CS._to(views, _t), "y_lb": _t(y)}
        key = _step_key(jstate, step)
        if name in ("mixmatch", "remixmatch"):
            lam, index = _jax_mixup_draws(*_mixup_key(name, key),
                                          jcfg.mixup_alpha, True)
            draws["mixup"] = (_t(lam), _t(index))
        if name == "vat":
            shape = ((B, NL.L, NL.GEOM["hidden"]) if embed
                     else views["x_ulb_w"].shape)
            d = _vat_probe(key, shape)
            draws["d"] = _t(np.asarray(d))
            want_grad = np.asarray(grad_d_fn(jstate.params,
                                             jbatch["x_ulb_w"], d))
        jstate, jm = jstep(jstate, jbatch)
        tm = tstep(tstate, tbatch)

        assert sorted(tm) == sorted(jm), (sorted(tm), sorted(jm))
        for k, v in jm.items():
            if k == "unsup_loss" and name == "vat":
                # KL = sum q log q - sum q log p: two sums of the entropy's
                # magnitude (loss_entmin), whose float32 rounding (~1e-7)
                # the small difference keeps in both packages
                scale = max(abs(float(v)), float(jm["loss_entmin"]))
                assert abs(float(tm[k]) - float(v)) <= 1e-5 * scale, (
                    step, float(tm[k]), float(v))
            else:
                assert_rel_close(tm[k], np.asarray(v), 1e-5, f"{step} {k}")
        _same_state(step, tstate.algo, jstate.algo)
        if name == "vat":
            got = rec["grad_d"][-1].numpy().reshape(B, -1)
            want = want_grad.reshape(B, -1)
            if embed:
                cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                             * np.linalg.norm(want, axis=1))
                assert cos.min() >= VAT_COS, (step, cos)
                norms = rec["r_adv"][-1].reshape(B, -1).norm(dim=1)
                assert_rel_close(norms, np.full(B, tcfg.vat_eps), 1e-5,
                                 "r_adv")
            else:
                assert not want.any() and not got.any(), step
                assert not bool(rec["r_adv"][-1].any()), step
        want, want_ema = (flax_to_torch(jax.device_get(t)) for t in
                          (jstate.params, jstate.ema_params))
        for n, p, e in zip(names, tmodel.parameters(), tstate.ema):
            CS._check_leaf(n, p.detach().numpy(), want[n])
            CS._check_leaf(n, e.numpy(), want_ema[n])
    assert tstate.step == steps and int(jstate.step) == steps
    assert all(math.isfinite(float(v)) for v in tm.values())
    return tm, rec


CASES = {
    "mixmatch_manifold_bert": ("mixmatch", "bert",
                               dict(mixup_manifold=True)),
    "remixmatch_manifold_bert": ("remixmatch", "bert",
                                 dict(mixup_manifold=True,
                                      rot_loss_ratio=0.0)),
    "vat_embed_bert": ("vat", "bert", dict(vat_embed=True)),
    "mixmatch_hubert": ("mixmatch", "hubert", {}),
    "vat_hubert": ("vat", "hubert", {}),
    "remixmatch_hubert": ("remixmatch", "hubert", dict(rot_loss_ratio=0.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_jax(case, monkeypatch):
    name, net, over = CASES[case]
    forwards = []
    if case == "vat_hubert":
        # the probed forward is not run: lb, ulb and adversarial alone
        orig = thubert.ClassificationAudioTransformer.forward
        monkeypatch.setattr(
            thubert.ClassificationAudioTransformer, "forward",
            lambda self, x, *a, **kw: forwards.append(1) or orig(
                self, x, *a, **kw))
    tm, rec = run_steps(name, net, over, monkeypatch)
    assert float(tm["unsup_loss"]) > 0 or case == "vat_hubert"
    if case == "vat_hubert":
        assert len(forwards) == 3 * 3
        assert float(tm["unsup_loss"]) == 0.0  # the clean clip again
    if name == "remixmatch":
        assert float(tm["rot_loss"]) == 0.0 and float(tm["u1_loss"]) > 0


def test_vat_on_audio_takes_jaxs_zero_without_a_probe_backward():
    """JAX's power iteration on a waveform is exactly 0; the port's
    perturbation is that zero, its ``r_adv`` 0, with the generator where
    the probe's draw left it (the adversarial forward draws what the
    probed one would have); differentiating the probed forward in the port
    raises, since its extractor runs without gradient."""
    jnet, tnet, sample = _pair("hubert")
    params = jax.jit(lambda k: jnet.init(k, sample, train=False))(
        jax.random.PRNGKey(1))["params"]
    load_flax_params(tnet, jax.device_get(params))
    x = np.random.RandomState(3).randn(B, AU.T).astype(np.float32)
    d = _vat_probe(jax.random.PRNGKey(2), x.shape)
    g = jax.jit(lambda p, x, d: _jax_vat_grad_d(jnet, p, x, d, False))(
        params, jnp.asarray(x), d)
    assert not np.asarray(g).any()
    ul_y = tnet(_t(x))["logits"].detach()
    gen = torch.Generator().manual_seed(4)
    r_adv, grad_d = tvat.adversarial_perturbation(tnet, _t(x), ul_y, 6.0, gen)
    assert r_adv.shape == x.shape and not r_adv.any() and not grad_d.any()
    probe_only = torch.Generator().manual_seed(4)
    tvat.draw_probe(_t(x), probe_only)
    assert torch.equal(gen.get_state(), probe_only.get_state())
    with pytest.raises(RuntimeError, match="does not require grad|not have "
                       "been used"):
        tvat.power_iteration(tnet, _t(x), ul_y, _t(np.asarray(d)))


@pytest.mark.parametrize("net", ["bert", "vit"])
def test_the_adversarial_forward_draws_the_probes_masks(net):
    """In training, the probed and the adversarial forwards draw the same
    dropout (BERT) or drop-path (ViT) masks, as the JAX package gives both
    one key: the perturbation leaves the generator where the probed
    forward started, so a forward at ``x + d`` from there gives the probed
    forward's logits bit for bit, and one from anywhere else does not."""
    gen = torch.Generator().manual_seed(5)
    rs = np.random.RandomState(6)
    if net == "bert":
        model = tbert.bert_base_uncased(NC, dtype=torch.float32, **NL.GEOM)
        tokens = {k: _t(v) for k, v in CS._views(
            "bert", rs, ("x_ulb_w",))["x_ulb_w"].items()}
        out = model(tokens, train=True, return_embed=True, generator=gen)
        x = out["embed"].detach()
    else:
        model = tvit.vit_small_patch2_32(
            num_classes=NC, dtype=torch.float32,
            **dict(CS.ARCH, drop_path_rate=0.5))
        tokens = None
        x = _t(rs.randn(B, S, S, 3).astype(np.float32))
        out = model(x, train=True, generator=gen)
    seen = []
    power = tvat.power_iteration

    def spy(model, x, ul_y, d, generator=None, tokens=None):
        seen.append((d, generator.get_state()))
        return power(model, x, ul_y, d, generator, tokens)

    tvat.power_iteration = spy
    try:
        tvat.adversarial_perturbation(model, x, out["logits"].detach(), 6.0,
                                      gen, tokens)
    finally:
        tvat.power_iteration = power
    d, state = seen[0]
    assert torch.equal(gen.get_state(), state)
    probed = tvat.perturbed_forward(model, x + d, tokens, gen)["logits"]
    other = tvat.perturbed_forward(model, x + d, tokens, gen)["logits"]
    gen.set_state(state)
    again = tvat.perturbed_forward(model, x + d, tokens, gen)["logits"]
    assert torch.equal(probed, again)
    assert not torch.equal(probed, other)


@pytest.mark.parametrize("name,net", [("mixmatch", "wrn"),
                                      ("remixmatch", "wrn"),
                                      ("mixmatch", "vit"),
                                      ("remixmatch", "vit")])
def test_manifold_loss_on_images_matches_jax(name, net, monkeypatch):
    """One loss of each package with ``mixup_manifold`` on the WRN and the
    ViT (ReMixMatch with its rotation head, which images have): the metrics
    within 1e-5, and on the WRN no BatchNorm statistic moved (every
    backbone forward frozen, the chunks through the head alone: JAX's
    ``new_batch_stats`` is None)."""
    from semireward_tpu.algorithms.base import StepCtx as JCtx
    from semireward_tpu_torch.algorithms.base import StepCtx as TCtx
    from test_torch_usb_algorithms import _views

    cfg = dict(CS.BASE, algorithm=name, num_classes=NC, img_size=S,
               mixup_manifold=True, unsup_warm_up=0.1,
               net="wrn_28_2" if net == "wrn" else "vit_small_patch2_32")
    jalg = JALGS.get(name)(jax_config(**cfg), DATA_INFO)
    talg = TALGS.get(name)(torch_config(**cfg), DATA_INFO,
                           torch.device("cpu"))
    if net == "wrn":
        jnet = jwrn.wrn_28_2(NC, dtype=jnp.float32, bn_momentum=BN_MOM,
                             **WRN_ARCH)
        tnet = twrn.wrn_28_2(NC, dtype=torch.float32, bn_momentum=BN_MOM,
                             **WRN_ARCH)
    else:
        jnet, tnet, _, _ = CS._vit_pair()
    jm = jalg.wrap_model(jnet)
    tm = talg.wrap_model(tnet, torch.Generator().manual_seed(0))
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((2, S, S, 3)), train=False))(
        jax.random.PRNGKey(0))
    params = _perturb(v["params"], 0.02)
    stats = v.get("batch_stats", {})
    load_flax_params(tm, jax.device_get(params),
                     jax.device_get(stats) if stats else None)
    before = {n: b.clone() for n, b in tm.named_buffers()}
    rng = jax.random.PRNGKey(5)
    rs = np.random.RandomState(13)
    views = _views(rs, talg.BATCH_KEYS)
    y = rs.randint(0, NC, B)
    jbatch = {**{k: jnp.asarray(x) for k, x in views.items()},
              "y_lb": jnp.asarray(y)}
    tbatch = {**{k: _t(x) for k, x in views.items()}, "y_lb": _t(y)}
    lam, index = _jax_mixup_draws(*_mixup_key(name, rng),
                                  jalg.cfg.mixup_alpha, True)
    monkeypatch.setattr(TC, "draw_mixup", lambda *a: (_t(lam), _t(index)))
    state = jalg.init_state()

    @jax.jit
    def jloss(params, stats, batch):
        out = jalg.loss(JCtx(jm.apply, params, stats, batch, state, rng,
                             jnp.asarray(1, jnp.int32)))
        return out.metrics, out.new_batch_stats

    jmetrics, new_stats = jloss(params, stats, jbatch)
    tstate = talg.init_state()
    if name == "remixmatch":
        CS._carry(tstate, state)
    out = talg.loss(TCtx(tm, tbatch, tstate, None, 1))
    assert new_stats is None
    for n, b in tm.named_buffers():
        assert torch.equal(b, before[n]), n
    if net == "wrn":
        assert any(n.endswith("running_mean") for n in before)
    assert sorted(out.metrics) == sorted(jmetrics)
    for k in jmetrics:
        assert_rel_close(out.metrics[k], np.asarray(jmetrics[k]), 1e-5, k)
    if name == "remixmatch":
        assert float(out.metrics["rot_loss"]) > 0


# the configurations the JAX loss fails on at its first step: (algorithm,
# net, switches, exception, what the message names)
FAILS = {
    "mixmatch_text": ("mixmatch", "bert", {}, TypeError, "mixup_manifold"),
    "remixmatch_text": ("remixmatch", "bert", {}, TypeError,
                        "mixup_manifold"),
    "remixmatch_text_rot": ("remixmatch", "bert", dict(mixup_manifold=True),
                            KeyError, "rot_v"),
    "vat_text": ("vat", "bert", {}, AttributeError, "vat_embed"),
    "remixmatch_audio_rot": ("remixmatch", "hubert", {}, KeyError, "rot_v"),
}


@pytest.mark.parametrize("case", sorted(FAILS))
def test_the_port_fails_where_jax_fails(case):
    """The JAX loss (traced, as its step is) raises on the batch its loader
    gives (token dicts, or waveforms with the strong ``x_ulb_s_0_rot`` and
    no ``rot_v``); the port raises the same exception type, naming the
    switch or key, when the algorithm is built."""
    from semireward_tpu.algorithms.base import StepCtx as JCtx

    name, net, over, exc, word = FAILS[case]
    cfg = _config(name, net, over)
    jalg = JALGS.get(name)(jax_config(**cfg), DATA_INFO)
    jnet, _, sample = _pair(net)
    jm = jalg.wrap_model(jnet)
    params = jax.jit(lambda k: jm.init(k, sample, train=False))(
        jax.random.PRNGKey(0))["params"]
    views = CS._views(net, np.random.RandomState(1), jalg.BATCH_KEYS)
    batch = {**jax.tree_util.tree_map(jnp.asarray, views),
             "y_lb": jnp.zeros((B,), jnp.int32)}
    assert "rot_v" not in batch
    with pytest.raises(exc):
        jax.jit(lambda p, b: jalg.loss(JCtx(
            jm.apply, p, {}, b, jalg.init_state(), jax.random.PRNGKey(1),
            jnp.asarray(1, jnp.int32))).total_loss)(params, batch)
    with pytest.raises(exc, match=word):
        TALGS.get(name)(torch_config(**cfg), DATA_INFO)
    # the switch that makes JAX run it builds the port's
    fix = {"TypeError": dict(mixup_manifold=True, rot_loss_ratio=0.0),
           "KeyError": dict(rot_loss_ratio=0.0),
           "AttributeError": dict(vat_embed=True)}[exc.__name__]
    TALGS.get(name)(torch_config(**dict(cfg, **fix)), DATA_INFO)


@pytest.mark.parametrize("algo", ["mixmatch", "remixmatch", "vat"])
def test_text_and_audio_loaders_give_the_jax_views(algo, tmp_path):
    """The NLP loader draws every key of ``BATCH_KEYS`` in order, the
    strong text view of ``x_ulb_s_0_rot`` too, and the audio loader each
    strong view's crop: JAX's batches bit for bit
    (``test_torch_comatch_simmatch.py``'s check, on these keys)."""
    CS.test_text_and_audio_loaders_give_the_jax_views(algo, tmp_path)


@pytest.mark.parametrize("net", ["bert", "hubert"])
def test_rotnet_over_text_and_audio_nets_matches_jax(net):
    """RotNet over BERT and HuBERT (JAX builds it for ReMixMatch with its
    rotation head on any net): the converter maps the wrapped flax tree,
    and the full call (with ``use_rot``), ``only_feat`` and ``only_fc``
    give JAX's outputs within 1e-5."""
    from semireward_tpu.models.wrappers import RotNet as JRot
    from semireward_tpu_torch.models.wrappers import RotNet as TRot

    jnet, tnet, sample = _pair(net)
    jm, tm = JRot(backbone=jnet), TRot(tnet, torch.Generator().manual_seed(0))
    params = jax.jit(lambda k: jm.init(k, sample, train=False))(
        jax.random.PRNGKey(3))["params"]
    load_flax_params(tm, jax.device_get(params))
    x = CS._views(net, np.random.RandomState(2), ("x_lb",))["x_lb"]
    jx = jax.tree_util.tree_map(jnp.asarray, x)
    tx = {k: _t(v) for k, v in x.items()} if net == "bert" else _t(x)
    def jax_calls(p, x):
        feat = jm.apply({"params": p}, x, train=False, only_feat=True)
        return (jm.apply({"params": p}, x, train=False, use_rot=True), feat,
                jm.apply({"params": p}, 2 * feat, only_fc=True))

    want, feat, head = jax.jit(jax_calls)(params, jx)
    got = tm(tx, train=False, use_rot=True)
    for k in ("logits", "logits_rot", "feat"):
        assert_rel_close(got[k], np.asarray(want[k]), 1e-5, k)
    assert_rel_close(tm(tx, train=False, only_feat=True), np.asarray(feat),
                     1e-5, "only_feat")
    assert_rel_close(tm(2 * _t(np.asarray(feat)), only_fc=True),
                     np.asarray(head), 1e-5, "only_fc")
    assert tm.input_grad_is_zero == (net == "hubert")
