"""CoMatch and SimMatch in the port, held against the JAX package on the
same seeded numpy inputs, flax weights and the algorithm state carried
across (SimMatch's bank is drawn by each package's own RNG: JAX's is copied
into the port).

- ``dist_align_queue`` over five steps for the three ``p_target`` forms,
  with and without the labeled batch: pointers exact, the rings and the
  aligned probabilities within 1e-6 of their largest magnitude.
- ``comatch_contrastive_loss`` and the pseudo-label graph ``Q`` within
  1e-6; SimMatch's class aggregation with repeated labels in the bank
  (an index-add: every entry of a class counts) within 1e-6.
- Three-step trajectories on the 2-block ViT of ``test_torch_step.py``
  (MLP unfused, as in ``test_torch_usb_algorithms.py``), one epoch a step:
  CoMatch with ``queue_batch`` 1 (the queue wraps every step, memory
  smoothing from step 2) and 2 (the pointer walks 0, 8, 0), SimMatch
  (the instance loss from step 1) and its EMA-teacher branch (``stl10``,
  a dataset outside ``_EMA_BANK_DATASETS``). One case each on the small
  BERT of ``test_torch_nlp_step.py`` (CoMatch: two strong token views) and
  the small HuBERT of ``test_torch_audio_step.py`` (SimMatch), both run at
  ``train=False`` there. The JAX CoMatch loss cannot take token dicts
  (it reads a view's ``shape`` and concatenates with ``jnp.concatenate``):
  its views get a ``shape`` and its ``jnp.concatenate`` goes leaf by leaf,
  as the JAX package's ``ssl_forward`` does. SGD with momentum: Adam's
  first step divides each gradient by its own magnitude, which turns the
  rounding of a near-zero gradient into a step of up to ``lr``, and the
  normalized features and the bank carry that into the next steps (AdamW
  at lr 0.01: 2.3e-5 of SimMatch's instance loss at step 1, 1.2e-4 of the
  bank); the optimizers are held against optax in
  ``test_torch_optim.py``. Losses and the algorithm's metrics within 1e-5
  of their magnitude, ``util_ratio`` exact, the algorithm state within
  1e-5 (pointers and the labels bank exact), every parameter and the EMA
  within 1e-4 of their leaf's largest magnitude (``_check_leaf``).
- The text and audio loaders give JAX's batches for both algorithms' keys;
  the seeded STL-10-layout corpus reads the same in both packages and its
  SimMatch YAML builds a Trainer that takes the EMA-teacher branch.
- One loss of CoMatch and of both SimMatch branches at step 3 from the
  same weights, the queue or the bank filled: metrics and state within
  1e-6.
- The BatchNorm path once, on the small WRN of ``test_torch_wrn.py``:
  one SimMatch loss with the EMA teacher (its eval-mode forward reads the
  running statistics of before the step), the running statistics after it
  equal to the JAX loss's new ``batch_stats`` (1e-5), the losses and the
  bank within 1e-5.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_rel_close
from semireward_tpu.algorithms import comatch as jco
from semireward_tpu.algorithms import common as JC
from semireward_tpu.config import get_config as jax_config
from semireward_tpu.core.step import init_train_state as jax_init
from semireward_tpu.core.step import make_train_step as jax_make_step
from semireward_tpu.models import bert as jbert
from semireward_tpu.models import hubert as jhubert
from semireward_tpu.models import vit as jvit
from semireward_tpu.models import wrn as jwrn
from semireward_tpu.registry import ALGORITHMS as JALGS
from semireward_tpu_torch.algorithms import comatch as tco
from semireward_tpu_torch.algorithms import common as TC
from semireward_tpu_torch.algorithms import simmatch as tsim
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.convert import flax_to_torch, load_flax_params
from semireward_tpu_torch.core.step import init_train_state as torch_init
from semireward_tpu_torch.core.step import make_train_step as torch_make_step
from semireward_tpu_torch.models import bert as tbert
from semireward_tpu_torch.models import hubert as thubert
from semireward_tpu_torch.models import vit as tvit
from semireward_tpu_torch.models import wrn as twrn
from semireward_tpu_torch.registry import ALGORITHMS as TALGS
import test_torch_audio_step as AU
import test_torch_nlp_step as NL
from test_torch_step import ARCH as FUSED_ARCH
from test_torch_step import EMB, NC, S, B, _perturb
from test_torch_wrn import ARCH as WRN_ARCH
from test_torch_wrn import BN_MOM, _same_stats

ARCH = dict(FUSED_ARCH, use_fused_mlp=False)
# one epoch a step: smoothing and the instance loss start within three steps
BASE = dict(num_train_iter=10, epoch=10, uratio=1, batch_size=B,
            optim="SGD", lr=0.05, momentum=0.9, layer_decay=1.0,
            weight_decay=5e-4,
            ema_m=0.5, compute_dtype="float32", p_cutoff=0.3, proj_size=16,
            da_len=2)
LB_DEST = 8
DATA_INFO = {"ulb_dest_len": 16, "lb_dest_len": LB_DEST}
BU, NCU = 12, 5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _probs(seed, n=BU, c=NCU, scale=2.0):
    lg = np.random.RandomState(seed).randn(n, c) * scale
    e = np.exp(lg - lg.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------

def _same_queue(t, j, what):
    for k in ("p_model_ptr", "p_target_ptr"):
        assert int(getattr(t, k)) == int(getattr(j, k)), (what, k)
    for k in ("p_model", "p_target"):
        assert_rel_close(getattr(t, k), np.asarray(getattr(j, k)), 1e-6,
                         f"{what} {k}")


@pytest.mark.parametrize("form,labeled", [("uniform", False),
                                          ("uniform", True),
                                          ("model", True), ("model", False),
                                          ("gt", True)])
def test_dist_align_queue_steps(form, labeled):
    tgt = _probs(99, n=1)[0] if form == "gt" else None
    j = JC.dist_align_queue_init(NCU, 3, form, None if tgt is None
                                 else jnp.asarray(tgt))
    t = TC.dist_align_queue_init(NCU, 3, form, None if tgt is None
                                 else _t(tgt))
    _same_queue(t, j, "init")
    for step in range(5):  # the rings of 3 wrap
        pu, pl = _probs(step), _probs(50 + step)
        j, ja = JC.dist_align_queue(j, jnp.asarray(pu),
                                    jnp.asarray(pl) if labeled else None)
        t, ta = TC.dist_align_queue(t, _t(pu), _t(pl) if labeled else None)
        _same_queue(t, j, step)
        assert_rel_close(ta, np.asarray(ja), 1e-6, f"{step} aligned")
    assert int(t.p_model_ptr) == 5 % 3
    assert int(t.p_target_ptr) == (5 % 3 if form == "model" and labeled
                                   else 0 if form == "model" else -1)


def test_contrastive_loss_and_graph():
    rs = np.random.RandomState(3)
    f0, f1 = (rs.randn(BU, 16).astype(np.float32) for _ in range(2))
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    p = _probs(4, scale=3.0)
    jq = jnp.matmul(jnp.asarray(p), jnp.asarray(p).T)
    jq = jnp.fill_diagonal(jq, 1.0, inplace=False)
    jq = jq * (jq >= 0.3).astype(jnp.float32)
    jq = jq / jq.sum(axis=1, keepdims=True)
    tq = tco.pseudo_label_graph(_t(p), 0.3)
    assert_rel_close(tq, np.asarray(jq), 1e-6, "Q")
    assert 0 < int((tq == 0).sum()) < BU * BU  # the cutoff drops some
    for T in (0.2, 0.5):
        want = jco.comatch_contrastive_loss(jnp.asarray(f0), jnp.asarray(f1),
                                            jq, T)
        got = tco.comatch_contrastive_loss(_t(f0), _t(f1), tq, T)
        assert_rel_close(got, np.asarray(want), 1e-6, f"loss T={T}")


def test_class_similarity_accumulates_repeated_labels():
    rs = np.random.RandomState(5)
    K = 23
    labels = rs.randint(0, NCU, K)  # 23 entries over 5 classes
    tp = _probs(6, n=BU, c=K)
    want = jnp.zeros((BU, NCU)).at[:, jnp.asarray(labels)].add(
        jnp.asarray(tp))
    got = tsim.class_similarity(_t(tp), _t(labels).long(), NCU)
    assert_rel_close(got, np.asarray(want), 1e-6)
    # every row keeps its mass: each bank entry lands in one class
    assert_rel_close(got.sum(1), np.ones(BU), 1e-6)
    # a plain indexed write keeps one entry a class and loses the rest
    wrong = torch.zeros(BU, NCU)
    wrong[:, _t(labels).long()] += _t(tp)
    assert float((wrong - got).abs().max()) > 0.1


@pytest.mark.parametrize("algo", ["comatch", "simmatch"])
def test_text_and_audio_loaders_give_the_jax_views(algo, tmp_path):
    """The NLP loader (CoMatch's two strong token views through the
    ``x_ulb_s*`` branch) and the audio loader (each strong view's raw crop
    under ``<view>_base``, its sox effects drawn on the device, held against
    JAX's with the draws injected in ``test_torch_audio.py``) give the JAX
    package's batches, bit for bit, for the algorithm's keys."""
    from semireward_tpu.data import audio as jaudio
    from semireward_tpu.data import modality as jmod
    from semireward_tpu.data import nlp as jnlp
    from semireward_tpu_torch.data import audio as taudio
    from semireward_tpu_torch.data import modality as tmod
    from semireward_tpu_torch.data import nlp as tnlp
    from test_torch_audio import _clips
    from test_torch_nlp import assert_batches_equal, write_corpus

    keys = TALGS.get(algo).BATCH_KEYS
    assert keys == JALGS.get(algo).BATCH_KEYS
    kw = dict(algorithm=algo, dataset="aclImdb", data_dir=write_corpus(
        tmp_path), num_classes=2, num_labels=8, seed=0)
    tsp = tnlp.get_nlp_dataset(torch_config(**kw), algo)
    jsp = jnlp.get_nlp_dataset(jax_config(**kw), algo)
    tl = tmod.NLPSSLLoader(tsp, tnlp.NLPCollator(
        tnlp.HashTokenizer(), 512, tnlp.auto_buckets(512)), 4, 4, keys,
        seed=5)
    jl = jmod.NLPSSLLoader(jsp, jnlp.NLPCollator(
        jnlp.HashTokenizer(), 512, jnlp.auto_buckets(512)), 4, 4, keys,
        seed=5)
    for step in range(4):
        got, want = next(tl), next(jl)
        assert {k for k in got if k.startswith("x_")} == {
            k for k in keys if k.startswith("x_")}
        assert_batches_equal(got, want, f"text step {step}")
    waves = _clips(20)
    ys = np.arange(20) % 5
    split = {"train_lb": slice(0, 8), "train_ulb": slice(8, 20)}
    jl = jmod.AudioSSLLoader({k: jaudio.AudioDataset(waves[s], ys[s])
                              for k, s in split.items()},
                             jaudio.AudioCollator(0.1), 3, 3, keys, seed=5)
    tl = tmod.AudioSSLLoader({k: taudio.AudioDataset(waves[s], ys[s])
                              for k, s in split.items()},
                             taudio.AudioCollator(0.1), 3, 3, keys, seed=5)
    for step in range(4):
        want, got = next(jl), next(tl)
        assert sorted(got) == sorted(want)
        assert {k[:-5] for k in got if k.endswith("_base")} == {
            k for k in keys if k.startswith("x_ulb_s")}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"audio {step} {k}")


def test_synthetic_stl10_corpus_builds_the_ema_teacher_trainer(tmp_path):
    """The seeded STL-10-layout corpus reads the same through both
    packages' loaders, and the SimMatch STL-10 YAML (ViT-S/2-32 at 96 px)
    builds a CPU Trainer on it that takes the EMA-teacher branch."""
    from semireward_tpu.data import cv_extra as JX
    from semireward_tpu_torch import config as config_lib
    from semireward_tpu_torch.core.trainer import Trainer
    from semireward_tpu_torch.data import datasets as TD

    TD.write_synthetic_stl10(str(tmp_path), sizes=(
        ("train", 60), ("test", 16), ("unlabeled", 24)))
    got, want = TD.load_stl10(str(tmp_path)), JX.load_stl10(str(tmp_path))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert got[0][0].shape == (60, 96, 96, 3)
    assert sorted(set(got[0][1])) == list(range(10))
    cfg = config_lib.from_yaml(
        "config/usb_cv/simmatch/simmatch_stl10_40_0.yaml",
        {"data_dir": str(tmp_path), "use_pretrain": False, "resume": False,
         "save_dir": str(tmp_path / "out")})
    tr = Trainer(cfg, device="cpu")
    assert tr.alg.use_ema_teacher and tr.model.backbone.pos_embed.shape[1] == \
        (96 // 2) ** 2 + 1
    assert tr.state.algo.mem_bank.shape == (128, 40)


def test_comatch_refuses_a_queue_that_the_rows_written_do_not_divide():
    """A step that writes 7 rows into a queue of 8 raises (JAX's
    ``dynamic_update_slice`` would clamp the write and overwrite other
    rows)."""
    from semireward_tpu_torch.algorithms.base import StepCtx as TCtx

    cfg = torch_config(**dict(BASE, algorithm="comatch", num_classes=NC,
                              queue_batch=1))
    talg = TALGS.get("comatch")(cfg, DATA_INFO, torch.device("cpu"))
    assert talg.queue_size == 8

    def model(x, train=True, generator=None):
        return {"logits": x[:, :NC], "feat": x}

    rs = np.random.RandomState(2)
    batch = {k: _t(rs.randn(n, 16).astype(np.float32)) for k, n in (
        ("x_lb", 3), ("x_ulb_w", 4), ("x_ulb_s_0", 4), ("x_ulb_s_1", 4))}
    batch["y_lb"] = _t(np.arange(3))
    with pytest.raises(ValueError, match="not a multiple of the 7"):
        talg.loss(TCtx(model, batch, talg.init_state(), None, 0))


# ---------------------------------------------------------------------------
# three-step trajectories
# ---------------------------------------------------------------------------

def _carry(tnode, jnode):
    """Copy the JAX algorithm state's values into the port's (the same
    structure: dataclasses of tensors)."""
    for name in tnode.__dataclass_fields__:
        t, j = getattr(tnode, name), getattr(jnode, name)
        if isinstance(t, torch.Tensor):
            with torch.no_grad():
                t.copy_(_t(np.asarray(j)).to(t.dtype))
        else:
            _carry(t, j)


def _compare_state(step, tnode, jnode, path="algo"):
    for name in tnode.__dataclass_fields__:
        t, j, what = getattr(tnode, name), getattr(jnode, name), f"{step} " \
            f"{path}.{name}"
        if not isinstance(t, torch.Tensor):
            _compare_state(step, t, j, f"{path}.{name}")
        elif t.is_floating_point():
            assert_rel_close(t, np.asarray(j), 1e-5, what)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), what)


class _JitInit:
    def __init__(self, model):
        self.init = jax.jit(model.init, static_argnames="train")


class TorchEvalNet(NL.TorchEvalNet):
    @property
    def num_features(self):
        return self.net.num_features


def _check_leaf(name, got, want):
    """Within 1e-4 of the leaf's largest magnitude, or of 1e-4 where that
    is smaller: BERT's key biases start at 0 and have no true gradient (a
    constant key shift leaves the softmax unchanged), so both sides step
    them on rounding noise of about 1e-13."""
    scale = max(float(np.abs(want).max()), 1e-4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                               err_msg=name)


def _vit_pair():
    return (jvit.vit_small_patch2_32(num_classes=NC, dtype=jnp.float32,
                                     **ARCH),
            tvit.vit_small_patch2_32(num_classes=NC, dtype=torch.float32,
                                     **ARCH),
            jnp.zeros((2, S, S, 3)), 0.02)


def _bert_pair():
    jnet = NL.JaxEvalNet(jbert.ClassificationBert(
        num_classes=NC, vocab_size=NL.VOCAB, dtype=jnp.float32,
        use_flash=True, **NL.GEOM))
    with torch.device("meta"):
        tnet = tbert.ClassificationBert(NC, vocab_size=NL.VOCAB,
                                        dtype=torch.float32, use_flash=True,
                                        **NL.GEOM)
    sample = {"input_ids": jnp.zeros((2, NL.L), jnp.int32),
              "attention_mask": jnp.ones((2, NL.L), jnp.int32)}
    return jnet, TorchEvalNet(tnet.to_empty(device="cpu")), sample, 0.0


def _hubert_pair():
    jnet = AU.JaxEvalNet(jhubert.ClassificationAudioTransformer(
        num_classes=NC, dtype=jnp.float32, **AU.GEOM))
    tnet = TorchEvalNet(thubert.hubert_base(NC, dtype=torch.float32,
                                            **AU.GEOM))
    return jnet, tnet, jnp.zeros((2, AU.T)), 0.0


def _views(net, rs, keys):
    if net == "bert":
        def view():
            lens = rs.randint(3, NL.L + 1, B)
            mask = (np.arange(NL.L)[None, :] < lens[:, None]).astype(np.int32)
            return {"input_ids": rs.randint(100, NL.VOCAB, (B, NL.L)).astype(
                np.int32) * mask, "attention_mask": mask}
    elif net == "hubert":
        t = np.arange(AU.T) / 16000.0

        def view():
            f = rs.uniform(100, 3000, (B, 1))
            return (0.3 * np.sin(2 * np.pi * f * t)
                    + 0.05 * rs.randn(B, AU.T)).astype(np.float32)
    else:
        def view():
            return rs.randn(B, S, S, 3).astype(np.float32)
    return {k: view() for k in keys if k.startswith("x_")}


class Tokens(dict):
    """A token dict with the ``shape`` of its ids: the JAX CoMatch and
    SimMatch losses read ``x.shape[0]`` of a view and concatenate views
    with ``jnp.concatenate``, which a plain dict does not survive."""

    @property
    def shape(self):
        return self["input_ids"].shape


jax.tree_util.register_pytree_node(
    Tokens, lambda d: (list(d.values()), list(d)),
    lambda keys, vals: Tokens(zip(keys, vals)))


class _TreeConcat:
    """``jnp`` for the JAX losses, its ``concatenate`` taken leaf by leaf
    (the pytree concat of the JAX package's ``ssl_forward``)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def concatenate(xs, axis=0):
        return jax.tree_util.tree_map(lambda *a: jnp.concatenate(a, axis),
                                      *xs)


def _to(views, fn):
    return {k: (Tokens((kk, fn(vv)) for kk, vv in v.items())
                if isinstance(v, dict) else fn(v)) for k, v in views.items()}


PAIRS = {"vit": _vit_pair, "bert": _bert_pair, "hubert": _hubert_pair}
NETS = {"vit": "vit_small_patch2_32", "bert": "bert_base_uncased",
        "hubert": "hubert_base"}


def run_steps(name, net, over, steps=3):
    """``steps`` steps of ``name`` in both packages from the same weights
    and algorithm state on the same views; compared after each step as the
    module docstring says. Returns the port's state and metrics."""
    cfg = dict(BASE, algorithm=name, net=NETS[net], num_classes=NC, img_size=S,
               **over)
    if net != "vit":
        cfg["feature_dim"] = NL.GEOM["hidden"] if net == "bert" else \
            AU.GEOM["hidden"]
    jcfg, tcfg = jax_config(**cfg), torch_config(**cfg)
    jalg = JALGS.get(name)(jcfg, DATA_INFO)
    talg = TALGS.get(name)(tcfg, DATA_INFO, torch.device("cpu"))
    jnet, tnet, sample, perturb = PAIRS[net]()
    jmodel = jalg.wrap_model(jnet)
    tmodel = talg.wrap_model(tnet, torch.Generator().manual_seed(0))
    txs = []

    def init(rng):
        state, tx = jax_init(jcfg, jalg, jmodel, rng, sample)
        txs.append(tx)
        return state

    jstate = jax.jit(init)(jax.random.PRNGKey(0))
    if perturb:
        params = _perturb(jstate.params, perturb)
        jstate = jstate.replace(params=params, ema_params=params)
    jstep = jax.jit(jax_make_step(jcfg, jalg, jmodel, txs[0]))
    load_flax_params(tmodel, jax.device_get(jstate.params))
    tstate = torch_init(tcfg, talg, tmodel)
    _carry(tstate.algo, jstate.algo)
    tstep = torch_make_step(tcfg, talg)

    rs = np.random.RandomState(0)
    names = [n for n, _ in tmodel.named_parameters()]
    for step in range(steps):
        views = _views(net, rs, talg.BATCH_KEYS)
        y = rs.randint(0, NC, B)
        idx = rs.choice(LB_DEST, B, replace=False)
        jbatch = {**_to(views, jnp.asarray), "y_lb": jnp.asarray(y),
                  "idx_lb": jnp.asarray(idx, jnp.int32)}
        tbatch = {**_to(views, _t), "y_lb": _t(y), "idx_lb": _t(idx)}
        jstate, jm = jstep(jstate, jbatch)
        tm = tstep(tstate, tbatch)
        assert sorted(tm) == sorted(jm), (sorted(tm), sorted(jm))
        for k, v in jm.items():
            if k == "util_ratio":
                assert float(tm[k]) == float(v), (step, k)
            else:
                assert_rel_close(tm[k], np.asarray(v), 1e-5, f"{step} {k}")
        _compare_state(step, tstate.algo, jstate.algo)
        want, want_ema = (flax_to_torch(jax.device_get(t)) for t in
                          (jstate.params, jstate.ema_params))
        for n, p, e in zip(names, tmodel.parameters(), tstate.ema):
            _check_leaf(n, p.detach().numpy(), want[n])
            _check_leaf(n, e.numpy(), want_ema[n])
    assert tstate.step == steps and int(jstate.step) == steps
    assert all(math.isfinite(float(v)) for v in tm.values())
    return tstate, tm


CASES = {
    "comatch_smoothing": ("comatch", "vit", dict(queue_batch=1)),
    "comatch_queue": ("comatch", "vit", dict(queue_batch=2)),
    "simmatch": ("simmatch", "vit", {}),
    "simmatch_ema_teacher": ("simmatch", "vit", dict(dataset="stl10")),
    "comatch_bert": ("comatch", "bert", dict(queue_batch=1)),
    "simmatch_hubert": ("simmatch", "hubert", {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_jax(case, monkeypatch):
    name, net, over = CASES[case]
    if net == "bert":
        monkeypatch.setattr(jco, "jnp", _TreeConcat())
    teacher = []
    if name == "simmatch":
        from semireward_tpu_torch.algorithms import pimodel
        ema_forward = pimodel.ema_forward
        monkeypatch.setattr(pimodel, "ema_forward", lambda *a, **kw: (
            teacher.append(kw) or ema_forward(*a, **kw)))
    tstate, tm = run_steps(name, net, over)
    st = tstate.algo
    if name == "comatch":
        size = over["queue_batch"] * 2 * B
        assert int(st.queue_ptr) == (3 * 2 * B) % size
        assert bool((st.queue_feats.abs().sum(1) > 0).all())  # all written
        assert float(tm["contrast_loss"]) > 0
    else:
        assert float(tm["in_loss"]) > 0
        assert teacher == ([{"train": False}] * 3
                           if case == "simmatch_ema_teacher" else [])
    assert int(st.dist_align.p_model_ptr) == 3 % BASE["da_len"]


@pytest.mark.parametrize("name,over", [("comatch", dict(queue_batch=1)),
                                       ("simmatch", {}),
                                       ("simmatch", dict(dataset="stl10"))])
def test_one_loss_on_the_same_weights(name, over):
    """One loss of each package at step 3 (smoothing and the instance loss
    on) from the same weights and a filled queue or bank: every metric and
    the new state within 1e-6."""
    from semireward_tpu.algorithms.base import StepCtx as JCtx
    from semireward_tpu_torch.algorithms.base import StepCtx as TCtx

    cfg = dict(BASE, algorithm=name, net="vit_small_patch2_32",
               num_classes=NC, img_size=S, **over)
    jalg = JALGS.get(name)(jax_config(**cfg), DATA_INFO)
    talg = TALGS.get(name)(torch_config(**cfg), DATA_INFO,
                           torch.device("cpu"))
    jnet, tnet, sample, _ = _vit_pair()
    jm = jalg.wrap_model(jnet)
    tm = talg.wrap_model(tnet, torch.Generator().manual_seed(0))
    v = jax.jit(lambda k: jm.init(k, sample, train=False))(
        jax.random.PRNGKey(0))
    params, ema = _perturb(v["params"], 0.02), _perturb(v["params"], 0.03)
    load_flax_params(tm, jax.device_get(params))
    flat_ema = flax_to_torch(jax.device_get(ema))
    tema = [_t(flat_ema[n]) for n, _ in tm.named_parameters()]
    rs = np.random.RandomState(7)
    jst = jalg.init_state()
    if name == "comatch":
        f = rs.randn(*jst.queue_feats.shape).astype(np.float32)
        jst = jst.replace(
            queue_feats=jnp.asarray(f / np.linalg.norm(f, axis=1,
                                                       keepdims=True)),
            queue_probs=jnp.asarray(_probs(8, *jst.queue_probs.shape)))
    else:
        jst = jst.replace(labels_bank=jnp.asarray(rs.randint(0, NC, LB_DEST),
                                                  jnp.int32))
    tst = talg.init_state()
    _carry(tst, jst)
    views = _views("vit", rs, talg.BATCH_KEYS)
    y = rs.randint(0, NC, B)
    idx = rs.choice(LB_DEST, B, replace=False)
    jb = {**_to(views, jnp.asarray), "y_lb": jnp.asarray(y),
          "idx_lb": jnp.asarray(idx, jnp.int32)}
    tb = {**_to(views, _t), "y_lb": _t(y), "idx_lb": _t(idx)}
    jout = jax.jit(lambda p, e, b: jalg.loss(JCtx(
        jm.apply, p, {}, b, jst, jax.random.PRNGKey(5),
        jnp.asarray(3, jnp.int32), ema_params=e)))(params, ema, jb)
    tout = talg.loss(TCtx(tm, tb, tst, None, 3, ema=tema))
    assert sorted(tout.metrics) == sorted(jout.metrics)
    for k, want in jout.metrics.items():
        assert_rel_close(tout.metrics[k], np.asarray(want), 1e-6, k)
    _compare_state(3, tout.new_algo_state, jout.new_algo_state)
    extra = "contrast_loss" if name == "comatch" else "in_loss"
    assert float(tout.metrics[extra]) > 0


def test_simmatch_batchnorm_on_the_wrn_with_the_ema_teacher():
    """One loss of each package on the WRN at step 4 (past the first
    epoch), the JAX loss jitted alone with the EMA weights a perturbation
    of the live ones: losses and the new bank within 1e-5, the running
    statistics after it equal to JAX's new ``batch_stats``."""
    from semireward_tpu.algorithms.base import StepCtx as JCtx
    from semireward_tpu_torch.algorithms.base import StepCtx as TCtx

    cfg = dict(BASE, algorithm="simmatch", net="wrn_28_2", num_classes=NC,
               img_size=S, dataset="stl10")
    jalg = JALGS.get("simmatch")(jax_config(**cfg), DATA_INFO)
    talg = TALGS.get("simmatch")(torch_config(**cfg), DATA_INFO,
                                 torch.device("cpu"))
    assert jalg.use_ema_teacher and talg.use_ema_teacher
    jm = jalg.wrap_model(jwrn.wrn_28_2(NC, dtype=jnp.float32,
                                       bn_momentum=BN_MOM, **WRN_ARCH))
    tm = talg.wrap_model(twrn.wrn_28_2(NC, dtype=torch.float32,
                                       bn_momentum=BN_MOM, **WRN_ARCH),
                         torch.Generator().manual_seed(0))
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((2, S, S, 3)), train=False))(
        jax.random.PRNGKey(0))
    params, ema = _perturb(v["params"], 0.05), _perturb(v["params"], 0.08)
    # running statistics away from their init, so that eval mode reads them
    stats = jax.tree_util.tree_map(lambda s: s + 0.3, v["batch_stats"])
    load_flax_params(tm, jax.device_get(params), jax.device_get(stats))
    names = [n for n, _ in tm.named_parameters()]
    flat_ema = flax_to_torch(jax.device_get(ema))
    tema = [_t(flat_ema[n]) for n in names]
    jst = jalg.init_state()
    tst = talg.init_state()
    _carry(tst, jst)
    rs = np.random.RandomState(13)
    views = _views("vit", rs, talg.BATCH_KEYS)
    y = rs.randint(0, NC, B)
    idx = rs.choice(LB_DEST, B, replace=False)
    jbatch = {**_to(views, jnp.asarray), "y_lb": jnp.asarray(y),
              "idx_lb": jnp.asarray(idx, jnp.int32)}
    tbatch = {**_to(views, _t), "y_lb": _t(y), "idx_lb": _t(idx)}

    @jax.jit
    def jloss(params, stats, ema, batch):
        out = jalg.loss(JCtx(jm.apply, params, stats, batch, jst,
                             jax.random.PRNGKey(5), jnp.asarray(4, jnp.int32),
                             ema_params=ema))
        return out.metrics, out.new_batch_stats, out.new_algo_state

    jmetrics, new_stats, jnew = jloss(params, stats, ema, jbatch)
    out = talg.loss(TCtx(tm, tbatch, tst, None, 4, ema=tema))
    _same_stats(tm, new_stats, "simmatch")
    for k in jmetrics:
        assert_rel_close(out.metrics[k], np.asarray(jmetrics[k]), 1e-5, k)
    assert float(out.metrics["in_loss"]) > 0
    _compare_state(4, out.new_algo_state, jnew)


def test_repeated_indices_keep_the_last_write_as_jax():
    """64 rows drawn from 40 (the ``classic_cv`` SimMatch CIFAR-10-40
    YAML's batch): the bank writes (``common.write_last``) and FlexMatch's
    ``selected_label`` keep the last row of a repeated index, bit-equal to
    the JAX package's ``.at[].set``; ``class_similarity`` (a product with
    the one-hot labels) within 1e-6 of JAX's ``.at[].add``; one SimMatch
    loss on the WRN with those rows gives JAX's labels bank exactly and its
    memory bank within 1e-5."""
    from semireward_tpu.algorithms.base import StepCtx as JCtx
    from semireward_tpu_torch.algorithms.base import StepCtx as TCtx

    K, n = 40, 64
    rs = np.random.RandomState(21)
    idx = rs.randint(0, K, n)
    assert len(np.unique(idx)) < n
    bank = rs.randn(16, K).astype(np.float32)
    cols = rs.randn(16, n).astype(np.float32)
    labels = rs.randint(0, NC, K)
    y = rs.randint(0, NC, n)
    want = jnp.asarray(bank).at[:, jnp.asarray(idx)].set(jnp.asarray(cols))
    got = TC.write_last(_t(bank), 1, _t(idx), _t(cols))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jnp.asarray(labels).at[jnp.asarray(idx)].set(jnp.asarray(y))
    got = TC.write_last(_t(labels).long(), 0, _t(idx), _t(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the last row of each index, read off the batch
    last = {int(i): j for j, i in enumerate(idx)}
    assert all(int(got[i]) == y[j] for i, j in last.items())

    tp = _probs(22, n=BU, c=K)
    want = jnp.zeros((BU, NC)).at[:, jnp.asarray(labels)].add(jnp.asarray(tp))
    got = tsim.class_similarity(_t(tp), _t(labels).long(), NC)
    assert_rel_close(got, np.asarray(want), 1e-6, "class_similarity")

    probs = _probs(23, n=n, c=NC, scale=4.0)
    sel0 = rs.randint(-1, NC, K)
    acc0 = rs.rand(NC).astype(np.float32) * 0.5
    jst, jmask = JC.flex_mask(
        JC.FlexState(jnp.asarray(sel0, jnp.int32), jnp.asarray(acc0)),
        jnp.asarray(probs), jnp.asarray(idx, jnp.int32), 0.7, True)
    tst, tmask = TC.flex_mask(TC.FlexState(_t(sel0).long(), _t(acc0)),
                              _t(probs), _t(idx), 0.7, True)
    np.testing.assert_array_equal(tst.selected_label.numpy(),
                                  np.asarray(jst.selected_label))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tst.classwise_acc.numpy(),
                                  np.asarray(jst.classwise_acc))
    repeated = [i for i in np.unique(idx) if (idx == i).sum() > 1
                and (probs[idx == i].max(-1) >= 0.7).sum() > 1]
    assert repeated, "no index selected twice"

    # one SimMatch loss at 64 labeled rows drawn from a bank of 40
    info = {"ulb_dest_len": 16, "lb_dest_len": K}
    cfg = dict(BASE, algorithm="simmatch", net="wrn_28_2", num_classes=NC,
               img_size=S, batch_size=n)
    jalg = JALGS.get("simmatch")(jax_config(**cfg), info)
    talg = TALGS.get("simmatch")(torch_config(**cfg), info,
                                 torch.device("cpu"))
    jm = jalg.wrap_model(jwrn.wrn_28_2(NC, dtype=jnp.float32,
                                       bn_momentum=BN_MOM, **WRN_ARCH))
    tm = talg.wrap_model(twrn.wrn_28_2(NC, dtype=torch.float32,
                                       bn_momentum=BN_MOM, **WRN_ARCH),
                         torch.Generator().manual_seed(0))
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((2, S, S, 3)), train=False))(
        jax.random.PRNGKey(0))
    params = _perturb(v["params"], 0.05)
    load_flax_params(tm, jax.device_get(params),
                     jax.device_get(v["batch_stats"]))
    jst, tst = jalg.init_state(), talg.init_state()
    _carry(tst, jst)
    views = {k: rs.randn(n if k == "x_lb" else B, S, S, 3).astype(np.float32)
             for k in ("x_lb", "x_ulb_w", "x_ulb_s")}
    jb = {**_to(views, jnp.asarray), "y_lb": jnp.asarray(y),
          "idx_lb": jnp.asarray(idx, jnp.int32)}
    tb = {**_to(views, _t), "y_lb": _t(y), "idx_lb": _t(idx)}
    jout = jax.jit(lambda p, b: jalg.loss(JCtx(
        jm.apply, p, v["batch_stats"], b, jst, jax.random.PRNGKey(5),
        jnp.asarray(3, jnp.int32), ema_params=p)))(params, jb)
    tout = talg.loss(TCtx(tm, tb, tst, None, 3, ema=[
        p.detach().clone() for p in tm.parameters()]))
    np.testing.assert_array_equal(
        tout.new_algo_state.labels_bank.numpy(),
        np.asarray(jout.new_algo_state.labels_bank))
    assert_rel_close(tout.new_algo_state.mem_bank,
                     np.asarray(jout.new_algo_state.mem_bank), 1e-5,
                     "mem_bank")
