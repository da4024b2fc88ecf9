"""classic_cv in the port, held against the JAX package: the WideResNet with
its flax-semantics BatchNorm, the converter's ``batch_stats``, three-step
``srfixmatch`` / ``srpseudolabel`` trajectories with the running statistics
compared after each step, and the SVHN / STL-10 / EuroSAT / TissueMNIST
loaders on small files written here.

A narrow WRN (depth 10: one block per stage, widen 1, 16 px), float32.
Tolerances: logits and features 1e-5 of their largest magnitude (float32
convs summed in another order); running statistics 1e-5 (the port takes
the biased variance in two passes, flax as E[x^2] - E[x]^2). Trajectories:
losses 1e-5, masks and reward-filter ratios exact, parameters as in
``test_torch_step.py`` (1e-4 of each leaf's largest magnitude, at most
0.1% of the elements up to the step bound). Loaders: bit-equal arrays.
"""
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_rel_close
from semireward_tpu.config import get_config as jax_config
from semireward_tpu.core.step import init_train_state as jax_init
from semireward_tpu.core.step import make_train_step as jax_make_step
from semireward_tpu.data import cv_extra as JX
from semireward_tpu.data import datasets as JD
from semireward_tpu.models import wrn as jwrn
from semireward_tpu.registry import ALGORITHMS as JALGS
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.convert import flax_to_torch, load_flax_params
from semireward_tpu_torch.core.step import init_train_state as torch_init
from semireward_tpu_torch.core.step import make_train_step as torch_make_step
from semireward_tpu_torch.data import datasets as TD
from semireward_tpu_torch.models import wrn as twrn
from semireward_tpu_torch.models.batchnorm import BatchNorm, frozen_bn
from semireward_tpu_torch.registry import ALGORITHMS as TALGS
from test_torch_step import _check_leaf

NC, S, B = 5, 16, 4
ARCH = dict(depth=10, widen_factor=1)
BN_MOM = 0.5  # flax momentum; large steps make the statistics comparable


def _jax_net(**kw):
    return jwrn.wrn_28_2(NC, dtype=jnp.float32, bn_momentum=BN_MOM,
                         **ARCH, **kw)


def _perturb(params):
    # BN scales 1 and biases 0 at init: perturb so that every one matters
    return jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(
            np.random.RandomState(p.size % 997).randn(*p.shape), p.dtype),
        params)


@functools.lru_cache(maxsize=1)
def _jax_variables():
    jm = _jax_net()
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((2, S, S, 3)), train=False))(
        jax.random.PRNGKey(0))
    return {"params": _perturb(v["params"]), "batch_stats": v["batch_stats"]}


def _pair():
    jm, v = _jax_net(), _jax_variables()
    tm = twrn.wrn_28_2(NC, dtype=torch.float32, bn_momentum=BN_MOM, **ARCH)
    load_flax_params(tm, jax.device_get(v["params"]),
                     jax.device_get(v["batch_stats"]))
    return jm, v, tm


def _stats(tree):
    return flax_to_torch(jax.tree_util.tree_map(np.asarray, tree), stats=True)


def _same_stats(tm, batch_stats, what=""):
    want = _stats(batch_stats)
    got = {n: b for n, b in tm.named_buffers()}
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for n, w in want.items():
        assert_rel_close(got[n], w, 1e-5, f"{what} {n}")


def _images(seed, n=6):
    return np.random.RandomState(seed).randn(n, S, S, 3).astype(np.float32)


def test_names_match_the_flax_tree():
    jm, v, tm = _pair()
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, v["params"]))
    assert sorted(want) == sorted(n for n, _ in tm.named_parameters())
    assert sorted(_stats(v["batch_stats"])) == sorted(
        n for n, _ in tm.named_buffers())
    assert tm.num_features == jm.num_features == 64
    # layer-decay groups: conv1 0, block i i, bn1 / classifier last
    ids = {n: twrn.layer_id(n.split("."), 4) for n, _ in tm.named_parameters()}
    assert ids["conv1.weight"] == 0 and ids["block3.layer.0.conv2.weight"] == 3
    assert ids["bn1.weight"] == ids["classifier.bias"] == 4


@pytest.mark.parametrize("train", [True, False])
def test_forward_and_running_stats_match(train):
    jm, v, tm = _pair()
    x = _images(1)
    if train:
        out, st = jm.apply(v, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
        got = tm(torch.from_numpy(x), train=True)
        _same_stats(tm, st["batch_stats"], "after one train forward")
    else:
        out = jm.apply(v, jnp.asarray(x), train=False)
        before = {n: b.clone() for n, b in tm.named_buffers()}
        got = tm(torch.from_numpy(x), train=False)
        assert all(torch.equal(before[n], b) for n, b in tm.named_buffers())
    for k in ("logits", "feat"):
        assert_rel_close(got[k].detach(), np.asarray(out[k]), 1e-5, k)


def test_dead_bn1_block_updates_its_stats_only():
    """block2's first layer widens 16 -> 32 without activating before the
    residual: conv1 reads the raw input, so bn1's scale and bias change no
    output, yet its running statistics move, in both packages."""
    jm, v, tm = _pair()
    x = _images(2)
    dead = tm.block2.layer[0].bn1
    assert isinstance(dead, BatchNorm)
    out0 = tm(torch.from_numpy(x), train=True)["logits"].detach()
    with torch.no_grad():
        dead.weight.mul_(3.0).add_(1.0)
        dead.bias.add_(5.0)
    out1 = tm(torch.from_numpy(x), train=True)["logits"].detach()
    assert torch.equal(out0, out1)
    live = tm.block2.layer[0].bn2
    with torch.no_grad():
        live.bias.add_(1.0)
    assert not torch.equal(out1, tm(torch.from_numpy(x), train=True)["logits"])
    _, st = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    jdead = st["batch_stats"]["block2"]["layer0"]["bn1"]
    assert not np.allclose(np.asarray(jdead["mean"]), 0.0)
    tm2 = _pair()[2]
    tm2(torch.from_numpy(x), train=True)
    assert_rel_close(tm2.block2.layer[0].bn1.running_mean,
                     np.asarray(jdead["mean"]), 1e-5)


def test_frozen_bn_normalizes_by_the_batch_and_keeps_the_stats():
    jm, v, tm = _pair()
    x = _images(3)
    before = {n: b.clone() for n, b in tm.named_buffers()}
    with frozen_bn(tm):
        got = tm(torch.from_numpy(x), train=True)
    assert all(torch.equal(before[n], b) for n, b in tm.named_buffers())
    assert not any(m.frozen for m in tm.modules() if isinstance(m, BatchNorm))
    out, _ = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    assert_rel_close(got["logits"].detach(), np.asarray(out["logits"]), 1e-5)


def test_bn_is_not_torch_batchnorm():
    """The two differences from torch.nn.BatchNorm2d: the running variance
    moves toward the biased batch variance, and momentum is flax's."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, 5, 5, generator=g)
    bn = BatchNorm(4, momentum=0.9)
    ref = torch.nn.BatchNorm2d(4, momentum=0.1)
    bn(x, train=True)
    ref.train()(x)
    var = x.var((0, 2, 3), correction=0)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(bn.running_mean, ref.running_mean)
    assert not torch.allclose(bn.running_var, ref.running_var)


# ---------------------------------------------------------------------------
# three classic_cv SR steps against the JAX package
# ---------------------------------------------------------------------------

CFG = dict(net="wrn_28_2", num_classes=NC, batch_size=B, uratio=1,
           num_train_iter=10, optim="SGD", lr=0.03, momentum=0.9,
           weight_decay=5e-4, layer_decay=1.0, ema_m=0.5, img_size=S,
           compute_dtype="float32", start_timing=1, N_k=1, feature_dim=64,
           sr_ema=False, sr_lr=0.01, p_cutoff=0.5)
DATA_INFO = {"ulb_dest_len": 16, "lb_dest_len": 8}


@pytest.mark.parametrize("name", ["srfixmatch", "srpseudolabel"])
def test_three_classic_cv_steps_match_jax(name):
    kw = dict(CFG, algorithm=name)
    jcfg, tcfg = jax_config(**kw), torch_config(**kw)
    jalg = JALGS.get(name)(jcfg, DATA_INFO)
    jmodel = _jax_net()
    jstate, tx = jax_init(jcfg, jalg, jmodel, jax.random.PRNGKey(0),
                          jnp.zeros((2, S, S, 3)), builder=jwrn.wrn_28_2)
    params = _perturb(jstate.params)
    jstate = jstate.replace(params=params, ema_params=params)
    jstep = jax.jit(jax_make_step(jcfg, jalg, jmodel, tx))

    talg = TALGS.get(name)(tcfg, DATA_INFO, torch.device("cpu"))
    tmodel = twrn.wrn_28_2(NC, dtype=torch.float32, bn_momentum=BN_MOM,
                           **ARCH)
    load_flax_params(tmodel, jax.device_get(params),
                     jax.device_get(jstate.batch_stats))
    tstate = torch_init(tcfg, talg, tmodel, builder=twrn.wrn_28_2)
    load_flax_params(tstate.sr.rewarder,
                     jax.device_get(jstate.sr.rewarder_params))
    load_flax_params(tstate.sr.generator, jax.device_get(jstate.sr.gen_params))
    tstep = torch_make_step(tcfg, talg)

    rs = np.random.RandomState(0)
    names = [n for n, _ in tmodel.named_parameters()]
    for step in range(3):
        views = {k: rs.randn(B, S, S, 3).astype(np.float32)
                 for k in ("x_lb", "x_ulb_w", "x_ulb_s")}
        if name == "srpseudolabel":
            del views["x_ulb_s"]
        y = rs.randint(0, NC, B)
        idx = rs.choice(DATA_INFO["ulb_dest_len"], B, replace=False)
        jbatch = {**{k: jnp.asarray(v) for k, v in views.items()},
                  "y_lb": jnp.asarray(y),
                  "idx_ulb": jnp.asarray(idx, jnp.int32)}
        tbatch = {**{k: torch.from_numpy(v) for k, v in views.items()},
                  "y_lb": torch.from_numpy(y), "idx_ulb": torch.from_numpy(idx)}
        stats_before = _stats(jstate.batch_stats)
        jstate, jm = jstep(jstate, jbatch)
        tm = tstep(tstate, tbatch)

        for k in ("total_loss", "sup_loss", "unsup_loss"):
            assert_rel_close(tm[k], np.asarray(jm[k]), 1e-5, f"{step} {k}")
        for k in ("util_ratio", "sr_keep_ratio"):
            assert float(tm[k]) == float(jm[k]), (step, k)
        _same_stats(tmodel, jstate.batch_stats, f"step {step}")
        # the statistics moved: over every row (srfixmatch's one pass) or
        # over the labeled rows alone (srpseudolabel's ulb pass is frozen)
        moved = _stats(jstate.batch_stats)
        assert any(not np.array_equal(moved[n], stats_before[n])
                   for n in moved)

        bound = 2 * CFG["lr"] * (step + 1) + 1e-6
        want, want_ema = (flax_to_torch(jax.device_get(t)) for t in
                          (jstate.params, jstate.ema_params))
        for n, p, e in zip(names, tmodel.parameters(), tstate.ema):
            _check_leaf(n, p.detach().numpy(), want[n], bound)
            _check_leaf(n, e.numpy(), want_ema[n], bound)
        if step == 2:
            assert float(jm["sr_keep_ratio"]) < 1.0
    assert tstate.step == 3 and int(jstate.step) == 3
    assert not math.isnan(float(tm["total_loss"]))


def test_pseudolabel_ulb_pass_leaves_the_stats():
    """srpseudolabel's step: the labeled forward alone moves the running
    statistics; reading them around the frozen unlabeled forward shows no
    change."""
    cfg = torch_config(**dict(CFG, algorithm="srpseudolabel"))
    alg = TALGS.get("srpseudolabel")(cfg, DATA_INFO, torch.device("cpu"))
    model = _pair()[2]
    seen = []
    orig = model.forward

    def spy(x, train=True, **kw):
        before = model.bn1.running_mean.clone()
        out = orig(x, train=train, **kw)
        seen.append(not torch.equal(before, model.bn1.running_mean))
        return out

    model.forward = spy
    state = torch_init(cfg, alg, model, builder=twrn.wrn_28_2)
    rs = np.random.RandomState(5)
    batch = {k: torch.from_numpy(rs.randn(B, S, S, 3).astype(np.float32))
             for k in ("x_lb", "x_ulb_w")}
    batch["y_lb"] = torch.from_numpy(rs.randint(0, NC, B))
    batch["idx_ulb"] = torch.arange(B)
    torch_make_step(cfg, alg)(state, batch)
    assert seen == [True, False]  # lb pass moved them, ulb pass did not


# ---------------------------------------------------------------------------
# loaders on small files of the real layouts
# ---------------------------------------------------------------------------

def _write_svhn(root, n=(23, 11)):
    from scipy.io import savemat

    rs = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "svhn"))
    for split, k in zip(("train", "test"), n):
        savemat(os.path.join(root, "svhn", f"{split}_32x32.mat"),
                {"X": rs.randint(0, 256, (32, 32, 3, k), dtype=np.uint8),
                 "y": rs.randint(1, 11, (k, 1)).astype(np.uint8)})


def _write_stl10(root, n=(30, 12, 17)):
    rs = np.random.RandomState(1)
    base = os.path.join(root, "stl10_binary")
    os.makedirs(base)
    for name, k in zip(("train", "test", "unlabeled"), n):
        rs.randint(0, 256, k * 3 * 96 * 96, dtype=np.uint8).tofile(
            os.path.join(base, f"{name}_X.bin"))
        if name != "unlabeled":
            np.tile(np.arange(1, 11, dtype=np.uint8), k // 10 + 1)[:k].tofile(
                os.path.join(base, f"{name}_y.bin"))


def test_svhn_and_stl10_loaders_are_bit_equal(tmp_path):
    root = str(tmp_path)
    _write_svhn(root)
    _write_stl10(root)
    for got, want in ((TD.load_svhn(root), JX.load_svhn(root)),
                      (TD.load_stl10(root), JX.load_stl10(root))):
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    y = TD.load_svhn(root)[0][1]
    assert y.min() >= 0 and y.max() <= 9  # label 10 is digit 0
    assert TD.load_stl10(root)[2].shape == (17, 96, 96, 3)


def _write_npz(root):
    rs = np.random.RandomState(2)
    os.makedirs(os.path.join(root, "eurosat"))
    np.savez(os.path.join(root, "eurosat", "eurosat.npz"),
             train_x=rs.randint(0, 256, (40, 8, 8, 3), dtype=np.uint8),
             train_y=np.arange(40) % 10,
             test_x=rs.randint(0, 256, (7, 8, 8, 3), dtype=np.uint8),
             test_y=np.arange(7) % 10)
    imgs = {f"{s}_images": rs.randint(0, 256, (k, 8, 8), dtype=np.uint8)
            for s, k in (("train", 48), ("val", 9), ("test", 5))}
    labels = {f"{s}_labels": (np.arange(k) % 8).reshape(-1, 1)
              for s, k in (("train", 48), ("val", 9), ("test", 5))}
    np.savez(os.path.join(root, "tissuemnist.npz"), **imgs, **labels)


@pytest.mark.parametrize("name,num_labels,num_classes",
                         [("svhn", 20, 10), ("stl10", 10, 10),
                          ("eurosat", 20, 10), ("tissuemnist", 16, 8)])
def test_get_dataset_matches_jax(tmp_path, name, num_labels, num_classes):
    root = str(tmp_path)
    {"svhn": _write_svhn, "stl10": _write_stl10}.get(name, _write_npz)(root)
    kw = dict(dataset=name, data_dir=root, num_labels=num_labels,
              num_classes=num_classes, seed=3)
    jb, tb = JD.get_dataset(jax_config(**kw)), TD.get_dataset(
        torch_config(**kw))
    assert (tb.num_classes, tb.ulb_dest_len, tb.lb_dest_len) == (
        jb.num_classes, jb.ulb_dest_len, jb.lb_dest_len)
    np.testing.assert_allclose(tb.mean, jb.mean, rtol=0, atol=0)
    np.testing.assert_allclose(tb.std, jb.std, rtol=0, atol=0)
    for split in ("train_lb", "train_ulb", "eval"):
        for k in ("data", "targets"):
            np.testing.assert_array_equal(getattr(getattr(tb, split), k),
                                          getattr(getattr(jb, split), k))


def test_imagenet_is_refused_by_name(tmp_path):
    """No longer refused: ``imagenet`` and ``imagenet127`` reach the
    JPEG-folder loader (tests/test_torch_jpeg.py), which reads the local
    ImageNet layout; a name the port does not read yet (``pathmnist``, a
    MedMNIST member of the JAX package's) still raises naming the ported
    ones, the regression sets among them (tests/test_torch_regression.py
    reads them)."""
    for name in ("imagenet", "imagenet127"):
        with pytest.raises(FileNotFoundError, match="imagenet.train"):
            TD.get_dataset(torch_config(dataset=name,
                                        data_dir=str(tmp_path)),
                           device="cpu")
    with pytest.raises(KeyError, match="imagenet127, food101, semi_aves, "
                                       "agedb, imdb_wiki, rcf_mnist"):
        TD.get_dataset(torch_config(dataset="pathmnist"))


def test_trainer_runs_classic_cv_on_cpu(tmp_path):
    """The classic_cv YAML through the port's Trainer, two steps on
    synthetic data with a narrow WRN: the rewarder takes the net's feature
    width (the YAML says 384), the EMA shadows the parameters only, and
    eval runs the EMA parameters with the live running statistics."""
    from torch.func import functional_call

    from semireward_tpu_torch import config as config_lib
    from semireward_tpu_torch.core.trainer import Trainer
    from semireward_tpu_torch.data.augment import normalize

    cfg = config_lib.from_yaml(
        "config/SemiReward/classic_cv/pseudolabel/"
        "pseudolabel_cifar100_10000_0.yaml",
        dict(dataset="synthetic", num_classes=NC, num_labels=10,
             batch_size=4, uratio=2, eval_batch_size=8, img_size=S,
             num_train_iter=2, num_eval_iter=2, num_log_iter=1,
             start_timing=0, N_k=1, use_pretrain=False, resume=False,
             save_dir=str(tmp_path),
             compute_dtype="float32", synthetic_train=64, synthetic_test=16,
             net_kwargs=ARCH))
    assert cfg.feature_dim == 384 and cfg.optim == "SGD"
    tr = Trainer(cfg, device="cpu")
    assert cfg.feature_dim == tr.model.num_features == 64
    stats0 = tr.model.bn1.running_mean.clone()
    results = tr.train()
    assert tr.state.step == 2
    assert all(math.isfinite(v) for v in results.values())
    assert not torch.equal(stats0, tr.model.bn1.running_mean)
    params = list(tr.model.parameters())
    assert len(tr.state.ema) == len(params)
    assert all(e.shape == p.shape for e, p in zip(tr.state.ema, params))
    x = tr.bundle.eval.data[:5]
    names = [n for n, _ in tr.model.named_parameters()]
    xs = normalize(torch.from_numpy(x), tr.aug_spec.mean, tr.aug_spec.std)
    want = functional_call(tr.model, dict(zip(names, tr.state.ema)), (xs,),
                           {"train": False})["logits"]
    stats = {n: b.clone() for n, b in tr.model.named_buffers()}
    np.testing.assert_array_equal(tr.predict(x), want.numpy())
    assert all(torch.equal(stats[n], b) for n, b in tr.model.named_buffers())
