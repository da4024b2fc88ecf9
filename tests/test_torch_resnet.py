"""ResNet-50 in the port, held against the JAX package's ``resnet50``: the
parameter and ``batch_stats`` names through the converter, the layer-decay
groups, the forward in eval and train mode with the running statistics it
leaves, and three FixMatch steps with the statistics compared after each.

32 px, batch 4, float32. Tolerances: the eval forward (running statistics)
1e-5 of the largest magnitude, as the WRN tests'. In train mode each of the
53 BatchNorms normalizes by statistics of its batch: layer4's channels see
4 samples (1 x 1 at 32 px), and dividing by their spread amplifies the
float32 rounding of the convs (summed in another order) layer by layer:
logits and features 1e-2 of their largest magnitude there, running
statistics 1e-2 (measured: 1.1e-3, 6.0e-3 and 4.9e-4; the stem's 1e-7).
The steps: each starts from JAX's weights, statistics, EMA and SGD momentum
(``_sync``); losses 1e-2, the mask ratio within one row, each leaf within
5e-2 of the norm of JAX's update (``_check_update``, as the imbalanced-SSL
tests hold the WRN at 1e-2): the gradients of these BatchNorm leaves are as
ill-conditioned (measured: the port's float32 gradients of a step at this
geometry differ from its own float64 ones by up to 2.7% of a leaf's norm,
and from JAX's update by up to 2.4%). The BatchNorm semantics are pinned
tightly by a wider train forward (64 px, batch 8) against JAX's in
float64 at 1e-4, with the weight-decay mask leaf for leaf.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import assert_rel_close
from semireward_tpu.config import get_config as jax_config
from semireward_tpu.core.step import init_train_state as jax_init
from semireward_tpu.core.step import make_train_step as jax_make_step
from semireward_tpu.models import resnet as jresnet
from semireward_tpu.registry import ALGORITHMS as JALGS
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.convert import (flax_to_torch, load_flax_params,
                                          torch_name)
from semireward_tpu_torch.core.step import init_train_state as torch_init
from semireward_tpu_torch.core.step import make_train_step as torch_make_step
from semireward_tpu_torch.models import resnet as tresnet
from semireward_tpu_torch.registry import ALGORITHMS as TALGS
from semireward_tpu_torch.registry import NETS

NC, S, B = 7, 32, 4
TRAIN_TOL = 1e-2  # batch-statistic forwards (the module docstring)
WIDE_S, WIDE_B, WIDE_TOL = 64, 8, 1e-4  # the well-conditioned train forward


def _perturb(params):
    """BN scales 1 and biases 0 at init, the head's bias 0: perturb those
    so that every one matters (the convs keep their init)."""
    def leaf(path, p):
        if path[-1].key == "kernel":
            return p
        return p + 0.05 * jnp.asarray(
            np.random.RandomState(p.size % 997).randn(*p.shape), p.dtype)
    return jax.tree_util.tree_map_with_path(leaf, params)


@functools.lru_cache(maxsize=1)
def _jax_variables():
    jm = jresnet.resnet50(NC, dtype=jnp.float32)
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((2, S, S, 3)), train=False))(
        jax.random.PRNGKey(0))
    return {"params": _perturb(v["params"]), "batch_stats": v["batch_stats"]}


def _pair():
    jm, v = jresnet.resnet50(NC, dtype=jnp.float32), _jax_variables()
    tm = tresnet.resnet50(NC, dtype=torch.float32)
    load_flax_params(tm, jax.device_get(v["params"]),
                     jax.device_get(v["batch_stats"]))
    return jm, v, tm


def _stats(tree):
    return flax_to_torch(jax.tree_util.tree_map(np.asarray, tree), stats=True)


def _same_stats(tm, batch_stats, what=""):
    want = _stats(batch_stats)
    got = dict(tm.named_buffers())
    assert sorted(want) == sorted(got)
    for n, w in want.items():
        assert_rel_close(got[n], w, TRAIN_TOL, f"{what} {n}")


def _images(seed, n=B):
    return np.random.RandomState(seed).randn(n, S, S, 3).astype(np.float32)


def test_names_layer_ids_and_registry_match_the_flax_net():
    jm, v, tm = _pair()
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, v["params"]))
    assert sorted(want) == sorted(n for n, _ in tm.named_parameters())
    assert "layer2.0.conv_ds.weight" in want and "layer4.2.bn3.bias" in want
    assert tm.num_features == jm.num_features == 2048
    assert NETS.get("resnet50") is tresnet.resnet50
    assert tresnet.resnet50.num_layers == jresnet.resnet50.num_layers == 5
    # the JAX layer id of each flax path against the port's of its name
    for path, _ in jax.tree_util.tree_flatten_with_path(v["params"])[0]:
        keys = [k.key for k in path]
        got = tresnet.layer_id(torch_name(keys).split("."), 5)
        assert got == jresnet._layer_id(keys, 5), (keys, got)
    ids = {n: tresnet.layer_id(n.split("."), 5)
           for n, _ in tm.named_parameters()}
    assert ids["conv1.weight"] == ids["bn1.bias"] == 0
    assert ids["layer3.5.conv2.weight"] == 3 and ids["fc.bias"] == 5


@pytest.mark.parametrize("train", [True, False])
def test_forward_and_running_stats_match(train):
    jm, v, tm = _pair()
    x = _images(1)
    if train:
        out, st = jax.jit(functools.partial(
            jm.apply, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
        got = tm(torch.from_numpy(x), train=True)
        _same_stats(tm, st["batch_stats"], "after one train forward")
    else:
        out = jax.jit(functools.partial(jm.apply, train=False))(
            v, jnp.asarray(x))
        before = {n: b.clone() for n, b in tm.named_buffers()}
        got = tm(torch.from_numpy(x), train=False)
        assert all(torch.equal(before[n], b) for n, b in tm.named_buffers())
    for k in ("logits", "feat"):
        assert_rel_close(got[k].detach(), np.asarray(out[k]),
                         TRAIN_TOL if train else 1e-5, k)
    feat = tm(torch.from_numpy(x), train=False, only_feat=True)
    assert feat.shape == (B, 2048) and feat.dtype == torch.float32
    logits = tm(feat, only_fc=True)
    assert_rel_close(logits.detach(),
                     np.asarray(jm.apply(v, jnp.asarray(feat.detach().numpy()),
                                         only_fc=True)), 1e-5, "only_fc")


def test_wider_train_forward_and_decay_mask_hold_float64_jax():
    """The well-conditioned case: 64 px, batch 8 (layer4's BatchNorms see
    32 values a channel). The port's float32 train forward against JAX's
    in float64 (the same weights), the float32 rounding alone between
    them: logits, features and every running statistic within
    ``WIDE_TOL`` (measured: 5.4e-5, 6.4e-5 and 3.2e-5 of the largest
    magnitude; JAX's own float32 forward sits 3.7e-4 from its float64 one,
    the port's float32 against itself under another conv algorithm 3e-5).
    And which parameters take weight decay, leaf for leaf as JAX's."""
    from semireward_tpu.core.optim import default_wd_mask as jax_wd_mask
    from semireward_tpu_torch.core.optim import default_wd_mask

    v = _jax_variables()
    x = np.random.RandomState(1).randn(WIDE_B, WIDE_S, WIDE_S, 3)
    jax.config.update("jax_enable_x64", True)
    try:
        jm = jresnet.resnet50(NC, dtype=jnp.float64)
        out, st = jax.jit(functools.partial(
            jm.apply, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
        out = {k: np.asarray(o, np.float64) for k, o in out.items()}
        want = _stats(st["batch_stats"])
    finally:
        jax.config.update("jax_enable_x64", False)
    _, _, tm = _pair()
    got = tm(torch.from_numpy(x.astype(np.float32)), train=True)
    for k in ("logits", "feat"):
        assert_rel_close(got[k].detach(), out[k], WIDE_TOL, k)
    bufs = dict(tm.named_buffers())
    assert sorted(want) == sorted(bufs)
    for n, w in want.items():
        assert_rel_close(bufs[n], w, WIDE_TOL, n)
    jmask = {torch_name([k.key for k in path]): bool(m) for path, m in
             jax.tree_util.tree_flatten_with_path(
                 jax_wd_mask(v["params"]))[0]}
    assert default_wd_mask(tm) == jmask


def test_bf16_compute_keeps_float32_head_and_stats():
    tm = tresnet.resnet50(NC, generator=torch.Generator().manual_seed(0))
    out = tm(torch.from_numpy(_images(2)), train=True)
    assert out["logits"].dtype == out["feat"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(b.dtype == torch.float32 for b in tm.buffers())
    assert torch.isfinite(out["logits"]).all()
    # the builder ignores what the flax builder ignores
    again = tresnet.resnet50(NC, generator=torch.Generator().manual_seed(0),
                             bn_momentum=0.5, remat=True, img_size=112)
    assert again.bn1.momentum == 0.9
    for a, b in zip(tm.parameters(), again.parameters()):
        assert torch.equal(a, b)


CFG = dict(net="resnet50", num_classes=NC, batch_size=B, uratio=1,
           num_train_iter=10, optim="SGD", lr=0.03, momentum=0.9,
           weight_decay=5e-4, layer_decay=1.0, ema_m=0.5, img_size=S,
           compute_dtype="float32", p_cutoff=0.3, algorithm="fixmatch")
DATA_INFO = {"ulb_dest_len": 16, "lb_dest_len": 8}


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
            tstate.ema[i].copy_(torch.from_numpy(np.array(ema[n])))
            tstate.opt.trace[i].copy_(torch.from_numpy(np.array(mom[n])))


def _check_update(name, got, want, before):
    """``got`` within 5e-2 of the norm of JAX's update ``want - before``
    (and 1e-6 of the leaf where it does not move)."""
    err = float(np.linalg.norm(got - want))
    upd = float(np.linalg.norm(want - before))
    assert err <= 5e-2 * upd + 1e-6 * float(np.abs(want).max()), (
        name, err, upd)


class _CachedInit:
    """``model`` for ``init_train_state``: the variables ``_jax_variables``
    made with one compiled init (the eager init compiles every operation
    on its own)."""

    def init(self, *a, **kw):
        return _jax_variables()


def test_three_fixmatch_steps_match_jax():
    jcfg, tcfg = jax_config(**CFG), torch_config(**CFG)
    jalg = JALGS.get("fixmatch")(jcfg, DATA_INFO)
    jmodel = jresnet.resnet50(NC, dtype=jnp.float32)
    v = _jax_variables()
    jstate, tx = jax_init(jcfg, jalg, _CachedInit(), jax.random.PRNGKey(0),
                          jnp.zeros((2, S, S, 3)), builder=jresnet.resnet50)
    jstate = jstate.replace(params=v["params"], ema_params=v["params"],
                            batch_stats=v["batch_stats"])
    jstep = jax.jit(jax_make_step(jcfg, jalg, jmodel, tx))

    talg = TALGS.get("fixmatch")(tcfg, DATA_INFO, torch.device("cpu"))
    tmodel = tresnet.resnet50(NC, dtype=torch.float32)
    tstate = torch_init(tcfg, talg, tmodel, builder=tresnet.resnet50)
    tstep = torch_make_step(tcfg, talg)

    rs = np.random.RandomState(0)
    names = [n for n, _ in tmodel.named_parameters()]
    for step in range(3):
        _sync(jstate, tmodel, tstate)
        before = [flax_to_torch(jax.device_get(t))
                  for t in (jstate.params, jstate.ema_params)]
        views = {k: rs.randn(B, S, S, 3).astype(np.float32)
                 for k in ("x_lb", "x_ulb_w", "x_ulb_s")}
        y = rs.randint(0, NC, B)
        idx = rs.choice(DATA_INFO["ulb_dest_len"], B, replace=False)
        jbatch = {**{k: jnp.asarray(x) for k, x in views.items()},
                  "y_lb": jnp.asarray(y),
                  "idx_ulb": jnp.asarray(idx, jnp.int32)}
        tbatch = {**{k: torch.from_numpy(x) for k, x in views.items()},
                  "y_lb": torch.from_numpy(y), "idx_ulb": torch.from_numpy(idx)}
        jstate, jm = jstep(jstate, jbatch)
        tm = tstep(tstate, tbatch)
        for k in ("total_loss", "sup_loss", "unsup_loss"):
            assert_rel_close(tm[k], np.asarray(jm[k]), TRAIN_TOL,
                             f"{step} {k}")
        assert abs(float(tm["util_ratio"]) - float(jm["util_ratio"])) <= (
            1.0 / B + 1e-6), step
        _same_stats(tmodel, jstate.batch_stats, f"step {step}")
        want = [flax_to_torch(jax.device_get(t))
                for t in (jstate.params, jstate.ema_params)]
        for n, p, e in zip(names, tmodel.parameters(), tstate.ema):
            _check_update(n, p.detach().numpy(), want[0][n], before[0][n])
            _check_update(f"ema {n}", e.numpy(), want[1][n], before[1][n])
    assert tstate.step == 3 and int(jstate.step) == 3
