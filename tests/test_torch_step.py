"""The slice as a whole: three SRFlexMatch train steps of the JAX package
(make_train_step, fused MLP on, its Pallas kernels in interpret mode) and of
the port (core/step.py, fused MLP through its plain CPU path) from the same
weights on the same injected views. A narrow 2-block ViT, drop_path 0,
float32 compute, start_timing=1 and N_k=1: step 0 is stage 1, step 1 enters
stage 2, step 2 applies the reward filter and trains the rewarder.

Compared after every step: losses (1e-5 of their magnitude), the confidence
and reward-filter ratios and FlexMatch state (exact), every parameter and
the rewarder (1e-4 of each leaf's largest magnitude). Adam's first steps
divide each gradient by its own magnitude, so for the rare element whose
gradient is near zero a last-bit difference moves the step by up to 2*lr:
at most 0.1% of a leaf's elements may take that bound instead.
Exempt from the relative check are the parameters whose true gradient is
zero: the key third of each ``qkv.bias`` (a constant key shift leaves the
attention softmax unchanged) and the rewarder's ``cross_attention_fc.bias``
(its softmax over the batch is shift-invariant). Both sides step them on
rounding noise, which Adam scales up to +-lr per step; they are held to
that bound, and no output depends on them.

Also: a 2-step run of the port's Trainer on synthetic data on the CPU.
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
from semireward_tpu.core.step import init_train_state as jax_init
from semireward_tpu.core.step import make_train_step as jax_make_step
from semireward_tpu.models import vit as jvit
from semireward_tpu.registry import ALGORITHMS as JALGS
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.convert import flax_to_torch, load_flax_params
from semireward_tpu_torch.core.step import init_train_state as torch_init
from semireward_tpu_torch.core.step import make_train_step as torch_make_step
from semireward_tpu_torch.models import vit as tvit
from semireward_tpu_torch.ops import fused_mlp as F
from semireward_tpu_torch.registry import ALGORITHMS as TALGS

B, NC, S, EMB = 4, 4, 16, 32
ARCH = dict(depth=2, embed_dim=EMB, num_heads=2, img_size=S, patch_size=4,
            drop_path_rate=0.0, use_fused_mlp=True)
CFG = dict(algorithm="srflexmatch", net="vit_small_patch2_32",
           num_classes=NC, batch_size=B, uratio=1, num_train_iter=10,
           optim="AdamW", lr=0.01, layer_decay=0.5, weight_decay=5e-4,
           ema_m=0.5, img_size=S, compute_dtype="float32", start_timing=1,
           N_k=1, feature_dim=EMB, sr_ema=False, sr_lr=0.01, p_cutoff=0.5)
DATA_INFO = {"ulb_dest_len": 16, "lb_dest_len": 8}


def _flat(tree):
    return flax_to_torch(jax.tree_util.tree_map(np.asarray, tree))


def _perturb(tree, scale):
    return jax.tree_util.tree_map(
        lambda p: p + scale * jnp.asarray(
            np.random.RandomState(p.size % 9973).randn(*p.shape), p.dtype),
        tree)


def _check_leaf(name, got, want, lr_bound, min_far=0):
    if name.endswith("attn.qkv.bias"):
        k = slice(EMB, 2 * EMB)
        assert np.abs(got[k] - want[k]).max() <= lr_bound, name
        got, want = np.delete(got, np.r_[k]), np.delete(want, np.r_[k])
    elif name == "cross_attention_fc.bias":
        assert np.abs(got - want).max() <= lr_bound, name
        return
    diff = np.abs(got - want)
    far = diff > 1e-4 * np.abs(want).max() + 1e-12
    assert far.sum() <= max(1e-3 * far.size, min_far), (name, int(far.sum()),
                                                         diff.max())
    assert diff.max() <= lr_bound, (name, diff.max())


def run_three_sr_steps(name, check_algo, over=None, extra=None,
                       before_step=None, trained_at=(2,), rewarder_far=0,
                       views=None, arch=None, size=S):
    """Three ``name`` steps of both packages from the same weights on the
    same injected views (three drawn a step, the ones the algorithm
    consumes passed in); after each,
    the losses, the reward-filter ratio, every parameter, the EMA, the
    rewarder and max_reward are compared here, and
    ``check_algo(step, tstate, jstate, tm, jm)`` compares the algorithm's
    own mask ratio and state. ``over`` and ``extra`` go on top of ``CFG``
    and into both configs' ``extra``; ``before_step(step, jstate, tbatch)``
    runs before each step; the rewarder must move at the steps
    ``trained_at`` and only there, each of its leaves with up to
    ``rewarder_far`` elements at the Adam bound where 0.1% is fewer.
    ``views(step)`` gives a step's float32 views in place of the drawn
    ones. ``arch`` replaces ``ARCH`` (on both sides), ``size`` the image
    size."""
    arch = ARCH if arch is None else arch
    cfg = dict(CFG, algorithm=name, **(over or {}))
    jcfg, tcfg = jax_config(**cfg), torch_config(**cfg)
    jcfg.extra.update(extra or {})
    tcfg.extra.update(extra or {})
    jalg = JALGS.get(name)(jcfg, DATA_INFO)
    jmodel = jvit.vit_small_patch2_32(num_classes=NC, dtype=jnp.float32,
                                      **arch)
    jstate, tx = jax_init(jcfg, jalg, jmodel, jax.random.PRNGKey(0),
                          jnp.zeros((2, size, size, 3)),
                          builder=jvit.vit_small_patch2_32)
    params = _perturb(jstate.params, 0.02)
    jstate = jstate.replace(params=params, ema_params=params)
    jstep = jax.jit(jax_make_step(jcfg, jalg, jmodel, tx))

    talg = TALGS.get(name)(tcfg, DATA_INFO, torch.device("cpu"))
    tmodel = tvit.vit_small_patch2_32(num_classes=NC, dtype=torch.float32,
                                      **arch)
    load_flax_params(tmodel, jax.device_get(params))
    tstate = torch_init(tcfg, talg, tmodel, builder=tvit.vit_small_patch2_32)
    load_flax_params(tstate.sr.rewarder,
                     jax.device_get(jstate.sr.rewarder_params))
    load_flax_params(tstate.sr.generator, jax.device_get(jstate.sr.gen_params))
    tstep = torch_make_step(tcfg, talg)

    rs = np.random.RandomState(0)
    names = [n for n, _ in tmodel.named_parameters()]
    make_views = views
    for step in range(3):
        views = {k: rs.randn(B, size, size, 3).astype(np.float32)
                 for k in ("x_lb", "x_ulb_w", "x_ulb_s")}
        if make_views is not None:
            views = make_views(step)
        views = {k: v for k, v in views.items() if k in talg.BATCH_KEYS}
        y = rs.randint(0, NC, B)
        idx = rs.choice(DATA_INFO["ulb_dest_len"], B, replace=False)
        jbatch = {**{k: jnp.asarray(v) for k, v in views.items()},
                  "y_lb": jnp.asarray(y),
                  "idx_ulb": jnp.asarray(idx, jnp.int32)}
        tbatch = {**{k: torch.from_numpy(v) for k, v in views.items()},
                  "y_lb": torch.from_numpy(y), "idx_ulb": torch.from_numpy(idx)}
        rewarder_before = [p.detach().clone()
                           for p in tstate.sr.rewarder.parameters()]
        if before_step is not None:
            before_step(step, jstate, tbatch)
        jstate, jm = jstep(jstate, jbatch)
        tm = tstep(tstate, tbatch)

        for k in ("total_loss", "sup_loss", "unsup_loss"):
            assert_rel_close(tm[k], np.asarray(jm[k]), 1e-5, f"{step} {k}")
        assert float(tm["sr_keep_ratio"]) == float(jm["sr_keep_ratio"]), step
        check_algo(step, tstate, jstate, tm, jm)

        bound = 2 * CFG["lr"] * (step + 1) + 1e-6
        want, want_ema = _flat(jstate.params), _flat(jstate.ema_params)
        for n, p, e in zip(names, tmodel.parameters(), tstate.ema):
            _check_leaf(n, p.detach().numpy(), want[n], bound)
            _check_leaf(n, e.numpy(), want_ema[n], bound)
        want_r = _flat(jstate.sr.rewarder_params)
        for n, p in tstate.sr.rewarder.named_parameters():
            _check_leaf(n, p.detach().numpy(), want_r[n], bound, rewarder_far)
        jmax, tmax = float(jstate.sr.max_reward), float(tstate.sr.max_reward)
        assert (jmax == tmax == -math.inf) or abs(jmax - tmax) < 1e-5
        moved = any(not torch.equal(a, b) for a, b in
                    zip(rewarder_before, tstate.sr.rewarder.parameters()))
        assert moved == (step in trained_at), step  # N_k: once step > 1
        if step == 2 and step > cfg["start_timing"]:
            assert float(jm["sr_keep_ratio"]) < 1.0  # the filter is active
    assert tstate.step == 3 and int(jstate.step) == 3
    return tstate, jstate


def test_three_srflexmatch_steps_match_jax():
    selected_any = []

    def check(step, tstate, jstate, tm, jm):
        assert float(tm["util_ratio"]) == float(jm["util_ratio"]), step
        np.testing.assert_array_equal(tstate.algo.selected_label.numpy(),
                                      np.asarray(jstate.algo.selected_label))
        np.testing.assert_array_equal(tstate.algo.classwise_acc.numpy(),
                                      np.asarray(jstate.algo.classwise_acc))
        selected_any.append(bool((tstate.algo.selected_label >= 0).any()))

    run_three_sr_steps("srflexmatch", check)
    assert any(selected_any)


def test_trainer_two_steps_on_cpu(tmp_path):
    from semireward_tpu_torch.core.trainer import Trainer

    cfg = torch_config(
        algorithm="srflexmatch", net="vit_small_patch2_32",
        dataset="synthetic", num_classes=NC, num_labels=8, batch_size=4,
        eval_batch_size=8, img_size=S, num_train_iter=2, num_eval_iter=2,
        num_log_iter=1, start_timing=1, N_k=1, feature_dim=EMB,
        optim="AdamW", lr=5e-4, layer_decay=0.5, synthetic_train=64,
        synthetic_test=16, save_dir=str(tmp_path),
        net_kwargs={k: v for k, v in ARCH.items()
                    if k not in ("use_fused_mlp", "img_size")})
    F.reset_launches()
    tr = Trainer(cfg, device="cpu")
    results = tr.train()
    assert tr.state.step == 2
    assert len(tr.log_history) == 2
    assert all(math.isfinite(v) for v in results.values())
    assert 0.0 <= results["eval/top-1-acc"] <= 1.0
    # the CPU path runs the plain version, never a kernel
    assert F.launches == {"fused_mlp_fwd": 0, "fused_mlp_bwd": 0,
                          "fused_mlp_blocked_fwd": 0,
                          "fused_mlp_blocked_bwd": 0, "fused_mlp_dense": 0}
    logits = tr.predict(tr.bundle.eval.data[:5])
    assert logits.shape == (5, NC) and np.isfinite(logits).all()
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "latest_model.ckpt", "metrics.jsonl", "model_best.ckpt"]


def test_trainer_refuses_what_is_not_ported(tmp_path):
    from semireward_tpu_torch.core.trainer import Trainer

    # resume and use_pretrain are ported (tests/test_torch_checkpoint.py,
    # tests/test_torch_pretrained.py), imbalanced SSL too
    # (tests/test_torch_imb.py), ResNet-50 (tests/test_torch_resnet.py) and
    # the ImageNet-127 data of its runs (tests/test_torch_jpeg.py): the
    # YAML reaches the JPEG-folder loader, which reads the local folder
    from semireward_tpu_torch import config as config_lib

    cfg = config_lib.from_yaml(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "config/classic_cv_imb/fixmatch_abc/"
        "fixmatch_abc_imagenet127_lb128101_286_ulbNone_286_0.yaml"),
        {"save_dir": str(tmp_path), "data_dir": str(tmp_path)})
    assert cfg.imb_algorithm == "abc" and cfg.net == "resnet50"
    with pytest.raises(FileNotFoundError, match="imagenet.train"):
        Trainer(cfg, device="cpu")
    # the bench's ref-equivalent arm is ported
    # (tests/test_torch_sr_variants.py)
    ref = torch_config(algorithm="srflexmatch")
    ref.extra["sr_reforward"] = 3
    assert TALGS.get("srflexmatch")(ref, DATA_INFO).base.NAME == "flexmatch"
