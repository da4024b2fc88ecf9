"""The golden-learning validation of the port (``semireward_tpu_torch/
validation.py``, the ``synthetic_orbit`` task, ``golden_quality``) held
against the JAX package's ``validation.py``:

- ``make_synthetic_orbit`` and the two golden splits (the orbit's, and the
  imbalanced blob split ``imb_gain`` trains on) are bit-equal;
- ``golden_config`` sets the same fields, both tiers;
- ``NoisyFlexMatch``'s corruption is bit-equal on the same probabilities,
  uniform and class-conditional;
- ``_spearman`` equals JAX's on tie-heavy vectors;
- ``rewarder_class_probe`` gives JAX's keep rates (exact) and rewards
  (1e-3: the spread rewarder amplifies the features' float32 differences;
  measured 1.7e-4) on converted weights, JAX's second division by 255
  undone;
- three ``SRNoisyFlexMatch`` steps on a narrow WRN give JAX's losses (1e-5)
  and keep-rate metrics (exact), as ``test_torch_wrn.py`` holds SRFixMatch;
- the experiments and the sweep run end to end at a few iterations (no
  accuracy is asserted on the CPU).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_rel_close
from semireward_tpu import validation as JV
from semireward_tpu.config import get_config as jax_config
from semireward_tpu.core.step import init_train_state as jax_init
from semireward_tpu.core.step import make_train_step as jax_make_step
from semireward_tpu.data import augment as jaug
from semireward_tpu.data import datasets as JD
from semireward_tpu.models import wrn as jwrn
from semireward_tpu_torch import golden_quality
from semireward_tpu_torch import validation as TV
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.convert import load_flax_params
from semireward_tpu_torch.core.step import init_train_state as torch_init
from semireward_tpu_torch.core.step import make_train_step as torch_make_step
from semireward_tpu_torch.data import datasets as TD
from semireward_tpu_torch.models import wrn as twrn

NC, S, B = 6, 16, 4
ARCH = dict(depth=10, widen_factor=1)
BN_MOM = 0.5


def _same_bundle(tb, jb):
    assert (tb.num_classes, tb.mean, tb.std) == (jb.num_classes, jb.mean,
                                                 jb.std)
    for split in ("train_lb", "train_ulb", "eval"):
        for k in ("data", "targets"):
            got, want = (getattr(getattr(b, split), k) for b in (tb, jb))
            assert got.dtype == want.dtype, (split, k)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(), dict(noise=0, rot_lab=8.0, rot_max=160.0, proto_scale=8)])
def test_orbit_task_is_bit_equal(kw):
    args = (NC, 32, 24)
    got = TD.make_synthetic_orbit(*args, n_ulb=60, n_test=30, seed=3, **kw)
    want = JD.make_synthetic_orbit(*args, n_ulb=60, n_test=30, seed=3, **kw)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tier,kw", [
    ("base", dict(algorithm="flexmatch", lambda_u=0.0, seed=2)),
    ("hard", dict(algorithm="fixmatch", iters=50)),
    ("base", dict(algorithm="fixmatch", imb_algorithm="saw",
                  dataset="synthetic", labels=40, num_classes=4,
                  lb_imb_ratio=10.0, ulb_imb_ratio=10.0,
                  ulb_num_labels=400))])
def test_golden_config_and_split_match_jax(tier, kw):
    kw = dict(kw, tier=tier, save_dir="golden_runs")
    algorithm = kw.pop("algorithm")
    jcfg = JV.golden_config(algorithm, **kw)
    tcfg = TV.golden_config(algorithm, **kw)
    jd, td = jcfg.to_dict(), tcfg.to_dict()
    shared = sorted(set(jd) & set(td))
    assert len(shared) > 60
    for k in shared:
        assert td[k] == jd[k] or (
            isinstance(jd[k], (tuple, list))
            and list(td[k]) == list(jd[k])), (k, td[k], jd[k])
    # the golden data: the orbit, or the imbalanced blob split of imb_gain
    for c in (jcfg, tcfg):
        c.extra.update(synthetic_train=240, synthetic_test=60)
    _same_bundle(TD.get_dataset(tcfg), JD.get_dataset(jcfg))


def test_orbit_refuses_an_imbalance_ratio():
    cfg = TV.golden_config("fixmatch", lb_imb_ratio=10.0, save_dir="x")
    with pytest.raises(ValueError, match="imb_ratio"):
        TD.get_dataset(cfg)


@pytest.mark.parametrize("noise_frac,classes,shift", [
    (0.4, None, 1), (1.0, (0, 1), 3), (0.25, (2,), 5)])
def test_noisy_flexmatch_corruption_is_bit_equal(noise_frac, classes, shift):
    cfg = dict(algorithm="flexmatch", num_classes=NC)
    jcls, _ = JV.make_noisy_flexmatch(noise_frac, classes, shift)
    tcls, _ = TV.make_noisy_flexmatch(noise_frac, classes, shift)
    jalg = jcls(jax_config(**cfg), {"ulb_dest_len": 32})
    talg = tcls(torch_config(**cfg), {"ulb_dest_len": 32}, "cpu")
    probs = np.random.RandomState(0).dirichlet(np.ones(NC), 33).astype(
        np.float32)
    want = np.asarray(jalg.gen_ulb_targets(jnp.asarray(probs),
                                           softmax=False))
    got = talg.gen_ulb_targets(torch.from_numpy(probs), softmax=False)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != probs.argmax(-1)).any()


def test_spearman_and_ranks_equal_jax_on_ties():
    rs = np.random.RandomState(0)
    for _ in range(20):
        a = rs.randint(0, 3, 8).astype(float)
        b = np.round(rs.rand(8), 1)
        assert TV._spearman(a, b) == JV._spearman(a, b)
        np.testing.assert_array_equal(TV._rank(a), JV._rank(a))
    zeros = [0.0, 0.0, 0.0, 0.0, 0.5, 1.0]
    assert TV._spearman(zeros, [1, 2, 3, 4, 5, 6]) == JV._spearman(
        zeros, [1, 2, 3, 4, 5, 6])
    assert TV._spearman([1, 1, 1], [1, 2, 3]) == 0.0


# ---------------------------------------------------------------------------
# the SemiReward noise experiment's pieces on a narrow WRN
# ---------------------------------------------------------------------------

CFG = dict(net="wrn_28_2", num_classes=NC, batch_size=B, uratio=1,
           num_train_iter=10, optim="SGD", lr=0.03, momentum=0.9,
           weight_decay=5e-4, layer_decay=1.0, ema_m=0.5, img_size=S,
           compute_dtype="float32", start_timing=1, N_k=1, feature_dim=64,
           sr_ema=False, sr_lr=0.01, p_cutoff=0.0, algorithm="srflexmatch")
DATA_INFO = {"ulb_dest_len": 16, "lb_dest_len": 8}


def _perturb(params):
    return jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(
            np.random.RandomState(p.size % 997).randn(*p.shape), p.dtype),
        params)


def _pair(noise_frac=0.4, classes=None, shift=1):
    """The noisy SRFlexMatch of both packages on one narrow WRN, the JAX
    weights perturbed and copied into the port, both train states."""
    jcfg, tcfg = jax_config(**CFG), torch_config(**CFG)
    _, jsr = JV.make_noisy_flexmatch(noise_frac, classes, shift)
    _, tsr = TV.make_noisy_flexmatch(noise_frac, classes, shift)
    jalg, talg = jsr(jcfg, DATA_INFO), tsr(tcfg, DATA_INFO, "cpu")
    jmodel = jwrn.wrn_28_2(NC, dtype=jnp.float32, bn_momentum=BN_MOM, **ARCH)
    jstate, tx = jax_init(jcfg, jalg, jmodel, jax.random.PRNGKey(0),
                          jnp.zeros((2, S, S, 3)), builder=jwrn.wrn_28_2)
    params = _perturb(jstate.params)
    jstate = jstate.replace(params=params, ema_params=params)
    tmodel = twrn.wrn_28_2(NC, dtype=torch.float32, bn_momentum=BN_MOM,
                           **ARCH)
    load_flax_params(tmodel, jax.device_get(params),
                     jax.device_get(jstate.batch_stats))
    tstate = torch_init(tcfg, talg, tmodel, builder=twrn.wrn_28_2)
    load_flax_params(tstate.sr.rewarder,
                     jax.device_get(jstate.sr.rewarder_params))
    load_flax_params(tstate.sr.generator, jax.device_get(jstate.sr.gen_params))
    return (jcfg, jalg, jmodel, jstate, tx), (tcfg, talg, tmodel, tstate)


@pytest.mark.parametrize("noise_frac,classes,shift", [(0.4, None, 1),
                                                      (1.0, (0, 1), 3)])
def test_three_noisy_sr_steps_match_jax(noise_frac, classes, shift):
    (jcfg, jalg, jmodel, jstate, tx), (tcfg, talg, tmodel, tstate) = _pair(
        noise_frac, classes, shift)
    jstep = jax.jit(jax_make_step(jcfg, jalg, jmodel, tx))
    tstep = torch_make_step(tcfg, talg)
    rs = np.random.RandomState(0)
    polluted, keep = [], []
    for step in range(3):
        views = {k: rs.randn(B, S, S, 3).astype(np.float32)
                 for k in ("x_lb", "x_ulb_w", "x_ulb_s")}
        y = rs.randint(0, NC, B)
        idx = rs.choice(DATA_INFO["ulb_dest_len"], B, replace=False)
        jbatch = {**{k: jnp.asarray(v) for k, v in views.items()},
                  "y_lb": jnp.asarray(y),
                  "idx_ulb": jnp.asarray(idx, jnp.int32)}
        tbatch = {**{k: torch.from_numpy(v) for k, v in views.items()},
                  "y_lb": torch.from_numpy(y), "idx_ulb": torch.from_numpy(idx)}
        jstate, jm = jstep(jstate, jbatch)
        tm = tstep(tstate, tbatch)
        for k in ("total_loss", "sup_loss", "unsup_loss"):
            assert_rel_close(tm[k], np.asarray(jm[k]), 1e-5, f"{step} {k}")
        for k in ("util_ratio", "sr_keep_ratio", "sr_keep_polluted",
                  "sr_keep_clean", "sr_polluted_n"):
            assert float(tm[k]) == float(jm[k]), (step, k, float(tm[k]),
                                                  float(jm[k]))
        polluted.append(float(tm["sr_polluted_n"]))
        keep.append(float(tm["sr_keep_ratio"]))
    # rows were polluted, and under uniform noise the stage-2 filter
    # dropped some
    assert max(polluted) > 0, polluted
    assert classes or min(keep) < 1, keep


class _JaxProbeTrainer:
    def __init__(self, cfg, model, state, bundle):
        from semireward_tpu.data.augment import AugmentSpec

        self.cfg, self.model, self.state, self.bundle = (cfg, model, state,
                                                         bundle)
        self.aug_spec = AugmentSpec(crop_size=S, crop_pad=2, mean=bundle.mean,
                                    std=bundle.std)


class _TorchProbeTrainer:
    def __init__(self, cfg, model, state, bundle):
        from semireward_tpu_torch.data.augment import AugmentSpec

        self.cfg, self.model, self.state, self.bundle = (cfg, model, state,
                                                         bundle)
        self.aug_spec = AugmentSpec(crop_size=S, crop_pad=2, mean=bundle.mean,
                                    std=bundle.std)

    def _to_device(self, arr):
        return torch.from_numpy(np.ascontiguousarray(arr))


@functools.lru_cache(maxsize=1)
def _eval_bundles():
    kw = dict(dataset="synthetic_orbit", num_classes=NC, num_labels=NC * 2,
              img_size=S, synthetic_train=30, synthetic_test=80)
    return TD.get_dataset(torch_config(**kw)), JD.get_dataset(jax_config(**kw))


@pytest.mark.parametrize("classes,shift", [(None, 1), ((0, 1), 3)])
def test_rewarder_class_probe_matches_jax(monkeypatch, classes, shift):
    (jcfg, _, jmodel, jstate, _), (tcfg, _, tmodel, tstate) = _pair()
    # a rewarder that tells the labels apart (at init its rewards of all
    # labels lie within rounding of their mean)
    sr = jstate.sr.replace(rewarder_params=jax.tree_util.tree_map(
        lambda p: p + 0.5 * jnp.asarray(
            np.random.RandomState(p.size % 991).randn(*p.shape), p.dtype),
        jstate.sr.rewarder_params))
    jstate = jstate.replace(sr=sr)
    load_flax_params(tstate.sr.rewarder, jax.device_get(sr.rewarder_params))
    tb, jb = _eval_bundles()
    # JAX's probe divides the images by 255 before ``normalize``, which
    # divides them again; the port normalizes once, as its eval does. Undo
    # JAX's extra division here
    monkeypatch.setattr(jaug, "normalize",
                        lambda x, m, s, f=jaug.normalize: f(x * 255.0, m, s))
    want = JV.rewarder_class_probe(
        _JaxProbeTrainer(jcfg, jmodel, jstate, jb), batch=24, rounds=4,
        noise_frac=0.5, classes=classes, shift=shift)
    got = TV.rewarder_class_probe(
        _TorchProbeTrainer(tcfg, tmodel, tstate, tb), batch=24, rounds=4,
        noise_frac=0.5, classes=classes, shift=shift)
    assert sorted(got) == sorted(want)
    for k in ("per_label_keep_rate", "per_label_count",
              "per_label_pair_accuracy", "spearman_keep_vs_accuracy",
              "polluted_labels", "keep_rate_polluted_labels",
              "keep_rate_clean_labels"):
        if k in want:
            assert got[k] == want[k], (k, got[k], want[k])
    np.testing.assert_allclose(got["per_label_reward"],
                               want["per_label_reward"], rtol=1e-3, atol=0)
    assert got["spearman_reward_vs_accuracy"] == pytest.approx(
        want["spearman_reward_vs_accuracy"], abs=1e-12)
    assert 0 < sum(got["per_label_keep_rate"]) < NC


def test_experiments_and_sweep_run_end_to_end_on_the_cpu(tmp_path):
    """The mechanics only: every run trains and evaluates, the sweep
    writes its report with the JAX report's keys and the device."""
    common = dict(device="cpu", save_dir=str(tmp_path / "runs"))
    ssl = TV.ssl_gain("flexmatch", iters=2, **common)
    assert set(ssl) == {"algorithm", "supervised_acc", "ssl_acc", "gain"}
    imb = TV.imb_gain("saw", gamma=10.0, iters=2, **common)
    assert 0.0 <= imb["imb_balanced_acc"] <= 1.0
    # the sweep: the thresholding families, both SemiReward experiments
    # with the probe and the control
    report = golden_quality.main([
        "--device", "cpu", "--iters", "2", "--skip_extra", "--skip_imb",
        "--sr_iters", "2", "--seed", "1", "--out_dir", str(tmp_path),
        "--save_dir", str(tmp_path / "sweep")])
    with open(tmp_path / "QUALITY_torch_r01_seed1.json") as f:
        assert json.load(f) == json.loads(json.dumps(report, default=float))
    assert report["device"] == {"platform": "cpu"}
    assert set(report["thresholding_families"]) == set(
        golden_quality.THRESHOLD_FAMILIES)
    for k in ("labeled_only_acc", "semireward_noise",
              "semireward_class_noise"):
        assert k in report, k
    sr = report["semireward_noise"]
    for k in ("noisy_flexmatch_acc", "sr_noisy_flexmatch_acc", "sr_gain",
              "per_label_keep_rate", "per_label_count",
              "spearman_reward_vs_accuracy", "control_downweighted_acc"):
        assert k in sr, k


def test_draw_witness_follows_the_cpu_run_on_the_cpu(tmp_path):
    """``draw_witness`` with its 'card' on the CPU: the run on a CPU
    generator and the run on the device's own generator follow the CPU run
    step for step, so the generator's placement changes nothing where the
    devices are one."""
    from semireward_tpu_torch.draw_witness import witness

    out = witness("flexmatch", 0, 4, str(tmp_path), device="cpu")
    assert out["first_selected_label_diff_step"] == -1
    assert out["first_loss_diff_step"] == -1
    assert out["cpu"]["acc"] == out["card_cpu_draws"]["acc"] == (
        out["card"]["acc"])


def test_golden_runs_draw_from_a_cpu_generator(monkeypatch):
    """``run_golden`` gives the Trainer a CPU generator unless asked for
    the device's own; the sweep passes its ``--rng_device`` through."""
    from semireward_tpu_torch.core import trainer as T

    seen = []

    class Stop(Exception):
        pass

    def fake(self, cfg, device=None, alg_factory=None, rng_device=None):
        seen.append(rng_device)
        raise Stop

    monkeypatch.setattr(T.Trainer, "__init__", fake)
    for kw, want in (({}, "cpu"), ({"rng_device": None}, None)):
        with pytest.raises(Stop):
            TV.run_golden("fixmatch", iters=2, device="cpu", **kw)
        assert seen.pop() == want
    with pytest.raises(Stop):
        golden_quality.main(["--device", "cpu", "--rng_device", "cuda",
                             "--only", "fixmatch", "--iters", "2"])
    assert seen.pop() == "cuda"
