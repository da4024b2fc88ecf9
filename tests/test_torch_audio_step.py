"""The audio slice as a whole: three SRFlexMatch train steps of the JAX
package (make_train_step) and of the port (core/step.py) on a small HuBERT
(hidden 64, 2 layers, 2 heads, the fixed intermediate 3072, the full
7-conv feature extractor, float32 compute) from the same weights on the
same waveform views (T 1600), ``use_cat`` concatenating them. Both sides
wrap the net so that it runs at ``train=False``: the two dropout streams are
not matched. start_timing=1 and N_k=1: step 0 is stage 1, step 1 enters
stage 2, step 2 applies the reward filter and trains the rewarder.

The feature extractor is frozen (flax ``stop_gradient``, the port's
``no_grad``): optax gives its kernels a zero gradient, so AdamW's weight
decay still shrinks them; the port's step materializes those zeros. A
weight decay of 0.1 makes that shrink (2.7e-4 of each conv kernel per step
at layer decay 0.65**3) visible: the conv kernels must move, and by what
JAX moves them, within 1e-6 of their largest magnitude.

Tolerances otherwise as in tests/test_torch_step.py: losses within 1e-5 of
their magnitude; the confidence and reward-filter ratios and FlexMatch state
exact; every parameter within 1e-4 of its leaf's largest magnitude, with at
most 1% of a leaf's elements, or 2 where that is more, at the Adam bound
2*lr*steps instead (a near-zero gradient divided by its own magnitude).
The share is 0.1% in tests/test_torch_step.py; here the hidden width is 64
against the fixed intermediate 3072, and 23 of ``layer.0.ff1.bias``'s 3072
elements (0.75%) and 1 of ``layer.0.q.bias``'s 64 took such gradients
(measured: 4.3e-6 apart at most). Exempt from the relative
check are the parameters whose true gradient is zero: each layer's
``k.bias`` (a constant key shift leaves the softmax unchanged) and the
rewarder's ``cross_attention_fc.bias``; both sides step them on rounding
noise, held to the Adam bound.

Also: two steps of ``python -m semireward_tpu_torch.train`` on the esc50
YAML, with the small geometry, on the CPU.
"""
import json
import math
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import assert_rel_close
from semireward_tpu.config import get_config as jax_config
from semireward_tpu.core.step import init_train_state as jax_init
from semireward_tpu.core.step import make_train_step as jax_make_step
from semireward_tpu.models import hubert as jhubert
from semireward_tpu.registry import ALGORITHMS as JALGS
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.convert import flax_to_torch, load_flax_params
from semireward_tpu_torch.core.step import init_train_state as torch_init
from semireward_tpu_torch.core.step import make_train_step as torch_make_step
from semireward_tpu_torch.models import hubert as thubert
from semireward_tpu_torch.registry import ALGORITHMS as TALGS

B, NC, T = 4, 3, 1600
GEOM = dict(hidden=64, layers=2, heads=2)
CFG = dict(algorithm="srflexmatch", net="hubert_base", num_classes=NC,
           batch_size=B, uratio=1, num_train_iter=10, optim="AdamW", lr=0.01,
           layer_decay=0.65, weight_decay=0.1, ema_m=0.5,
           compute_dtype="float32", start_timing=1, N_k=1, feature_dim=64,
           sr_ema=False, sr_lr=0.01, p_cutoff=0.5, use_cat=True)
DATA_INFO = {"ulb_dest_len": 16, "lb_dest_len": 8}


class JaxEvalNet(fnn.Module):
    net: fnn.Module

    @fnn.compact
    def __call__(self, x, train=True, **kw):
        return self.net(x, train=False, **kw)


class TorchEvalNet(torch.nn.Module):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x, train=True, **kw):
        return self.net(x, train=False, **kw)


def _layer_decay(layer_id):
    return types.SimpleNamespace(
        layer_id_fn=lambda names, n: layer_id(names[1:], n), num_layers=3)


def _flat(tree):
    return flax_to_torch(jax.tree_util.tree_map(np.asarray, tree))


def _check_leaf(name, got, want, lr_bound):
    diff = np.abs(got - want)
    if name.endswith((".k.bias", "cross_attention_fc.bias")):
        assert diff.max() <= lr_bound, name
        return
    far = diff > 1e-4 * np.abs(want).max() + 1e-12
    assert far.sum() <= max(1e-2 * far.size, 2), (name, int(far.sum()),
                                                  diff.max())
    assert diff.max() <= lr_bound, (name, diff.max())


def _views(rs):
    t = np.arange(T) / 16000.0
    out = {}
    for k in ("x_lb", "x_ulb_w", "x_ulb_s"):
        f = rs.uniform(100, 3000, (B, 1))
        out[k] = (0.3 * np.sin(2 * np.pi * f * t)
                  + 0.05 * rs.randn(B, T)).astype(np.float32)
    return out


def test_three_srflexmatch_hubert_steps_match_jax():
    jcfg, tcfg = jax_config(**CFG), torch_config(**CFG)
    jalg = JALGS.get("srflexmatch")(jcfg, DATA_INFO)
    jmodel = JaxEvalNet(jhubert.ClassificationAudioTransformer(
        num_classes=NC, dtype=jnp.float32, **GEOM))
    txs = []

    def init(rng):   # one compiled program instead of many eager ones
        state, tx = jax_init(jcfg, jalg, jmodel, rng, jnp.zeros((2, T)),
                             builder=_layer_decay(jhubert._layer_id))
        txs.append(tx)
        return state

    jstate = jax.jit(init)(jax.random.PRNGKey(0))
    jstep = jax.jit(jax_make_step(jcfg, jalg, jmodel, txs[0]))

    talg = TALGS.get("srflexmatch")(tcfg, DATA_INFO, torch.device("cpu"))
    tmodel = TorchEvalNet(thubert.hubert_base(NC, dtype=torch.float32, **GEOM))
    load_flax_params(tmodel, jax.device_get(jstate.params))
    tstate = torch_init(tcfg, talg, tmodel,
                        builder=_layer_decay(thubert.layer_id))
    load_flax_params(tstate.sr.rewarder,
                     jax.device_get(jstate.sr.rewarder_params))
    load_flax_params(tstate.sr.generator, jax.device_get(jstate.sr.gen_params))
    tstep = torch_make_step(tcfg, talg)

    rs = np.random.RandomState(0)
    names = [n for n, _ in tmodel.named_parameters()]
    conv = "net.feature_extractor.conv3.weight"
    conv0 = dict(tmodel.named_parameters())[conv].detach().clone().numpy()
    for step in range(3):
        views = _views(rs)
        y = rs.randint(0, NC, B)
        idx = rs.choice(DATA_INFO["ulb_dest_len"], B, replace=False)
        jbatch = {**{k: jnp.asarray(v) for k, v in views.items()},
                  "y_lb": jnp.asarray(y),
                  "idx_ulb": jnp.asarray(idx, jnp.int32)}
        tbatch = {**{k: torch.from_numpy(v) for k, v in views.items()},
                  "y_lb": torch.from_numpy(y), "idx_ulb": torch.from_numpy(idx)}
        rewarder_before = [p.detach().clone()
                           for p in tstate.sr.rewarder.parameters()]
        jstate, jm = jstep(jstate, jbatch)
        tm = tstep(tstate, tbatch)

        for k in ("total_loss", "sup_loss", "unsup_loss"):
            assert_rel_close(tm[k], np.asarray(jm[k]), 1e-5, f"{step} {k}")
        for k in ("util_ratio", "sr_keep_ratio"):
            assert float(tm[k]) == float(jm[k]), (step, k)
        np.testing.assert_array_equal(tstate.algo.selected_label.numpy(),
                                      np.asarray(jstate.algo.selected_label))
        np.testing.assert_array_equal(tstate.algo.classwise_acc.numpy(),
                                      np.asarray(jstate.algo.classwise_acc))

        bound = 2 * CFG["lr"] * (step + 1) + 1e-6
        want, want_ema = _flat(jstate.params), _flat(jstate.ema_params)
        for n, p, e in zip(names, tmodel.parameters(), tstate.ema):
            _check_leaf(n, p.detach().numpy(), want[n], bound)
            _check_leaf(n, e.numpy(), want_ema[n], bound)
        got_conv = dict(tmodel.named_parameters())[conv].detach().numpy()
        assert_rel_close(got_conv, want[conv], 1e-6, f"{step} frozen conv")
        want_r = _flat(jstate.sr.rewarder_params)
        for n, p in tstate.sr.rewarder.named_parameters():
            _check_leaf(n, p.detach().numpy(), want_r[n], bound)
        jmax, tmax = float(jstate.sr.max_reward), float(tstate.sr.max_reward)
        assert (jmax == tmax == -math.inf) or abs(jmax - tmax) < 1e-5
        moved = any(not torch.equal(a, b) for a, b in
                    zip(rewarder_before, tstate.sr.rewarder.parameters()))
        assert moved == (step == 2), step
    # the frozen kernels shrank by AdamW's decay alone: (1 - lr*0.65**3*wd)
    # per step at the schedule's learning rates
    shrink = 1.0 - got_conv / np.where(conv0 == 0, 1.0, conv0)
    assert 5e-4 < float(np.median(shrink)) < 1e-3, float(np.median(shrink))
    assert tstate.step == 3 and int(jstate.step) == 3


def test_cli_trains_the_audio_yaml_on_cpu(tmp_path):
    """``python -m semireward_tpu_torch.train --c <esc50 yaml>`` with the
    small geometry, 0.1 s clips, two steps and an eval, on the CPU, on a
    seeded synthetic ESC-50-layout corpus."""
    from semireward_tpu_torch import train as cli
    from semireward_tpu_torch.data.audio import write_synthetic_corpus

    write_synthetic_corpus(str(tmp_path / "data"), "esc50", num_classes=5,
                           sizes=(("train", 30), ("dev", 6), ("test", 2)))
    argv = ["--c", "config/SemiReward/usb_audio/flexmatch/"
            "flexmatch_esc50_250_0.yaml", "--device", "cpu",
            "--use_pretrain", "False", "--resume", "False",
            "--data_dir", str(tmp_path / "data"), "--num_classes", "5",
            "--num_labels", "10", "--num_train_iter", "2",
            "--num_log_iter", "1", "--start_timing", "1", "--N_k", "1",
            "--max_length_seconds", "0.1", "--eval_batch_size", "4",
            "--feature_dim", "64", "--save_dir", str(tmp_path / "out"),
            "--net_kwargs", json.dumps(GEOM)]
    results = cli.main(argv)
    assert all(math.isfinite(v) for v in results.values())
    assert 0.0 <= results["eval/top-1-acc"] <= 1.0
