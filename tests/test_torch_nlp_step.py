"""The NLP slice as a whole: three SRFlexMatch train steps of the JAX package
(make_train_step) and of the port (core/step.py) on a small BERT
(2 layers, hidden 128, 2 heads, vocab 1000, float32 compute, use_flash on:
the port's K2 through its plain CPU path, forward and backward) from the same
weights on the same token views, ``use_cat`` concatenating the token dicts.
Both sides wrap the net so that it runs at ``train=False``: the two dropout
streams are not matched. start_timing=1 and N_k=1: step 0 is stage 1,
step 1 enters stage 2, step 2 applies the reward filter and trains the
rewarder.

Tolerances as in tests/test_torch_step.py: losses within 1e-5 of their
magnitude; the confidence and reward-filter ratios and FlexMatch state
exact; every parameter within 1e-4 of its leaf's largest magnitude, with at
most 0.1% of a leaf's elements at the Adam bound 2*lr*steps instead (a
near-zero gradient divided by its own magnitude). Exempt from the relative
check are the parameters whose true gradient is zero: each layer's
``attention.key.bias`` (a constant key shift leaves the softmax unchanged)
and the rewarder's ``cross_attention_fc.bias``; both sides step them on
rounding noise, held to the Adam bound.

Also: two steps of ``python -m semireward_tpu_torch.train`` on the aclImdb
YAML, with the small geometry, on the CPU.
"""
import json
import math
import sys
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
from semireward_tpu.models import bert as jbert
from semireward_tpu.registry import ALGORITHMS as JALGS
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.convert import flax_to_torch, load_flax_params
from semireward_tpu_torch.core.step import init_train_state as torch_init
from semireward_tpu_torch.core.step import make_train_step as torch_make_step
from semireward_tpu_torch.models import bert as tbert
from semireward_tpu_torch.ops import attention as A
from semireward_tpu_torch.registry import ALGORITHMS as TALGS

B, NC, L, VOCAB = 4, 3, 32, 1000
GEOM = dict(hidden=128, layers=2, heads=2, intermediate=256, max_position=64)
CFG = dict(algorithm="srflexmatch", net="bert_base_uncased", num_classes=NC,
           batch_size=B, uratio=1, num_train_iter=10, optim="AdamW", lr=0.01,
           layer_decay=0.65, weight_decay=1e-4, ema_m=0.5,
           compute_dtype="float32", start_timing=1, N_k=1, feature_dim=128,
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
    if name.endswith(("attention.key.bias", "cross_attention_fc.bias")):
        assert diff.max() <= lr_bound, name
        return
    far = diff > 1e-4 * np.abs(want).max() + 1e-12
    assert far.mean() <= 1e-3, (name, int(far.sum()), diff.max())
    assert diff.max() <= lr_bound, (name, diff.max())


def _views(rs):
    out = {}
    for k in ("x_lb", "x_ulb_w", "x_ulb_s"):
        lens = rs.randint(3, L + 1, B)
        mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
        out[k] = {"input_ids": rs.randint(100, VOCAB, (B, L)).astype(np.int32)
                  * mask, "attention_mask": mask}
    return out


def test_three_srflexmatch_bert_steps_match_jax():
    jcfg, tcfg = jax_config(**CFG), torch_config(**CFG)
    jalg = JALGS.get("srflexmatch")(jcfg, DATA_INFO)
    jmodel = JaxEvalNet(jbert.ClassificationBert(
        num_classes=NC, vocab_size=VOCAB, dtype=jnp.float32, use_flash=True,
        **GEOM))
    sample = {"input_ids": jnp.zeros((2, L), jnp.int32),
              "attention_mask": jnp.ones((2, L), jnp.int32)}
    txs = []

    def init(rng):   # one compiled program instead of ~160 eager ones
        state, tx = jax_init(jcfg, jalg, jmodel, rng, sample,
                             builder=_layer_decay(jbert._layer_id))
        txs.append(tx)
        return state

    jstate = jax.jit(init)(jax.random.PRNGKey(0))
    jstep = jax.jit(jax_make_step(jcfg, jalg, jmodel, txs[0]))

    talg = TALGS.get("srflexmatch")(tcfg, DATA_INFO, torch.device("cpu"))
    with torch.device("meta"):
        tnet = tbert.ClassificationBert(NC, vocab_size=VOCAB,
                                        dtype=torch.float32, use_flash=True,
                                        **GEOM)
    tmodel = TorchEvalNet(tnet.to_empty(device="cpu"))
    load_flax_params(tmodel, jax.device_get(jstate.params))
    tstate = torch_init(tcfg, talg, tmodel,
                        builder=_layer_decay(tbert.layer_id))
    load_flax_params(tstate.sr.rewarder,
                     jax.device_get(jstate.sr.rewarder_params))
    load_flax_params(tstate.sr.generator, jax.device_get(jstate.sr.gen_params))
    tstep = torch_make_step(tcfg, talg)

    rs = np.random.RandomState(0)
    names = [n for n, _ in tmodel.named_parameters()]
    A.reset_launches()
    for step in range(3):
        views = _views(rs)
        y = rs.randint(0, NC, B)
        idx = rs.choice(DATA_INFO["ulb_dest_len"], B, replace=False)
        jbatch = {**jax.tree_util.tree_map(jnp.asarray, views),
                  "y_lb": jnp.asarray(y),
                  "idx_ulb": jnp.asarray(idx, jnp.int32)}
        tbatch = {**{k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
                     for k, v in views.items()},
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
        want_r = _flat(jstate.sr.rewarder_params)
        for n, p in tstate.sr.rewarder.named_parameters():
            _check_leaf(n, p.detach().numpy(), want_r[n], bound)
        jmax, tmax = float(jstate.sr.max_reward), float(tstate.sr.max_reward)
        assert (jmax == tmax == -math.inf) or abs(jmax - tmax) < 1e-5
        moved = any(not torch.equal(a, b) for a, b in
                    zip(rewarder_before, tstate.sr.rewarder.parameters()))
        assert moved == (step == 2), step
    assert tstate.step == 3 and int(jstate.step) == 3
    assert bool((tstate.algo.selected_label >= 0).any())
    assert A.launches == {"flash_attention_fwd": 0, "flash_attention_bwd": 0}


def test_cli_trains_the_nlp_yaml_on_cpu(tmp_path, monkeypatch):
    """``python -m semireward_tpu_torch.train --c <aclImdb yaml>`` with the
    small geometry, the flash path on, two steps and an eval, on the CPU.
    ``transformers`` is hidden: with no local vocabulary the tokenizer falls
    back to the hash tokenizer either way, and importing it costs seconds."""
    from semireward_tpu_torch import train as cli

    monkeypatch.setitem(sys.modules, "transformers", None)
    root = tmp_path / "data" / "aclImdb"
    root.mkdir(parents=True)
    rs = np.random.RandomState(0)
    for split, count in (("train", 24), ("dev", 10), ("test", 4)):
        d = {}
        for i in range(count):
            y = int(rs.randint(2))
            text = " ".join(f"{'pos' if y else 'neg'}{rs.randint(4)}"
                            if rs.rand() < 0.3 else f"w{rs.randint(50)}"
                            for _ in range(rs.randint(4, 60)))
            d[str(i)] = {"ori": text, "aug_0": text + " a",
                         "aug_1": "b " + text, "label": y}
        (root / f"{split}.json").write_text(json.dumps(d))
    net_kwargs = dict(hidden=64, layers=2, heads=2, intermediate=128)
    argv = ["--c", "config/SemiReward/usb_nlp/flexmatch/"
            "flexmatch_aclImdb_100_0.yaml", "--device", "cpu",
            "--use_pretrain", "False", "--resume", "False",
            "--data_dir", str(tmp_path / "data"), "--num_labels", "8",
            "--num_train_iter", "2", "--num_log_iter", "1",
            "--start_timing", "1", "--N_k", "1", "--max_length", "64",
            "--use_flash_attention", "True", "--use_fused_mlp", "False",
            "--feature_dim", "64", "--save_dir", str(tmp_path / "out"),
            "--net_kwargs", json.dumps(net_kwargs)]
    A.reset_launches()
    results = cli.main(argv)
    assert all(math.isfinite(v) for v in results.values())
    assert 0.0 <= results["eval/top-1-acc"] <= 1.0
    assert A.launches == {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
