"""The run's lifecycle in the port: checkpoint / resume, the eval CLI, the
metrics sink and the prefetch thread, held against the JAX package.

- Round trip: a Trainer trains 3 steps (stage 2 from step 2, its batches
  through the prefetch thread) and writes ``latest_model.ckpt``; a second
  Trainer resumes from it through the CLI's ``build_trainer``. Every
  tensor of the state is bit-equal (parameters, BatchNorm buffers, EMA,
  optimizer moments and counts, the algorithm and SemiReward state, the
  generator), and so is the state after one more step of each on the same
  raw batch. srflexmatch, srfreematch and
  srsoftmatch on a 2-block ViT; srfixmatch on a WRN-10-1 with BatchNorm.
- A JAX checkpoint through the port's eval CLI: the JAX Trainer trains 2
  steps of SRFlexMatch on WRN-28-2 (float32) and writes
  ``model_best.ckpt``; its parameters, EMA and ``batch_stats`` go through
  ``convert.py`` into the port's names and the port's ``save_checkpoint``.
  ``semireward_tpu_torch.eval.main`` on that file against the JAX
  ``eval.py:main`` on the JAX file, both at float32 compute: top-1 equal,
  loss within 1e-4 of JAX's. (The CLIs' default is bfloat16, where XLA's
  and oneDNN's convolutions round apart: 15.3097 against 15.3243 on this
  checkpoint's loss, the same top-1.)
- The port's run of the same configuration: its ``metrics.jsonl`` has the
  JAX run's key set on every line, and after a resume its first batch is
  the JAX trainer's ``_make_loader()`` first batch, bit for bit.
- A leaf of another name, shape or dtype refuses to load, naming the leaf,
  and leaves the live state as it was; the CLI then starts fresh.
- ``PrefetchLoader`` (the port's copy and the JAX package's): FIFO order,
  a producer error re-raised on the consumer, ``close()`` stops the
  producer.
"""
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.convert import flax_to_torch
from semireward_tpu_torch.core import checkpoint as tckpt

NC = 4
VIT = dict(net="vit_small_patch2_32", img_size=16, feature_dim=32,
           optim="AdamW", lr=5e-4, layer_decay=0.5,
           net_kwargs=dict(depth=2, embed_dim=32, num_heads=2, patch_size=4))
WRN = dict(net="wrn_28_2", img_size=16, optim="SGD", lr=0.03, uratio=2,
           compute_dtype="float32", net_kwargs=dict(depth=10,
                                                    widen_factor=1))
CASES = {"srflexmatch": VIT, "srfreematch": VIT, "srsoftmatch": VIT,
         "srfixmatch": WRN}


def _cfg(algorithm, save_dir, **kw):
    base = dict(algorithm=algorithm, dataset="synthetic", num_classes=NC,
                num_labels=8, batch_size=4, eval_batch_size=8,
                num_train_iter=8, num_eval_iter=3, num_log_iter=1,
                start_timing=1, N_k=1, ema_m=0.9, synthetic_train=64,
                synthetic_test=16, save_dir=str(save_dir), seed=3,
                prefetch_depth=2)
    base.update(CASES[algorithm])
    base.update(kw)
    return torch_config(**base)


def _assert_states_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("algorithm", sorted(CASES))
def test_resume_restores_every_tensor_and_the_next_step(tmp_path, algorithm):
    from semireward_tpu_torch.core.trainer import Trainer
    from semireward_tpu_torch.train import build_trainer

    a = Trainer(_cfg(algorithm, tmp_path / "a"), device="cpu")
    a.train(num_iters=3)
    latest = tmp_path / "a" / "run" / tckpt.LATEST
    assert latest.exists() and (tmp_path / "a" / "run" / tckpt.BEST).exists()
    assert a.ckpt_writes and all(w["bytes"] > 0 for w in a.ckpt_writes)
    assert tckpt.peek_extra(str(latest))["it"] == 3
    b = build_trainer(_cfg(algorithm, tmp_path / "b", resume=True,
                           load_path=str(latest)), device="cpu")
    assert b.state.step == 3 and b.state.opt.count == 3
    assert (b.best_metric, b.best_it) == (a.best_metric, a.best_it)
    _assert_states_equal(a.state, b.state)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    sd = a.state.state_dict()
    assert {"step", "rng", "sr.max_reward"} <= set(sd)
    assert any(k.startswith("sr.rewarder_opt.mu.") for k in sd)
    if algorithm == "srfixmatch":  # stateless base; BatchNorm; SGD
        assert any(k.endswith("running_var") for k in sd)
        assert any(k.startswith("opt.trace.") for k in sd)
    else:
        assert any(k.startswith("algo.") for k in sd)
    raw = next(a._make_loader())
    for tr in (a, b):
        tr._step(tr.state, tr.make_batch(raw), tr.generator)
    _assert_states_equal(a.state, b.state)


def _jax_cfg(save_dir):
    from semireward_tpu.config import get_config as jax_config

    cfg = jax_config(dict(
        algorithm="srflexmatch", net="wrn_28_2", dataset="synthetic",
        num_classes=NC, num_labels=8, batch_size=4, uratio=1,
        eval_batch_size=16, img_size=32, num_train_iter=2, num_eval_iter=2,
        num_log_iter=1, start_timing=1, N_k=1, feature_dim=128, seed=1,
        optim="SGD", lr=0.03, compute_dtype="float32",
        save_dir=str(save_dir), mesh_shape=(1,)))
    cfg.extra["synthetic_train"] = 64
    cfg.extra["synthetic_test"] = 32
    cfg.extra["prefetch_depth"] = 0
    return cfg


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer's 2-step SRFlexMatch WRN-28-2 run: its save
    directory and its first train batch."""
    from semireward_tpu.core.trainer import Trainer as JTrainer

    out = tmp_path_factory.mktemp("jax_run")
    jt = JTrainer(_jax_cfg(out), use_mesh=False)
    first = next(jt._make_loader())
    jt.train()
    jt.sink.close()
    return os.path.join(str(out), "run"), first


def _port_cfg_of(jax_dir, save_dir, **kw):
    d = dict(algorithm="srflexmatch", net="wrn_28_2", dataset="synthetic",
             num_classes=NC, num_labels=8, batch_size=4, uratio=1,
             eval_batch_size=16, img_size=32, num_train_iter=2,
             num_eval_iter=2, num_log_iter=1, start_timing=1, N_k=1,
             feature_dim=128, seed=1, optim="SGD", lr=0.03,
             compute_dtype="float32", synthetic_train=64, synthetic_test=32,
             save_dir=str(save_dir))
    d.update(kw)
    return torch_config(**d)


def _float32_config(module, monkeypatch):
    """The eval CLI's ``get_config`` with float32 compute."""
    get = module.get_config
    monkeypatch.setattr(module, "get_config", lambda d=None, **kw: get(
        dict(d or {}, compute_dtype="float32"), **kw))


def test_jax_checkpoint_scores_the_same_through_the_port_eval(
        tmp_path, jax_run, monkeypatch):
    import pickle

    import eval as jax_eval
    import semireward_tpu.config as jax_config_lib
    import semireward_tpu_torch.config as port_config_lib
    from semireward_tpu_torch import eval as port_eval

    _float32_config(jax_config_lib, monkeypatch)
    _float32_config(port_config_lib, monkeypatch)

    jax_dir, _ = jax_run
    jbest = os.path.join(jax_dir, "model_best.ckpt")
    with open(jbest, "rb") as f:
        js = pickle.load(f)["state"]
    leaves = {}
    for group, tree in (("model.", js.params), ("ema.", js.ema_params)):
        leaves.update({group + n: torch.from_numpy(np.array(v))
                       for n, v in flax_to_torch(tree).items()})
    leaves.update({"model." + n: torch.from_numpy(np.array(v))
                   for n, v in flax_to_torch(js.batch_stats,
                                             stats=True).items()})
    pbest = str(tmp_path / "from_jax.ckpt")
    tckpt.save_checkpoint(pbest, leaves, {"it": int(js.step)})
    args = ["--dataset", "synthetic", "--net", "wrn_28_2", "--num_classes",
            str(NC), "--img_size", "32", "--batch_size", "32"]
    want = jax_eval.main(["--load_path", jbest] + args)
    got = port_eval.main(["--load_path", pbest, "--device", "cpu"] + args)
    assert got["top-1-acc"] == want["top-1-acc"]
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
    assert sorted(got) == sorted(want)


def test_port_run_logs_the_jax_keys_and_resumes_on_the_jax_stream(
        tmp_path, jax_run):
    from semireward_tpu_torch.core.trainer import Trainer
    from semireward_tpu_torch.train import build_trainer

    jax_dir, jax_first = jax_run
    a = Trainer(_port_cfg_of(jax_dir, tmp_path / "a"), device="cpu")
    a.train()

    def keys(path):
        with open(path) as f:
            return [sorted(json.loads(line)) for line in f]

    assert keys(tmp_path / "a" / "run" / "metrics.jsonl") == keys(
        os.path.join(jax_dir, "metrics.jsonl"))
    latest = str(tmp_path / "a" / "run" / tckpt.LATEST)
    b = build_trainer(_port_cfg_of(jax_dir, tmp_path / "b", resume=True,
                                   load_path=latest, num_train_iter=3),
                      device="cpu")
    assert b.state.step == 2
    seen = []
    make_batch = b.make_batch
    b.make_batch = lambda raw: seen.append(raw) or make_batch(raw)
    b.train()
    assert b.state.step == 3 and len(seen) == 1
    for k in ("idx_lb", "idx_ulb", "y_lb", "x_lb", "x_ulb"):
        np.testing.assert_array_equal(seen[0][k], np.asarray(jax_first[k]))


def test_mismatched_leaves_refuse_to_load_and_name_the_leaf(tmp_path):
    from semireward_tpu_torch.core.trainer import Trainer
    from semireward_tpu_torch.train import build_trainer

    tr = Trainer(_cfg("srflexmatch", tmp_path), device="cpu")
    tr.save(str(tmp_path / "good.ckpt"))
    assert tr.load(str(tmp_path / "good.ckpt"))["it"] == 0
    good = {k: v.clone() for k, v in tr.state.state_dict().items()}
    name = "model.blocks.0.attn.qkv.weight"
    bad_shape = dict(good, **{name: good[name][:-1]})
    bad_dtype = dict(good, **{name: good[name].double()})
    renamed = dict(good)
    renamed["model.blocks.0.attn.qkv.w"] = renamed.pop(name)
    for bad, why in ((bad_shape, "shape"), (bad_dtype, "dtype"),
                     (renamed, "missing")):
        bad["step"] = torch.tensor(7)
        path = str(tmp_path / f"{why}.ckpt")
        tckpt.save_checkpoint(path, bad)
        with pytest.raises(ValueError, match=name.replace(".", r"\.")):
            tr.load(path)
        assert tr.state.step == 0  # nothing was written
    extra = dict(good, **{"algo.extra_leaf": torch.zeros(1)})
    tckpt.save_checkpoint(str(tmp_path / "extra.ckpt"), extra)
    with pytest.raises(ValueError, match="algo.extra_leaf"):
        tr.load(str(tmp_path / "extra.ckpt"))
    _assert_states_equal(tr.state, Trainer(_cfg("srflexmatch", tmp_path),
                                           device="cpu").state)
    # the CLI warns and starts fresh on a file that does not load
    (tmp_path / "empty.ckpt").write_bytes(b"")
    fresh = build_trainer(_cfg("srflexmatch", tmp_path, resume=True,
                               load_path=str(tmp_path / "empty.ckpt")),
                          device="cpu")
    assert fresh.state.step == 0


def _prefetch_classes():
    from semireward_tpu.data.loader import PrefetchLoader as JaxPrefetch
    from semireward_tpu_torch.data.loader import PrefetchLoader

    return {"port": PrefetchLoader, "jax": JaxPrefetch}


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_prefetch_keeps_order_reraises_and_closes(impl):
    cls = _prefetch_classes()[impl]
    pf = cls(iter(range(50)), depth=3)
    assert [next(pf) for _ in range(50)] == list(range(50))
    with pytest.raises(StopIteration):
        next(pf)

    def failing():
        yield 1
        raise RuntimeError("gather failed")

    pf = cls(failing(), depth=2)
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="gather failed"):
        next(pf)

    made = []

    def endless():
        i = 0
        while True:
            made.append(i)
            yield i
            i += 1

    pf = cls(endless(), depth=2)
    assert next(pf) == 0
    pf.close()
    pf._thr.join(timeout=5)
    assert not pf._thr.is_alive()
    n = len(made)
    time.sleep(0.3)
    assert len(made) == n


def test_prefetch_close_waits_for_the_batch_in_hand():
    """The port's ``close`` returns once the producer has finished the
    batch it was assembling (a JPEG set's decode on the card runs there),
    so no producer outlives the train loop."""
    from semireward_tpu_torch.data.loader import PrefetchLoader

    def slow():
        i = 0
        while True:
            time.sleep(0.2)
            yield i
            i += 1

    pf = PrefetchLoader(slow(), depth=1)
    assert next(pf) == 0
    pf.close()
    assert not pf._thr.is_alive()
