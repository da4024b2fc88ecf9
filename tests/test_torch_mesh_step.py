"""The port's sharded step (``core/step.py`` on a ``parallel/mesh.py``
mesh) across 4 gloo ranks on the CPU, against the JAX package's mesh step
(``make_train_step`` jitted with its state and batch shardings on 4 of its
8 CPU devices) and against the port's own one-process step on the whole
batch, from the same weights on the same injected views (no drop path, no
dropout: no draws), 3 steps each:

- FixMatch and SRFlexMatch (stage 1, then the reward filter and the
  rewarder's training) on a narrow 2-block ViT: data-parallel on 4 ranks,
  FSDP on (2, 2) data x fsdp (every leaf of at least 1,024 elements
  sharded, JAX's ``fsdp_state_sharding`` at that ``min_size``), Megatron TP
  with ``split_qkv`` on (2, 2) data x model. The port runs the K4 forms
  (the fused MLP and flash attention on, their plain versions on the CPU),
  JAX its plain einsum attention and two-dense MLP (the same f32 function:
  both GELUs are the exact erf). SGD with momentum and layer decay, so a
  gradient error shows in the parameters in proportion (AdamW's first
  steps divide near-zero gradients by themselves).
- Held: parameters and EMA at ``test_sharding.py``'s rtol 5e-4 / atol
  5e-5; losses within 1e-5 of their magnitude; the confidence and reward
  ratios (``util_ratio``, ``sr_keep_ratio``), ``selected_label`` and
  ``classwise_acc`` bit-equal, and the same on every rank; the rewarder,
  trained by Adam on the gathered batch, as ``test_torch_step.py`` holds
  it (1e-4 of each leaf, the shift-invariant ``cross_attention_fc.bias``
  and at most 0.1% of a leaf's elements at the Adam bound 2 * lr * steps).
- One WRN FixMatch data-parallel step: the BatchNorm running statistics
  (global moments) against JAX's at rtol 5e-4 / atol 1e-6.
- FSDP's memory: each rank holds half the bytes of every leaf JAX's rule
  shards, for the parameters, the EMA and both AdamW moments.
- A rank-0 checkpoint holds the one-process checkpoint's keys, the whole
  values, and reads back into the sharded state bit for bit.

One spawn of 4 ranks runs every case (``_torch_mesh_ranks.step_cases``;
rank 0 then runs each on the whole batch alone) while this process
compiles and runs the JAX steps; it fails within its limit rather than
hang.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_dist import Ranks
import _torch_mesh_ranks as R
from semireward_tpu.config import get_config as jax_config
from semireward_tpu.core.step import init_train_state as jax_init
from semireward_tpu.core.step import make_train_step as jax_make_step
from semireward_tpu.models import vit as jvit
from semireward_tpu.models import wrn as jwrn
from semireward_tpu.parallel import mesh as jmesh
from semireward_tpu.registry import ALGORITHMS as JALGS
from semireward_tpu_torch.convert import flax_to_torch

B, NC, S, EMB, MIN_SIZE = 8, 4, 16, 32, 1024
ARCH = dict(depth=2, embed_dim=EMB, num_heads=2, img_size=S, patch_size=4,
            drop_path_rate=0.0)
CFG = dict(net="vit_small_patch2_32", num_classes=NC, batch_size=B, uratio=1,
           num_train_iter=10, optim="SGD", lr=0.03, momentum=0.9,
           layer_decay=0.5, weight_decay=5e-4, ema_m=0.5, img_size=S,
           compute_dtype="float32", start_timing=1, N_k=1, feature_dim=EMB,
           sr_ema=False, sr_lr=0.01, p_cutoff=0.5)
DATA_INFO = {"ulb_dest_len": 24, "lb_dest_len": 16}
LAYOUTS = {"dp": ((4,), ("data",)), "fsdp": ((2, 2), ("data", "fsdp")),
           "tp": ((2, 2), ("data", "model"))}
ALGOS = ("fixmatch", "srflexmatch")
WRN_ARCH = dict(depth=10, widen_factor=1)
WRN_CFG = dict(CFG, net="wrn_28_2", algorithm="fixmatch", img_size=S,
               feature_dim=64, layer_decay=1.0, p_cutoff=0.0)


def _flat(tree):
    return flax_to_torch(jax.tree_util.tree_map(np.asarray, tree))


def _perturb(tree, scale):
    return jax.tree_util.tree_map(
        lambda p: p + scale * jnp.asarray(
            np.random.RandomState(p.size % 9973).randn(*p.shape), p.dtype),
        tree)


def _batches(seed, views=("x_lb", "x_ulb_w", "x_ulb_s"), n=3):
    rs = np.random.RandomState(seed)
    return [{**{k: rs.randn(B, S, S, 3).astype(np.float32) for k in views},
             "y_lb": rs.randint(0, NC, B).astype(np.int64),
             "idx_ulb": rs.choice(DATA_INFO["ulb_dest_len"], B,
                                  replace=False).astype(np.int64)}
            for _ in range(n)]


_INITS = {}


def _jax_init_state(name, split, cfg, net):
    """The JAX config, algorithm, model, perturbed state and optimizer of a
    case; one init serves every layout that shares them (``_INITS``)."""
    key = (name, split, net, cfg["optim"])
    if key in _INITS:
        return _INITS[key]
    jcfg = jax_config(**dict(cfg, algorithm=name))
    jalg = JALGS.get(name)(jcfg, DATA_INFO)
    if net == "vit":
        builder = jvit.vit_small_patch2_32
        jmodel = builder(num_classes=NC, dtype=jnp.float32, split_qkv=split,
                         **ARCH)
    else:
        builder = jwrn.wrn_28_2
        jmodel = builder(num_classes=NC, dtype=jnp.float32, **WRN_ARCH)
    made = {}

    def init(key):
        # one compiled program: far quicker than the init's eager ops
        state, made["tx"] = jax_init(jcfg, jalg, jmodel, key,
                                     jnp.zeros((2, S, S, 3)), builder=builder)
        return state

    jstate = jax.jit(init)(jax.random.PRNGKey(0))
    params = _perturb(jstate.params, 0.02)
    jstate = jstate.replace(params=params, ema_params=params)
    _INITS[key] = (jcfg, jalg, jmodel, jstate, made["tx"])
    return _INITS[key]


def _jax_setup(name, layout, cfg=CFG, net="vit"):
    """The JAX state on its mesh layout, its jitted mesh step and the
    port's case."""
    jcfg, jalg, jmodel, jstate, tx = _jax_init_state(name, layout == "tp",
                                                     cfg, net)
    params = jstate.params
    arch = (dict(ARCH, split_qkv=layout == "tp", use_fused_mlp=True,
                 use_flash=True) if net == "vit" else dict(WRN_ARCH))
    shape, axes = LAYOUTS[layout]
    mesh = jmesh.build_mesh(shape, axes, devices=jax.devices()[:4])
    rep = NamedSharding(mesh, P())
    if layout == "tp":
        state_sh = jmesh.tp_state_sharding(mesh, jstate)
    elif layout == "fsdp":
        state_sh = jmesh.fsdp_state_sharding(mesh, jstate, min_size=MIN_SIZE)
    else:
        state_sh = jax.tree_util.tree_map(lambda _: rep, jstate)
    dat = NamedSharding(mesh, P("data"))
    jstate = jax.device_put(jstate, state_sh)
    step = jax.jit(jax_make_step(jcfg, jalg, jmodel, tx),
                   in_shardings=(state_sh, dat), out_shardings=(state_sh, rep))
    weights = _flat(params)
    weights.update({k: np.asarray(v) for k, v in
                    flax_to_torch(jax.tree_util.tree_map(
                        np.asarray, jstate.batch_stats), stats=True).items()}
                   if jstate.batch_stats else {})
    case = dict(algorithm=name, cfg=dict(cfg, algorithm=name), net=net,
                arch=arch, weights=weights, data_info=DATA_INFO,
                mesh_shape=shape, mesh_axes=axes, fsdp_min_size=MIN_SIZE)
    if jstate.sr is not None:
        case["rewarder"] = _flat(jstate.sr.rewarder_params)
        case["generator"] = _flat(jstate.sr.gen_params)
    return jstate, step, dat, case


def _jax_run(jstate, step, dat, batches):
    out = []
    for b in batches:
        jstate, m = step(jstate, {k: jax.device_put(jnp.asarray(v), dat)
                                  for k, v in b.items()})
        out.append({"metrics": {k: float(v) for k, v in m.items()
                                if np.ndim(v) == 0},
                    "params": _flat(jstate.params),
                    "ema": _flat(jstate.ema_params),
                    "stats": (flax_to_torch(jax.tree_util.tree_map(
                        np.asarray, jstate.batch_stats), stats=True)
                        if jstate.batch_stats else {}),
                    "algo": jax.tree_util.tree_map(np.asarray, jstate.algo),
                    "rewarder": (_flat(jstate.sr.rewarder_params)
                                 if jstate.sr is not None else {})})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the 4 ranks' records, the port's one-process records
    (run on rank 0 after its mesh cases) and JAX's mesh-step records (run
    here meanwhile, on 4 threads: XLA compiles without the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    ckpt_path = str(tmp_path_factory.mktemp("mesh_ckpt") / "fsdp.ckpt")
    jobs = {(layout, name): (name, layout, CFG, "vit", _batches(i), 3)
            for layout in LAYOUTS for i, name in enumerate(ALGOS)}
    # the WRN's BatchNorm moments
    jobs["wrn"] = ("fixmatch", "dp", WRN_CFG, "wrn", _batches(9, n=1), 1)
    with ThreadPoolExecutor(4) as pool:
        # each distinct init once, then the layouts that share it
        inits = {(j[0], j[1] == "tp", j[3], j[2]["optim"]): j
                 for j in jobs.values()}
        list(pool.map(lambda j: _jax_init_state(j[0], j[1] == "tp", j[2],
                                                j[3]), inits.values()))
        setups = dict(zip(jobs, pool.map(lambda j: _jax_setup(*j[:4]),
                                         jobs.values())))
    cases = []
    for key, (*_, batches, steps) in jobs.items():
        case = setups[key][3]
        case.update(batches=batches, steps=steps)
        if key == ("fsdp", "srflexmatch"):
            case["save_to"] = ckpt_path
        cases.append(case)
    # FSDP's bytes under AdamW: the fsdp FixMatch case's state, no step
    adam = dict(setups["fsdp", "fixmatch"][3], steps=0)
    adam["cfg"] = dict(adam["cfg"], optim="AdamW", lr=1e-3)
    ranks = Ranks(R.step_cases, 4, cases + [adam], timeout=150)
    with ThreadPoolExecutor(4) as pool:
        jax_out = dict(zip(jobs, pool.map(
            lambda k: _jax_run(*setups[k][:3], jobs[k][4][:jobs[k][5]]),
            jobs)))
    got = ranks.result()
    out = {k: {"ranks": [r["mesh"][i] for r in got], "one": got[0]["one"][i],
               "jax": jax_out[k]} for i, k in enumerate(jobs)}
    out["adam"] = {"ranks": [r["mesh"][-1] for r in got]}
    return out, ckpt_path


def _close(got, want, what, rtol=5e-4, atol=5e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _check_rewarder(name, got, want, bound):
    """``test_torch_step.py``'s rule for Adam-trained leaves."""
    diff = np.abs(got - want)
    if name == "cross_attention_fc.bias":
        assert diff.max() <= bound, name
        return
    far = diff > 1e-4 * np.abs(want).max() + 1e-12
    assert far.sum() <= 1e-3 * far.size, (name, int(far.sum()), diff.max())
    assert diff.max() <= bound, (name, diff.max())


def _state(rec, prefix):
    return {k[len(prefix):]: v for k, v in rec["state"].items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", ALGOS)
def test_three_mesh_steps_match_jax_and_one_process(runs, layout, name):
    run = runs[0][layout, name]
    ranks, one, jax_recs = run["ranks"], run["one"], run["jax"]
    selected = []
    for step, jrec in enumerate(jax_recs):
        recs = [r["steps"][step] for r in ranks]
        mine, ref = recs[0], one["steps"][step]
        # every rank holds the same whole state (gathered) and metrics
        for other in recs[1:]:
            assert other["metrics"] == mine["metrics"], step
            for k, v in mine["state"].items():
                np.testing.assert_array_equal(other["state"][k], v, k)
        for against, what in ((jrec, "jax"), (ref, "one process")):
            m = against["metrics"]
            for k in ("total_loss", "sup_loss", "unsup_loss"):
                _close(mine["metrics"][k], m[k], f"{what} {step} {k}",
                       rtol=0, atol=1e-5 * abs(m[k]) + 1e-7)
            for k in ("util_ratio", "sr_keep_ratio"):
                if k in m:
                    assert mine["metrics"][k] == m[k], (what, step, k)
        for group, key in (("model.", "params"), ("ema.", "ema")):
            got = _state(mine, group)
            for n, want in jrec[key].items():
                _close(got[n], want, f"jax {step} {group}{n}")
            for n, want in _state(ref, group).items():
                _close(got[n], want, f"one process {step} {group}{n}")
        if name == "srflexmatch":
            algo = _state(mine, "algo.")
            for k in ("selected_label", "classwise_acc"):
                want = getattr(jrec["algo"], k)
                np.testing.assert_array_equal(algo[k], want, k)
                np.testing.assert_array_equal(algo[k], _state(ref, "algo.")[k])
            selected.append(bool((algo["selected_label"] >= 0).any()))
            bound = 2 * CFG["sr_lr"] * (step + 1) + 1e-6
            rew = _state(mine, "sr.rewarder.")
            for n, want in jrec["rewarder"].items():
                _check_rewarder(n, rew[n], want, bound)
            for n, want in _state(ref, "sr.rewarder.").items():
                _check_rewarder(n, rew[n], want, bound)
    if name == "srflexmatch":
        assert any(selected)
        assert jax_recs[-1]["metrics"]["sr_keep_ratio"] < 1.0


def test_wrn_batchnorm_moments_are_global(runs):
    run = runs[0]["wrn"]
    mine, jrec = run["ranks"][0]["steps"][0], run["jax"][0]
    stats = {k: v for k, v in _state(mine, "model.").items()
             if k.endswith(("running_mean", "running_var"))}
    assert stats and set(stats) == set(jrec["stats"])
    for n, want in jrec["stats"].items():
        _close(stats[n], want, n, rtol=5e-4, atol=1e-6)
    for n, want in jrec["params"].items():
        _close(_state(mine, "model.")[n], want, n)


def test_fsdp_holds_half_of_every_sharded_leaf(runs):
    """Per rank: half the bytes of every leaf JAX's rule shards over the
    2-way fsdp axis, for the parameters, the EMA and both AdamW moments;
    the whole of every other leaf."""
    from semireward_tpu.parallel.mesh import fsdp_param_sharding
    from semireward_tpu_torch.convert import torch_name
    run = runs[0]["adam"]
    mesh = jmesh.build_mesh((2, 2), ("data", "fsdp"),
                            devices=jax.devices()[:4])
    jstate = _jax_init_state("fixmatch", False, CFG, "vit")[3]
    specs = fsdp_param_sharding(mesh, jstate.params, min_size=MIN_SIZE)
    sharded = {torch_name(tuple(getattr(p, "key", p) for p in path))
               for path, s in jax.tree_util.tree_flatten_with_path(
                   specs, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
               if "fsdp" in tuple(s.spec)}
    assert sharded
    full = run["ranks"][0]["full_bytes"]
    for r in run["ranks"]:
        for kind in ("model", "ema", "mu", "nu"):
            held = r["bytes"][kind]
            for n, nbytes in held.items():
                want = full[n] // 2 if n in sharded else full[n]
                assert nbytes == want, (kind, n, nbytes, full[n])
    total = sum(full.values())
    mine = sum(run["ranks"][0]["bytes"]["model"].values())
    assert mine < 0.75 * total


def test_rank0_checkpoint_is_the_whole_state(runs):
    from semireward_tpu_torch.core.checkpoint import read_payload
    res, path = runs
    run = res["fsdp", "srflexmatch"]
    payload = read_payload(path)["state"]
    last = run["ranks"][0]["steps"][-1]["state"]
    one = run["one"]["steps"][-1]["state"]
    assert set(payload) - {"rng"} == set(one) == set(last)
    for k, v in payload.items():
        if k == "rng":
            continue
        np.testing.assert_array_equal(v.numpy(), last[k], k)
        if v.dtype.is_floating_point and k.startswith(("model.", "ema.")):
            _close(v.numpy(), one[k], k)
        elif not v.dtype.is_floating_point:
            np.testing.assert_array_equal(v.numpy(), one[k], k)
    assert all(r["resumed_equal"] for r in run["ranks"])
    assert isinstance(payload["model.head.weight"], torch.Tensor)
