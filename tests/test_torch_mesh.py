"""The mesh layer of the port (``parallel/mesh.py``) against the JAX
package's ``parallel/mesh.py``, and the pieces around it:

- ``build_mesh``: the ``-1`` resolution and JAX's assertion, case for case
  (a YAML mesh the ranks do not fit fails in both, one rank included; the
  Trainer on an ``imagenet_stretch`` YAML's ``(-1, 4)`` raises JAX's
  message);
- the FSDP leaf rule and the Megatron TP rule (with the ``fsdp`` extra
  axis): the spec of every leaf of a narrow ViT (fused and ``split_qkv``),
  BERT and HuBERT equals JAX's ``fsdp_param_sharding`` /
  ``tp_param_sharding``, leaf for leaf, over the flax dims;
- ``load_vit_checkpoint``'s ``split_qkv`` branch equals JAX's graft bit for
  bit;
- the NLP loader on each of W ranks gives JAX's batches (its rank-strided
  rows and views, and the global batch's bucket on every rank);
- an algorithm or imb wrapper outside the slice's scope raises when it is
  built on a mesh of more than one rank, naming itself and its ROADMAP
  item; the ones in scope build;
- two gloo ranks train a tiny YAML through the ``Trainer`` (the torchrun
  path): each rank takes half the batch, both log the same losses and
  evaluate the same metrics, rank 0 alone writes the checkpoints, and the
  file reads back into a one-process trainer.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from _torch_dist import Ranks
import _torch_mesh_ranks as R
from semireward_tpu.config import get_config as jax_config
from semireward_tpu.data import modality as jmod
from semireward_tpu.data import nlp as jnlp
from semireward_tpu.models import bert as jbert
from semireward_tpu.models import hubert as jhubert
from semireward_tpu.models import utils as jutils
from semireward_tpu.models import vit as jvit
from semireward_tpu.parallel import mesh as jmesh
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.convert import flax_to_torch, torch_name
from semireward_tpu_torch.data import modality as tmod
from semireward_tpu_torch.data import nlp as tnlp
from semireward_tpu_torch.models import bert as tbert
from semireward_tpu_torch.models import hubert as thubert
from semireward_tpu_torch.models import utils as tutils
from semireward_tpu_torch.models import vit as tvit
from semireward_tpu_torch.parallel import mesh as mesh_lib
from semireward_tpu_torch.registry import ALGORITHMS

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape,axes,n", [
    ((-1,), ("data",), 1), ((-1,), ("data",), 4), ((-1, 4), ("data", "fsdp"), 8),
    ((-1, 4), ("data", "fsdp"), 4), ((-1, 4), ("data", "fsdp"), 1),
    ((-1, 4), ("data", "fsdp"), 6), ((2, -1), ("data", "model"), 8),
    ((3,), ("data",), 4), ((2, 2), ("data", "fsdp"), 8),
    ((2, 2, -1), ("data", "fsdp", "model"), 8)])
def test_mesh_resolution_and_assertion_match_jax(shape, axes, n):
    try:
        want = dict(jmesh.build_mesh(shape, axes,
                                     devices=jax.devices()[:n]).shape)
    except AssertionError as e:
        with pytest.raises(AssertionError) as got:
            mesh_lib.build_mesh(shape, axes, world=n)
        assert str(got.value) == str(e)
        return
    mesh = mesh_lib.build_mesh(shape, axes, world=n)
    assert mesh.shape == want
    assert mesh.batch_axes == tuple(a for a in ("data", "fsdp") if a in axes)


def test_a_yaml_mesh_one_rank_does_not_fit_fails_as_jax(tmp_path):
    from semireward_tpu_torch import config as config_lib
    from semireward_tpu_torch.core.trainer import Trainer
    path = os.path.join(HERE, "config/SemiReward/imagenet_stretch/flexmatch/"
                        "flexmatch_imagenet_100000_0.yaml")
    cfg = config_lib.from_yaml(path, {"save_dir": str(tmp_path),
                                      "data_dir": str(tmp_path)})
    assert tuple(cfg.mesh_shape) == (-1, 4)
    with pytest.raises(AssertionError) as want:
        jmesh.build_mesh(cfg.mesh_shape, cfg.mesh_axes,
                         devices=jax.devices()[:1])
    with pytest.raises(AssertionError) as got:
        Trainer(cfg, device="cpu")
    assert str(got.value) == str(want.value) == "mesh shape [0, 4] != 1 devices"


NC = 4
VIT = dict(depth=2, embed_dim=64, num_heads=4, img_size=16, patch_size=4,
           drop_path_rate=0.0)
BERT = dict(hidden=64, layers=1, heads=4, intermediate=256, max_position=64)
HUBERT = dict(hidden=64, layers=1, heads=4)


def _nets(name):
    """(JAX param shapes, the port's model) of one narrow net."""
    if name.startswith("vit"):
        split = name == "vit_split"
        jm = jvit.vit_small_patch2_32(num_classes=NC, split_qkv=split, **VIT)
        sample = jnp.zeros((1, 16, 16, 3))
        tm = tvit.vit_small_patch2_32(num_classes=NC, split_qkv=split, **VIT)
    elif name == "bert":
        jm = jbert.bert_base_uncased(num_classes=NC, **BERT)
        sample = {"input_ids": jnp.zeros((1, 8), jnp.int32),
                  "attention_mask": jnp.ones((1, 8), jnp.int32)}
        tm = tbert.bert_base_uncased(num_classes=NC, **BERT)
    else:
        jm = jhubert.hubert_base(NC, **HUBERT)
        sample = jnp.zeros((1, 800))
        tm = thubert.hubert_base(NC, **HUBERT)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), sample,
                                            train=False))["params"]
    return shapes, tm


def _jax_specs(specs):
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, NamedSharding))[0]:
        out[torch_name(tuple(getattr(p, "key", p) for p in path))] = s.spec
    return out


@pytest.mark.parametrize("net", ["vit", "vit_split", "bert", "hubert"])
@pytest.mark.parametrize("kind", ["fsdp", "tp", "tp_fsdp"])
def test_layout_rules_equal_jax_leaf_for_leaf(net, kind):
    shapes, tm = _nets(net)
    shape, axes = {"fsdp": ((2, 4), ("data", "fsdp")),
                   "tp": ((4, 2), ("data", "model")),
                   "tp_fsdp": ((2, 2, 2), ("data", "fsdp", "model"))}[kind]
    jm = jmesh.build_mesh(shape, axes)
    if kind == "fsdp":
        want = _jax_specs(jmesh.fsdp_param_sharding(jm, shapes,
                                                    min_size=2048))
    else:
        want = _jax_specs(jmesh.tp_param_sharding(
            jm, shapes, extra_axis="fsdp" if kind == "tp_fsdp" else None))
    mesh = mesh_lib.Mesh(shape, axes, groups=False)
    specs = mesh_lib.param_specs(mesh, tm, min_size=2048)
    assert sorted(specs) == sorted(want)
    split = 0
    for name, spec in want.items():
        p = tm.get_parameter(name)
        padded = tuple(spec) + (None,) * (p.ndim - len(spec))
        assert mesh_lib.flax_spec(specs[name], tm, name) == padded, name
        split += any(padded)
    assert split > 0


def test_split_qkv_graft_equals_jax(tmp_path):
    rs = np.random.RandomState(0)
    jm = jvit.vit_small_patch2_32(num_classes=NC, split_qkv=True, **VIT)
    params = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 16, 16, 3)),
                                       train=False))(
        jax.random.PRNGKey(0))["params"]
    fused = tvit.vit_small_patch2_32(num_classes=NC, **VIT)
    sd = {k.replace("patch_embed.", "patch_embed.proj."):
          torch.from_numpy(rs.randn(*v.shape).astype(np.float32))
          for k, v in fused.state_dict().items()}
    path = str(tmp_path / "vit.pth")
    torch.save(sd, path)
    want = flax_to_torch(jax.tree_util.tree_map(
        np.asarray, jutils.load_vit_checkpoint(params, path)))
    # the port starts from JAX's init (the head is not grafted)
    start = flax_to_torch(jax.tree_util.tree_map(np.asarray, params))
    got = tutils.load_vit_checkpoint({n: torch.from_numpy(np.array(v))
                                      for n, v in start.items()}, path)
    assert sorted(got) == sorted(want)
    assert any(n.endswith("attn.q.weight") for n in got)
    for n, v in want.items():
        np.testing.assert_array_equal(got[n].numpy(), v, err_msg=n)


def _corpus(root, n_train=64, seed=0):
    """aclImdb-layout JSON whose texts (3 to 90 words) fill the 64 and the
    128 token buckets."""
    import json
    base = root / "aclImdb"
    base.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    for split, count in (("train", n_train), ("dev", 12), ("test", 6)):
        d = {}
        for i in range(count):
            y = int(rs.randint(2))
            n = int(rs.choice([3, 20, 40, 90], p=[0.3, 0.3, 0.3, 0.1]))
            text = " ".join(f"w{rs.randint(200)}" for _ in range(n))
            d[str(i)] = {"ori": text, "aug_0": text + " again",
                         "aug_1": "so " + text, "label": y}
        (base / f"{split}.json").write_text(json.dumps(d))
    return str(root)


@pytest.mark.parametrize("world", [2, 4])
def test_nlp_loader_on_each_rank_is_jax(tmp_path, world):
    from test_torch_nlp import KEYS, assert_batches_equal
    root = _corpus(tmp_path)
    kw = dict(algorithm="srflexmatch", dataset="aclImdb", data_dir=root,
              num_classes=2, num_labels=16, seed=0)
    tsp = tnlp.get_nlp_dataset(torch_config(**kw), "srflexmatch")
    jsp = jnlp.get_nlp_dataset(jax_config(**kw), "srflexmatch")
    tcol = tnlp.NLPCollator(tnlp.HashTokenizer(), 256, tnlp.auto_buckets(256))
    jcol = jnlp.NLPCollator(jnlp.HashTokenizer(), 256, jnlp.auto_buckets(256))
    bs = 4 // world
    lengths = []
    for rank in range(world):
        tl = tmod.NLPSSLLoader(tsp, tcol, bs, bs, KEYS, seed=5, rank=rank,
                               world=world)
        jl = jmod.NLPSSLLoader(jsp, jcol, bs, bs, KEYS, seed=5, rank=rank,
                               world=world)
        mine = []
        for step in range(8):
            got = next(tl)
            assert_batches_equal(got, next(jl), f"rank {rank} step {step}")
            mine.append(got["x_lb"]["input_ids"].shape[1])
        lengths.append(mine)
    # every rank pads each step to the one bucket, and not always the top
    assert all(l == lengths[0] for l in lengths)
    assert len(set(lengths[0])) > 1


OUT_OF_SCOPE = ("freematch", "softmatch", "dash", "adamatch", "comatch",
                "simmatch", "mixmatch", "remixmatch", "uda", "vat", "pimodel",
                "meanteacher", "crmatch", "defixmatch", "srfreematch",
                "srsoftmatch")
IN_SCOPE = ("fixmatch", "flexmatch", "pseudolabel", "fullysupervised",
            "supervised", "srfixmatch", "srflexmatch", "srpseudolabel")


def test_algorithms_outside_the_slice_refuse_a_mesh():
    from semireward_tpu_torch import imb as _imb  # noqa: F401
    from semireward_tpu_torch.imb import get_imb_algorithm
    info = {"ulb_dest_len": 16, "lb_dest_len": 8,
            "lb_class_dist": np.full(NC, 1.0 / NC), "num_features": 32}
    mesh_lib.activate(mesh_lib.Mesh((4,), ("data",), groups=False))
    try:
        for name in OUT_OF_SCOPE:
            cfg = torch_config(algorithm=name, num_classes=NC)
            with pytest.raises(NotImplementedError,
                               match="ROADMAP item 16") as e:
                ALGORITHMS.get(name)(cfg, info, torch.device("cpu"))
            assert ALGORITHMS.get(name).NAME.split("_")[-1] in str(e.value) \
                or name in str(e.value)
        cfg = torch_config(algorithm="fixmatch", num_classes=NC)
        with pytest.raises(NotImplementedError, match="saw"):
            get_imb_algorithm("saw")(cfg, info, torch.device("cpu"),
                                     base_cls=ALGORITHMS.get("fixmatch"))
        for name in IN_SCOPE:
            ALGORITHMS.get(name)(torch_config(algorithm=name,
                                              num_classes=NC, feature_dim=32),
                                 info, torch.device("cpu"))
    finally:
        mesh_lib.activate(None)
    # one rank, or no mesh: every algorithm builds as before
    ALGORITHMS.get("freematch")(torch_config(algorithm="freematch",
                                             num_classes=NC), info,
                                torch.device("cpu"))


TRAINER_CFG = dict(algorithm="srflexmatch", net="vit_small_patch2_32",
                   dataset="synthetic", num_classes=NC, num_labels=16,
                   batch_size=8, eval_batch_size=8, img_size=16,
                   num_train_iter=2, num_eval_iter=2, num_log_iter=1,
                   start_timing=1, N_k=1, feature_dim=32, optim="AdamW",
                   lr=5e-4, synthetic_train=64, synthetic_test=16,
                   save_name="run", seed=0,
                   net_kwargs=dict(depth=2, embed_dim=32, num_heads=2,
                                   patch_size=4, drop_path_rate=0.0))


@pytest.fixture(scope="module", autouse=True)
def trainer_ranks(tmp_path_factory):
    """Two gloo ranks training ``TRAINER_CFG``, started before this
    module's other tests and joined by the one that reads them."""
    save_dir = str(tmp_path_factory.mktemp("mesh_trainer"))
    cfg = dict(TRAINER_CFG, save_dir=save_dir)
    return cfg, Ranks(R.trainer_run, 2, cfg, timeout=120)


def test_two_ranks_train_a_yaml_through_the_trainer(trainer_ranks):
    from semireward_tpu_torch.core.trainer import Trainer
    cfg, started = trainer_ranks
    ranks = started.result()
    assert [r["batch"] for r in ranks] == [4, 4]
    assert "Mesh({'data': 2}" in ranks[0]["mesh"]
    for k in ("total_loss", "sup_loss", "unsup_loss", "util_ratio"):
        assert ranks[0]["log"][-1][k] == ranks[1]["log"][-1][k], k
    assert ranks[0]["results"] == ranks[1]["results"]
    assert ranks[0]["writes"] > 0 and ranks[1]["writes"] == 0
    assert {"latest_model.ckpt", "model_best.ckpt"} <= set(ranks[0]["files"])
    one = Trainer(torch_config(**dict(cfg, num_train_iter=2)), device="cpu")
    extra = one.load(os.path.join(cfg["save_dir"], "run",
                                  "latest_model.ckpt"))
    assert extra["it"] == 2 and one.state.step == 2
    got = one.evaluate()
    for k, v in got.items():
        assert abs(v - ranks[0]["results"][f"eval/{k}"]) < 1e-5, k
