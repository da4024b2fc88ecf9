"""Released pretrained weights in the port (``models/utils.py``,
``models/bert.py:load_hf_bert_weights``,
``models/hubert.py:load_hf_audio_weights``) against the JAX package's
``models/utils.py:load_pretrained``.

Seeded synthetic state dicts in the timm ViT, HF BERT and HF HuBERT /
wav2vec2 layouts (HuBERT's positional conv in both weight-norm formats) go
to ``tmp_path`` with ``torch.save``. The JAX graft of a small flax net's
parameters, through ``convert.py``, equals the port's graft of the same
parameters bit for bit. The ViT position-embedding grid resize (8 -> 16
and 16 -> 8) is within 1e-5 of ``jax.image.resize``. A missing file raises
``FileNotFoundError``; the Trainer grafts ``use_pretrain`` weights, restarts
the EMA from them and keeps the optimizer moments at zero.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semireward_tpu.models import bert as jbert
from semireward_tpu.models import hubert as jhubert
from semireward_tpu.models import utils as jutils
from semireward_tpu.models import vit as jvit
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.convert import flax_to_torch
from semireward_tpu_torch.models import utils as tutils

NC = 4
VIT = dict(depth=2, embed_dim=32, num_heads=2, img_size=16, patch_size=4,
           drop_path_rate=0.0)
BERT = dict(hidden=64, layers=2, heads=2, intermediate=128, max_position=64)
HUBERT = dict(hidden=64, layers=2, heads=2)


@functools.lru_cache(maxsize=None)
def _jax_params(family):
    if family == "vit":
        jm = jvit.vit_small_patch2_32(num_classes=NC, **VIT)
        sample = jnp.zeros((1, 16, 16, 3))
    elif family == "bert":
        jm = jbert.ClassificationBert(num_classes=NC, vocab_size=500, **BERT)
        sample = {"input_ids": jnp.zeros((2, 16), jnp.int32),
                  "attention_mask": jnp.ones((2, 16), jnp.int32)}
    else:
        jm = jhubert.hubert_base(NC, dtype=jnp.float32, **HUBERT)
        sample = jnp.zeros((2, 1600))
    return jax.jit(lambda key: jm.init(key, sample, train=False))(
        jax.random.PRNGKey(0))["params"]


def _flat(family):
    return flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                _jax_params(family)))


def _rand(rs, shape):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32))


def _timm_vit(grid, seed=0):
    """timm names and layouts for the small ViT, a ``grid`` x ``grid``
    position embedding, a head of another width, ``module.`` prefixes."""
    rs = np.random.RandomState(seed)
    own = _flat("vit")
    sd = {}
    for n, v in own.items():
        if n.startswith("head."):
            continue
        key = n.replace("patch_embed.", "patch_embed.proj.")
        sd["module." + key] = _rand(rs, v.shape)
    sd["module.pos_embed"] = _rand(rs, (1, grid * grid + 1, VIT["embed_dim"]))
    sd["module.head.weight"] = _rand(rs, (10, VIT["embed_dim"]))
    sd["module.head.bias"] = _rand(rs, (10,))
    return {"model": sd}


_BERT_LAYER = {"attention.query": "attention.self.query",
               "attention.key": "attention.self.key",
               "attention.value": "attention.self.value",
               "attention.output": "attention.output.dense",
               "attention_ln": "attention.output.LayerNorm",
               "intermediate": "intermediate.dense",
               "output": "output.dense", "output_ln": "output.LayerNorm"}


def _hf_bert(seed=1):
    """HF ``BertModel`` names (``bert.`` prefix) plus keys the graft
    ignores (pooler, MLM head)."""
    rs = np.random.RandomState(seed)
    sd = {}
    for n, v in _flat("bert").items():
        if n.startswith("classifier"):
            continue
        if n.startswith("layer."):
            _, i, rest = n.split(".", 2)
            mod, leaf = rest.rsplit(".", 1)
            key = f"encoder.layer.{i}.{_BERT_LAYER[mod]}.{leaf}"
        elif n.startswith("embeddings_ln."):
            key = "embeddings.LayerNorm." + n.split(".")[1]
        else:
            key = "embeddings." + n.replace(".weight", "") + ".weight"
        sd["bert." + key] = _rand(rs, v.shape)
    sd["bert.pooler.dense.weight"] = _rand(rs, (BERT["hidden"],) * 2)
    sd["cls.predictions.bias"] = _rand(rs, (500,))
    return sd


_AUDIO_LAYER = {"q": "attention.q_proj", "k": "attention.k_proj",
                "v": "attention.v_proj", "out": "attention.out_proj",
                "ff1": "feed_forward.intermediate_dense",
                "ff2": "feed_forward.output_dense", "ln1": "layer_norm",
                "ln2": "final_layer_norm"}


def _hf_audio(legacy, prefix, seed=2):
    """HF ``HubertModel`` / ``Wav2Vec2Model`` names under ``prefix``; the
    positional conv weight-normed over its taps, stored as ``weight_g`` /
    ``weight_v`` (``legacy``) or torch 2's parametrization."""
    rs = np.random.RandomState(seed)
    sd = {}
    for n, v in _flat("hubert").items():
        if n.startswith("classifier"):
            continue
        mod, leaf = n.rsplit(".", 1)
        if n == "pos_conv.weight":
            pc = "encoder.pos_conv_embed.conv."
            g, w = _rand(rs, (1, 1, v.shape[2])), _rand(rs, v.shape)
            if legacy:
                sd[prefix + pc + "weight_g"], sd[prefix + pc + "weight_v"] = g, w
            else:
                sd[prefix + pc + "parametrizations.weight.original0"] = g
                sd[prefix + pc + "parametrizations.weight.original1"] = w
            continue
        if mod.startswith("feature_extractor.conv"):
            key = f"feature_extractor.conv_layers.{mod[-1]}.conv.{leaf}"
        elif mod == "feature_extractor.gn0":
            key = f"feature_extractor.conv_layers.0.layer_norm.{leaf}"
        elif mod.startswith("layer."):
            _, i, rest = mod.split(".", 2)
            key = f"encoder.layers.{i}.{_AUDIO_LAYER[rest]}.{leaf}"
        else:
            key = {"fp_ln": "feature_projection.layer_norm",
                   "fp_proj": "feature_projection.projection",
                   "pos_conv": "encoder.pos_conv_embed.conv",
                   "encoder_ln": "encoder.layer_norm"}[mod] + "." + leaf
        sd[prefix + key] = _rand(rs, v.shape)
    return sd


def _both(net, family, path):
    """(JAX graft through convert.py, the port's graft), name -> numpy."""
    want = flax_to_torch(jax.tree_util.tree_map(
        np.asarray, jutils.load_pretrained(net, _jax_params(family), path)))
    got = tutils.load_pretrained(net, {n: torch.from_numpy(np.array(v))
                                       for n, v in _flat(family).items()},
                                 path)
    assert sorted(got) == sorted(want)
    return want, {n: v.numpy() for n, v in got.items()}


CASES = {
    "vit_timm": ("vit_small_patch2_32", "vit", lambda: _timm_vit(grid=4)),
    "bert_hf": ("bert_base_uncased", "bert", _hf_bert),
    "hubert_weight_g_v": ("hubert_base", "hubert",
                          lambda: {"state_dict": {
                              "module." + k: v for k, v in _hf_audio(
                                  True, "model.hubert.").items()}}),
    "wav2vec2_parametrized": ("wave2vecv2_base", "hubert",
                              lambda: _hf_audio(False, "wav2vec2.")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graft_equals_the_jax_graft_bit_for_bit(tmp_path, case):
    net, family, make = CASES[case]
    path = str(tmp_path / "released.pth")
    torch.save(make(), path)
    want, got = _both(net, family, path)
    changed = 0
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        changed += not np.array_equal(got[n], _flat(family)[n])
    head = sum(n.startswith(("head.", "classifier")) for n in want)
    assert changed == len(want) - head  # every leaf but the head grafted


def test_vit_graft_resizes_the_grid_as_jax_does(tmp_path):
    path = str(tmp_path / "grid8.pth")
    torch.save(_timm_vit(grid=8, seed=4), path)
    want, got = _both("vit_small_patch2_32", "vit", path)
    for n in want:
        if n == "pos_embed":
            assert got[n].shape == (1, 17, VIT["embed_dim"])
            np.testing.assert_allclose(got[n], want[n], rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)


@pytest.mark.parametrize("old,new", [(8, 16), (16, 8), (7, 12)])
def test_pos_embed_resize_matches_jax_image_resize(old, new):
    pe = np.random.RandomState(old * new).randn(
        1, old * old + 1, 24).astype(np.float32)
    want = jutils.resize_pos_embed_vit(pe, new * new + 1)
    got = tutils.resize_pos_embed_vit(pe, new * new + 1)
    assert got.shape == want.shape == (1, new * new + 1, 24)
    np.testing.assert_array_equal(got[:, :1], pe[:, :1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # torch's bicubic (a = -0.75, no antialias) computes another grid
    grid = torch.from_numpy(pe[0, 1:].reshape(old, old, 24)).permute(2, 0, 1)
    other = torch.nn.functional.interpolate(grid[None], size=(new, new),
                                            mode="bicubic")[0]
    other = other.permute(1, 2, 0).reshape(1, new * new, 24).numpy()
    assert np.abs(other - want[:, 1:]).max() > 1e-3


def test_missing_or_unported_files_raise(tmp_path):
    params = {"w": torch.zeros(1)}
    with pytest.raises(FileNotFoundError, match="pretrain_path"):
        tutils.load_pretrained("vit_small_patch2_32", params, "")
    with pytest.raises(FileNotFoundError, match="pretrain_path"):
        tutils.load_pretrained("bert_base_uncased", params,
                               str(tmp_path / "absent.pth"))
    path = tmp_path / "x.pth"
    torch.save({}, str(path))
    # DINOv2 grafts through the ViT's loader (tests/test_torch_dinov2.py);
    # a family with no loader raises in both packages
    with pytest.raises(NotImplementedError, match="resnet50"):
        tutils.load_pretrained("resnet50", params, str(path))
    with pytest.raises(NotImplementedError, match="resnet50"):
        jutils.load_pretrained("resnet50", {}, str(path))


def _vit_cfg(tmp_path, **kw):
    return torch_config(
        algorithm="srflexmatch", net="vit_small_patch2_32",
        dataset="synthetic", num_classes=NC, num_labels=8, batch_size=4,
        eval_batch_size=8, img_size=16, num_train_iter=1, num_eval_iter=1,
        num_log_iter=1, feature_dim=32, optim="AdamW", lr=5e-4,
        synthetic_train=64, synthetic_test=16, save_dir=str(tmp_path),
        net_kwargs={k: v for k, v in VIT.items() if k != "img_size"}, **kw)


def test_trainer_grafts_and_restarts_the_ema_from_the_graft(tmp_path):
    from semireward_tpu_torch.core.trainer import Trainer

    sd = _timm_vit(grid=8, seed=5)
    path = str(tmp_path / "released.pth")
    torch.save(sd, path)
    tr = Trainer(_vit_cfg(tmp_path, use_pretrain=True, pretrain_path=path),
                 device="cpu")
    params = dict(tr.model.named_parameters())
    want = tutils.load_pretrained("vit_small_patch2_32", params, path)
    src = sd["model"]
    np.testing.assert_array_equal(
        params["blocks.0.attn.proj.weight"].detach().numpy(),
        src["module.blocks.0.attn.proj.weight"].numpy())
    np.testing.assert_array_equal(
        params["pos_embed"].detach().numpy(),
        tutils.resize_pos_embed_vit(src["module.pos_embed"].numpy(), 17))
    for (n, p), e in zip(params.items(), tr.state.ema):
        assert p.dtype == torch.float32
        assert torch.equal(p, want[n].to(p.dtype)), n
        assert torch.equal(e, p), n
    assert not torch.equal(params["head.weight"][:, :4],
                           src["module.head.weight"][:NC, :4])
    assert all(float(m.abs().max()) == 0 for m in tr.state.opt.mu)
    tr.train()
    assert tr.state.step == 1
    with pytest.raises(FileNotFoundError, match="pretrain_path"):
        Trainer(_vit_cfg(tmp_path, use_pretrain=True, pretrain_path=""),
                device="cpu")
