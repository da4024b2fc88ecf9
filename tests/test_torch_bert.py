"""The port's BERT classifier (``models/bert.py``) against the flax model.

A small ``ClassificationBert`` (2 layers, hidden 128, 2 heads, vocab 1000)
with the flax weights converted to torch gives the same logits and features
at ``train=False``, with ``use_flash`` on and off, on token batches with
padding. float32 compute: within 1e-5 of max|JAX| (f32 sums in another
order). bfloat16 compute: within 2e-2 of max|JAX|: the residual stream is
rounded to bf16 after every sublayer on both sides, and XLA and torch round
the bf16 GELU and the bf16 projections at different points.

Also: layer-decay groups and weight-decay mask equal JAX's, the
``inputs_embeds`` contract, and the fused-MLP dispatch (K1 / K3) that the
model builders ask.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_rel_close
from semireward_tpu.core import optim as joptim
from semireward_tpu.models import bert as jbert
from semireward_tpu_torch.convert import load_flax_params, torch_name
from semireward_tpu_torch.core import optim as toptim
from semireward_tpu_torch.models import bert as tbert

GEOM = dict(hidden=128, layers=2, heads=2, intermediate=256, max_position=64)
VOCAB, NC, L = 1000, 3, 48


def make_pair(use_flash, dtype="float32", seed=0):
    """(flax model, its params, the torch model with those weights); built
    once per geometry, the tests only read them."""
    return _pair(bool(use_flash), dtype, seed)


@functools.lru_cache(maxsize=None)
def _pair(use_flash, dtype, seed):
    jm = jbert.ClassificationBert(num_classes=NC, vocab_size=VOCAB,
                                  dtype=getattr(jnp, dtype),
                                  use_flash=use_flash, **GEOM)
    sample = {"input_ids": jnp.zeros((2, L), jnp.int32),
              "attention_mask": jnp.ones((2, L), jnp.int32)}
    # one compiled init instead of one eager program per op
    params = jax.jit(lambda key: jm.init(key, sample, train=False))(
        jax.random.PRNGKey(seed))["params"]
    with torch.device("meta"):
        tm = tbert.ClassificationBert(NC, vocab_size=VOCAB,
                                      dtype=getattr(torch, dtype),
                                      use_flash=use_flash, **GEOM)
    tm = tm.to_empty(device="cpu")
    load_flax_params(tm, jax.device_get(params))
    return jm, params, tm


def tokens(seed=0, B=3):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1000 // 10, VOCAB, (B, L)).astype(np.int32)
    lens = np.array([L, 30, 7][:B])
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    ids = ids * mask
    return ({"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)},
            {"input_ids": torch.from_numpy(ids),
             "attention_mask": torch.from_numpy(mask)})


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_eval_logits_and_features_match_jax(use_flash, dtype, rel):
    jm, params, tm = make_pair(use_flash, dtype)
    jx, tx = tokens()
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x, train=False))(
        params, jx)
    with torch.no_grad():
        got = tm(tx, train=False)
    for k in ("logits", "feat"):
        assert got[k].dtype == torch.float32
        assert_rel_close(got[k], np.asarray(want[k]), rel, k)


def test_inputs_embeds_and_return_embed():
    jm, params, tm = make_pair(True)
    jx, tx = tokens(1)
    with torch.no_grad():
        base = tm(tx, train=False, return_embed=True)
        emb = tm.word_embeddings(tx["input_ids"].long())
        via = tm(tx, train=False, inputs_embeds=emb)
        feat = tm(tx, train=False, only_feat=True)
        head = tm(feat, only_fc=True)
    torch.testing.assert_close(via["logits"], base["logits"])
    torch.testing.assert_close(head, base["logits"])
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x, train=False,
                                         return_embed=True))(params, jx)
    assert_rel_close(base["embed"], np.asarray(want["embed"]), 1e-5, "embed")


def test_layer_decay_and_weight_decay_groups_equal_jax():
    """The registered net's layer_id_fn / num_layers and the wd mask give every
    parameter the LR scale and decay flag that JAX gives its flax twin."""
    jm, params, tm = make_pair(False)
    def flat(tree):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {torch_name([p.key for p in path]): v for path, v in leaves}

    want_scale = flat(joptim.layer_decay_scales(params, 0.65, jbert._layer_id,
                                                13))
    want_wd = flat(joptim.default_wd_mask(params))
    names = [n for n, _ in tm.named_parameters()]
    builder = tbert.bert_base_uncased
    assert builder.num_layers == jbert.bert_base_uncased.num_layers == 13
    got_scale = toptim.layer_decay_scales(names, 0.65, builder.layer_id_fn,
                                          builder.num_layers)
    got_wd = toptim.default_wd_mask(tm)
    assert sorted(names) == sorted(want_scale)
    for n in names:
        assert got_scale[n] == pytest.approx(float(want_scale[n]), rel=1e-12), n
        assert got_wd[n] == bool(want_wd[n]), n
    assert len({got_scale[n] for n in names}) == 4  # embeddings, 2 layers, head


def test_registered_builders():
    from semireward_tpu_torch.models import get_net_builder

    for name, vocab in (("bert_base_uncased", 30522), ("bert_base_cased", 28996)):
        b = get_net_builder(name)
        m = b(num_classes=2, hidden=64, layers=1, heads=2, intermediate=128,
              img_size=32, generator=torch.Generator().manual_seed(0))
        assert m.word_embeddings.num_embeddings == vocab
        assert abs(float(m.layer[0].attention.query.weight.detach().std()) - 0.02) < 2e-3
        assert float(m.layer[0].attention.query.bias.abs().max()) == 0.0


def test_k1_width_gate_refuses_what_only_k3_takes(monkeypatch):
    """The fused-MLP dispatch on a CUDA device, chosen from the shape: K1
    widths (ViT-S's 384 and ViT-Ti's 192 among them) go to K1, every other
    C that is a multiple of 64 to K3 (C 768 / H 3072: ViT-B, BERT-base;
    DINOv2 ViT-L/14's 1024 / 4096; 512, 448 and 64), as do K1's widths
    where ``block_h`` forces hidden blocks, and a width neither kernel
    takes (C 100) runs as two dense layers. Without a card stand-in
    libraries answer as ``srt_fused_mlp_supported`` (C a multiple of 64
    from 128 to 384, H a multiple of 32) and
    ``srt_fused_mlp_blocked_supported`` (C a positive multiple of 64, H a
    multiple of 32) do; the card test asks the real ones."""
    from semireward_tpu_torch.models import get_net_builder
    from semireward_tpu_torch.ops import fused_mlp as tfm

    asked = []

    class StandIn:
        @staticmethod
        def srt_fused_mlp_supported(c, h):
            asked.append(("K1", c, h))
            return int(128 <= c <= 384 and c % 64 == 0 and h % 32 == 0)

        @staticmethod
        def srt_fused_mlp_blocked_supported(c, h):
            asked.append(("K3", c, h))
            return int(c > 0 and c % 64 == 0 and h > 0 and h % 32 == 0)

    monkeypatch.setattr(tfm, "_lib", lambda: StandIn)
    monkeypatch.setattr(tfm, "_blocked_lib", lambda: StandIn)
    assert tfm.route(384, 1536, "cuda") == "full"           # ViT-S: K1
    assert tfm.route(192, 768, "cuda") == "full"            # ViT-Ti: K1
    assert tfm.route(768, 3072, "cuda") == "blocked"        # ViT-B/BERT: K3
    assert tfm.route(768, 3072, "cuda", block_h=768) == "blocked"
    assert tfm.route(768, 3072, "cpu") == "plain"           # never asks
    assert asked == [("K1", 384, 1536), ("K1", 192, 768), ("K1", 768, 3072),
                     ("K3", 768, 3072), ("K3", 768, 3072)]
    assert tfm.route(1024, 4096, "cuda") == "blocked"       # DINOv2 ViT-L/14
    assert tfm.route(512, 2048, "cuda") == "blocked"
    assert tfm.route(448, 1792, "cuda") == "blocked"        # past K1's 384
    assert tfm.route(64, 256, "cuda") == "blocked"          # below K1's 128
    # K1's widths under forced hidden blocks: K3
    assert tfm.route(384, 1536, "cuda", block_h=512) == "blocked"
    assert tfm.route(100, 400, "cuda") == "dense"           # neither kernel
    assert tfm.route(100, 400, "cpu") == "plain"
    with pytest.raises(ValueError, match="must divide"):
        tfm.route(768, 3072, "cuda", block_h=1000)
    # the builders no longer refuse a width: the dense layers take it
    with torch.device("meta"):
        vit = get_net_builder("vit_tiny_patch2_32")(
            num_classes=2, device="meta", use_fused_mlp=True, embed_dim=100,
            num_heads=5)
    assert vit.blocks[0].mlp.use_fused and vit.blocks[0].mlp.fc1.in_features == 100


def test_dense_route_is_the_jax_two_dense_layers():
    """The dense route computes the JAX package's fallback: bf16 products
    with the biases cast to bf16, exact GELU (held against JAX's own
    expression at C 100, 1e-2 of the largest magnitude: one bf16 rounding
    each side), and counts its forwards."""
    from semireward_tpu_torch.ops import fused_mlp as tfm

    rs = np.random.RandomState(0)
    x = rs.randn(5, 100).astype(np.float32)
    w1 = (rs.randn(100, 400) * 0.1).astype(np.float32)   # flax [in, out]
    b1 = (rs.randn(400) * 0.1).astype(np.float32)
    w2 = (rs.randn(400, 100) * 0.1).astype(np.float32)
    b2 = (rs.randn(100) * 0.1).astype(np.float32)
    dt = jnp.bfloat16
    hid = jax.nn.gelu(jnp.asarray(x, dt) @ jnp.asarray(w1, dt)
                      + jnp.asarray(b1).astype(dt), approximate=False)
    want = np.asarray((hid @ jnp.asarray(w2, dt)
                       + jnp.asarray(b2).astype(dt)).astype(jnp.float32))
    tfm.reset_launches()
    got = tfm.dense_mlp(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(w1.T.copy()), torch.from_numpy(b1),
                        torch.from_numpy(w2.T.copy()), torch.from_numpy(b2))
    assert got.dtype == torch.bfloat16
    assert tfm.launches["fused_mlp_dense"] == 1
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-2 * scale)


@pytest.mark.parametrize("net,max_length,device,want", [
    ("bert_base_uncased", 512, "cuda", True),
    ("bert_base_uncased", 128, "cuda", False),
    ("vit_small_patch2_32", 512, "cuda", True),
    ("vit_base_patch16_224", 512, "cuda", True),
    ("hubert_base", 512, "cuda", True),
    ("wave2vecv2_base", 512, "cuda", True),
    ("hubert_base", 512, "cpu", False),
    ("bert_base_uncased", 512, "cpu", False),
    ("vit_small_patch2_32", 512, "cpu", False),
])
def test_flash_auto_default(net, max_length, device, want):
    """The port's default for an unset use_flash_attention, set by the H100
    A/Bs: on for the ViTs, for BERT at max_length >= 384 and for HuBERT /
    wav2vec2 on a card; the CPU runs the plain version and leaves it off."""
    from semireward_tpu_torch.config import get_config
    from semireward_tpu_torch.core.trainer import flash_auto_default

    cfg = get_config(net=net, max_length=max_length)
    assert flash_auto_default(cfg, torch.device(device)) is want
