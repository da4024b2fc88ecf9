"""The port's HuBERT / wav2vec2 classifiers (``models/hubert.py``,
``models/wav2vec2.py``) against the flax models.

A small ``ClassificationAudioTransformer`` (hidden 64, 2 layers, 2 heads, the
fixed intermediate 3072, the full 7-conv 512-channel feature extractor) with
the flax weights converted to torch gives the same logits and features at
``train=False`` on 0.1 s waveforms (T 1600, 4 frames), with ``use_flash``
on and off and with the fused MLP (the plain version on the CPU). float32
compute, with one clip half zeros (the pad path): within 1e-4 of max|JAX|
(f32 sums in another order through eight convs, GroupNorm and three
LayerNorms). bfloat16 compute: the feature extractor's output within 2e-2
of max|JAX|, logits and features within 1e-1. XLA computes the bf16 GELU's
erf in bf16 where torch computes it in f32, and with random N(0, 0.02)
kernels the seven convs shrink the activations to ~1e-3, where the two
differ by ~1% (measured 0.9%); ``fp_ln`` normalizes that difference up to
~1% of unit-scale features, and the two post-LN layers, which round the
residual stream to bf16 after every sublayer, take it to ~6% of the
largest feature (measured). The bf16 clips have no zero tail: a clip half
zeros makes the frames of the silent half nearly constant across
channels, and the LayerNorms divide the bf16 noise by that near-zero
spread.

Also: layer-decay groups and the weight-decay mask equal JAX's (the frozen
conv kernels are decayed on both sides), and the registered builders.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_rel_close
from semireward_tpu.core import optim as joptim
from semireward_tpu.models import hubert as jhubert
from semireward_tpu.models import wav2vec2 as jw2v
from semireward_tpu_torch.convert import load_flax_params, torch_name
from semireward_tpu_torch.core import optim as toptim
from semireward_tpu_torch.models import hubert as thubert
from semireward_tpu_torch.models import wav2vec2 as tw2v

GEOM = dict(hidden=64, layers=2, heads=2)
NC, T = 5, 1600


@functools.lru_cache(maxsize=None)
def _params():
    """One flax init: every configuration below has this parameter tree
    (f32 parameters whatever the compute dtype; the fused MLP registers the
    Dense pair's names)."""
    jm = jhubert.hubert_base(NC, dtype=jnp.float32, **GEOM)
    return jax.jit(lambda key: jm.init(key, jnp.zeros((2, T)), train=False))(
        jax.random.PRNGKey(0))["params"]


@functools.lru_cache(maxsize=None)
def _pair(name, use_flash, use_fused, dtype):
    """(flax model, its params, the torch model with those weights); built
    once per configuration, the tests only read them."""
    jb, tb = {"hubert_base": (jhubert.hubert_base, thubert.hubert_base),
              "wave2vecv2_base": (jw2v.wave2vecv2_base,
                                  tw2v.wave2vecv2_base)}[name]
    jm = jb(NC, dtype=getattr(jnp, dtype), use_flash=use_flash,
            use_fused_mlp=use_fused, **GEOM)
    params = _params()
    tm = tb(NC, dtype=getattr(torch, dtype), use_flash=use_flash,
            use_fused_mlp=use_fused, **GEOM)
    load_flax_params(tm, jax.device_get(params))
    return jm, params, tm


def _waves(B=3, seed=0, padded=True):
    rs = np.random.RandomState(seed)
    t = np.arange(T) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * rs.uniform(100, 3000, (B, 1)) * t)
         + 0.05 * rs.randn(B, T)).astype(np.float32)
    if padded:
        x[-1, T // 2:] = 0.0                  # a padded clip
    return x


@pytest.mark.parametrize("name,use_flash,use_fused,dtype,rel", [
    ("hubert_base", False, False, "float32", 1e-4),
    ("hubert_base", True, True, "float32", 1e-4),
    ("hubert_base", True, True, "bfloat16", 1e-1),
    ("wave2vecv2_base", True, False, "float32", 1e-4),
])
def test_eval_logits_and_features_match_jax(name, use_flash, use_fused, dtype,
                                             rel):
    jm, params, tm = _pair(name, use_flash, use_fused, dtype)
    x = _waves(padded=dtype == "float32")
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x, train=False))(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=False)
        feat = tm({"input_values": torch.from_numpy(x)}, train=False,
                  only_feat=True)
    if dtype == "bfloat16":
        fe = jhubert.FeatureExtractor(dtype=jnp.bfloat16)
        want_fe = jax.jit(lambda p, x: fe.apply({"params": p}, x))(
            params["feature_extractor"], jnp.asarray(x))
        with torch.no_grad():
            got_fe = tm.feature_extractor(torch.from_numpy(x))
        assert_rel_close(got_fe, np.asarray(want_fe.astype(jnp.float32)),
                         2e-2, "feature extractor")
    for k in ("logits", "feat"):
        assert got[k].dtype == torch.float32
        assert_rel_close(got[k], np.asarray(want[k]), rel, k)
    torch.testing.assert_close(feat, got["feat"])
    torch.testing.assert_close(tm(feat, only_fc=True), got["logits"])


def test_layer_decay_and_weight_decay_groups_equal_jax():
    """The registered net's layer_id_fn / num_layers and the wd mask give
    every parameter the LR scale and decay flag that JAX gives its flax
    twin: the front end (frozen convs, projection, positional conv) in group
    0, layer i in i + 1, the head last; conv and dense kernels decayed,
    biases and norm scales not."""
    _, params, tm = _pair("hubert_base", False, False, "float32")

    def flat(tree):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {torch_name([p.key for p in path]): v for path, v in leaves}

    want_scale = flat(joptim.layer_decay_scales(params, 0.75,
                                                jhubert._layer_id, 13))
    want_wd = flat(joptim.default_wd_mask(params))
    names = [n for n, _ in tm.named_parameters()]
    builder = thubert.hubert_base
    assert builder.num_layers == jhubert.hubert_base.num_layers == 13
    got_scale = toptim.layer_decay_scales(names, 0.75, builder.layer_id_fn,
                                          builder.num_layers)
    got_wd = toptim.default_wd_mask(tm)
    assert sorted(names) == sorted(want_scale)
    for n in names:
        assert got_scale[n] == pytest.approx(float(want_scale[n]), rel=1e-12), n
        assert got_wd[n] == bool(want_wd[n]), n
    assert got_wd["feature_extractor.conv3.weight"]
    assert not got_wd["feature_extractor.gn0.weight"]
    assert len({got_scale[n] for n in names}) == 4  # front, 2 layers, head


def test_registered_builders_and_frozen_extractor():
    from semireward_tpu_torch.models import get_net_builder

    for name in ("hubert_base", "wave2vecv2_base"):
        b = get_net_builder(name)
        m = b(num_classes=2, img_size=32, generator=torch.Generator().manual_seed(0),
              **GEOM)
        assert m.pos_conv.groups == 16 and m.layer[0].ff1.out_features == 3072
        assert abs(float(m.layer[0].q.weight.detach().std()) - 0.02) < 3e-3
        out = m(torch.from_numpy(_waves(2)), train=True,
                generator=torch.Generator().manual_seed(1))
        grads = torch.autograd.grad(out["logits"].sum(), list(m.parameters()),
                                    allow_unused=True)
        named = dict(zip([n for n, _ in m.named_parameters()], grads))
        assert named["feature_extractor.conv0.weight"] is None
        assert named["fp_proj.weight"] is not None
