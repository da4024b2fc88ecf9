"""The port's ViT against the flax ViT: parameter counts and names of all
five builders, and logits/features of a narrow 2-block ViT (fused MLP on,
the JAX kernel in interpret mode) on the same weights through the
flax->torch converter.

Tolerances: float32 compute, sums in another order: 1e-4 of the largest
magnitude. bfloat16 compute: both sides round activations to 8 significant
bits at different places (XLA fuses bias adds, LayerNorm variance form):
5e-2 of the largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_rel_close
from semireward_tpu.models import vit as jvit
from semireward_tpu_torch.convert import flax_to_torch, load_flax_params
from semireward_tpu_torch.models import vit as tvit

NAMES = ["vit_tiny_patch2_32", "vit_small_patch2_32", "vit_small_patch16_224",
         "vit_base_patch16_96", "vit_base_patch16_224"]


@pytest.mark.parametrize("name", NAMES)
def test_param_names_and_shapes_match(name):
    jm = getattr(jvit, name)(num_classes=100)
    size = jm.img_size
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, size, size, 3)), train=False))["params"]
    jflat = flax_to_torch(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    with torch.device("meta"):
        tm = getattr(tvit, name)(num_classes=100, device="meta")
    tshapes = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert tshapes == {n: a.shape for n, a in jflat.items()}
    assert getattr(tvit, name).num_layers == getattr(jvit, name).num_layers


ARCH = dict(depth=2, embed_dim=64, num_heads=2, img_size=16, patch_size=4,
            drop_path_rate=0.0)


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_logits_and_feat_match(dtype, rel):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jm = jvit.vit_small_patch2_32(num_classes=10, dtype=jdt,
                                  use_fused_mlp=True, **ARCH)
    rs = np.random.RandomState(0)
    x = rs.randn(3, 16, 16, 3).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)[
        "params"]
    # the flax init zeroes biases and tokens; perturb all weights so that
    # every parameter matters
    params = jax.tree_util.tree_map(
        lambda p: p + 0.02 * jnp.asarray(
            np.random.RandomState(p.size % 9973).randn(*p.shape), p.dtype),
        params)
    want = jm.apply({"params": params}, jnp.asarray(x), train=False)

    tm = tvit.vit_small_patch2_32(num_classes=10, dtype=tdt,
                                  use_fused_mlp=True, **ARCH)
    load_flax_params(tm, jax.device_get(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=False)
        got_train = tm(torch.from_numpy(x), train=True)
    for k in ("logits", "feat"):
        assert_rel_close(got[k], np.asarray(want[k], np.float32), rel, k)
        # drop_path 0 and no dropout: train mode computes the same function
        assert_rel_close(got_train[k], got[k], 1e-6, k)


def test_ssl_forward_concat_and_split_agree():
    """use_cat=True (one pass over the concat) and use_cat=False (three
    passes, weak one without gradient) give the same logits and features on
    the stat-free ViT (f32: 1e-5), and the weak view carries no gradient."""
    from semireward_tpu_torch.algorithms.common import ssl_forward

    tm = tvit.vit_small_patch2_32(num_classes=10, dtype=torch.float32,
                                  generator=torch.Generator().manual_seed(0),
                                  **ARCH)
    rs = np.random.RandomState(3)
    xs = [torch.from_numpy(rs.randn(n, 16, 16, 3).astype(np.float32))
          for n in (2, 3, 3)]
    cat = ssl_forward(tm, *xs, use_cat=True)
    split = ssl_forward(tm, *xs, use_cat=False)
    for a, b in zip(cat, split):
        assert_rel_close(a, b, 1e-5)
    assert not cat.logits_x_ulb_w.requires_grad
    assert not split.logits_x_ulb_w.requires_grad
    assert cat.logits_x_ulb_s.requires_grad and split.logits_x_ulb_s.requires_grad
