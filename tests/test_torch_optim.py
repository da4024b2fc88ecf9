"""The port's hand-written optimizer against the optax chain of the JAX
package: K steps on identical gradients, leaf by leaf, on a narrow 2-block
ViT (weight-decay mask and BEiT layer decay both active).

Both sides run the same float32 formulas in a slightly different order
(e.g. the bias correction), so each leaf agrees to 1e-6 of its largest
magnitude; the mask and the layer-decay scales agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_rel_close
from semireward_tpu.core import optim as JO
from semireward_tpu.models import vit as jvit
from semireward_tpu_torch.convert import (flax_to_torch, load_flax_params,
                                          torch_name)
from semireward_tpu_torch.core import optim as TO
from semireward_tpu_torch.models import vit as tvit

ARCH = dict(depth=2, embed_dim=32, num_heads=2, img_size=8, patch_size=4)


@pytest.fixture(scope="module")
def pair():
    jm = jvit.vit_small_patch2_32(num_classes=10, dtype=jnp.float32, **ARCH)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
                     train=False)["params"]
    # non-zero tokens and biases, so that decay and scales all show
    params = jax.tree_util.tree_map(
        lambda p: p + 0.01 * jnp.asarray(
            np.random.RandomState(p.size).randn(*p.shape), p.dtype), params)
    tm = tvit.vit_small_patch2_32(num_classes=10, dtype=torch.float32, **ARCH)
    load_flax_params(tm, jax.device_get(params))
    return params, tm


def _flat_names(tree):
    return flax_to_torch(jax.tree_util.tree_map(np.asarray, tree))


def _per_leaf(tree):
    """A tree of per-leaf scalars (mask, scale) keyed by torch names."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {torch_name(k.key for k in path): v for path, v in flat}


def test_schedule_matches():
    js = JO.cosine_schedule_with_warmup(0.03, 100, 10)
    ts = TO.cosine_schedule_with_warmup(0.03, 100, 10)
    for c in (0, 1, 5, 9, 10, 11, 50, 99, 100, 120):
        np.testing.assert_allclose(ts(c), float(js(c)), rtol=1e-6, atol=0)


def test_wd_mask_and_layer_scales_match(pair):
    params, tm = pair
    jmask = _per_leaf(JO.default_wd_mask(params))
    tmask = TO.default_wd_mask(tm)
    assert {k: bool(v) for k, v in jmask.items()} == tmask
    b = jvit.vit_small_patch2_32
    jsc = _per_leaf(JO.layer_decay_scales(params, 0.5, b.layer_id_fn,
                                            b.num_layers))
    tsc = TO.layer_decay_scales([n for n, _ in tm.named_parameters()], 0.5,
                                tvit.vit_small_patch2_32.layer_id_fn,
                                tvit.vit_small_patch2_32.num_layers)
    assert {k: float(v) for k, v in jsc.items()} == tsc


@pytest.mark.parametrize("name,clip", [("AdamW", 0.0), ("AdamW", 0.5),
                                       ("SGD", 0.5)])
def test_k_steps_match_optax(pair, name, clip):
    params, tm0 = pair
    tm = tvit.vit_small_patch2_32(num_classes=10, dtype=torch.float32, **ARCH)
    tm.load_state_dict(tm0.state_dict())
    b = jvit.vit_small_patch2_32
    kw = dict(optim_name=name, lr=0.01, momentum=0.9, weight_decay=5e-2,
              layer_decay=0.5, num_training_steps=20, num_warmup_steps=2,
              clip_grad=clip, num_layers=b.num_layers)
    tx = JO.build_optimizer(params, layer_id_fn=b.layer_id_fn, **kw)
    topt = TO.build_optimizer(
        tm, layer_id_fn=tvit.vit_small_patch2_32.layer_id_fn, **kw)
    jp, jst = params, tx.init(params)
    names = [n for n, _ in tm.named_parameters()]
    rs = np.random.RandomState(7)
    for _ in range(4):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rs.randn(*p.shape).astype(np.float32)), jp)
        upd, jst = tx.update(grads, jst, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        tg = _flat_names(grads)
        topt.step([torch.tensor(tg[n]) for n in names])
        want = _flat_names(jp)
        for n, p in tm.named_parameters():
            assert_rel_close(p, want[n], 1e-6, n)
