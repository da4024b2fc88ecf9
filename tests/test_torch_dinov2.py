"""DINOv2 in the port (``models/dinov2.py``, LayerScale in ``models/vit.py``)
held against the JAX package on the same weights (flax -> torch through
``convert.py``) and the same seeded numpy inputs.

- A LayerScale ViT at a small geometry (2 blocks, C 64, patch 14, 28 px,
  ``init_values`` 1e-5, every weight perturbed so that the gammas matter;
  fused MLP on: JAX's kernel in interpret mode, the port's plain version):
  logits and features at float32 (1e-4 of the largest magnitude) and
  bfloat16 (5e-2: both sides round activations at different places), and
  at float32 the gradient of every parameter (1e-4 of each leaf's largest
  magnitude); the port's gradients with every block checkpointed equal
  the unchecked ones bit for bit, the LayerScale product under the
  checkpoint included.
- The two builders' geometry at full width, without allocating ViT-L on
  the CPU (JAX through ``jax.eval_shape``, the port on the meta device):
  parameter names and shapes, N 257 at 224 px, depth, heads,
  ``num_layers``; the ViT switches pass through, the geometry does not;
  LayerScale starts at 1e-5.
- The converter maps the ``ls1`` / ``ls2`` leaves; layer-decay scales and
  the weight-decay mask equal JAX's (LayerScale decays with its block and
  takes no weight decay).
- A DINOv2-layout state dict (``blocks.i.ls1.gamma`` / ``ls2.gamma``,
  ``mask_token``, a larger position grid) grafts bit-equal to JAX's
  ``load_pretrained`` (the resized grid within 1e-5, as the ViT's), and
  the gammas are not read: LayerScale stays at its init in both.
- Three SRFlexMatch steps on a tiny DINOv2 geometry (patch 14, 28 px,
  LayerScale) under ``run_three_sr_steps``' tolerances.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_rel_close
from semireward_tpu.core import optim as joptim
from semireward_tpu.models import dinov2 as jdinov2
from semireward_tpu.models import utils as jutils
from semireward_tpu.models import vit as jvit
from semireward_tpu_torch.convert import (flax_to_torch, load_flax_params,
                                          torch_name)
from semireward_tpu_torch.core import optim as toptim
from semireward_tpu_torch.models import dinov2 as tdinov2
from semireward_tpu_torch.models import utils as tutils
from semireward_tpu_torch.models import vit as tvit
from test_torch_step import EMB, run_three_sr_steps

NC, S = 5, 28
ARCH = dict(depth=2, embed_dim=64, num_heads=2, img_size=S, patch_size=14,
            drop_path_rate=0.0, init_values=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_pair(dtype):
    """The flax LayerScale ViT at ``ARCH`` (fused MLP on) and its perturbed
    parameters."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jm = jvit.vit_small_patch2_32(num_classes=NC, dtype=jdt,
                                  use_fused_mlp=True, **ARCH)
    params = jax.jit(lambda k: jm.init(k, jnp.zeros((1, S, S, 3)),
                                       train=False))(
        jax.random.PRNGKey(1))["params"]
    params = jax.tree_util.tree_map(
        lambda p: p + 0.02 * jnp.asarray(
            np.random.RandomState(p.size % 9973).randn(*p.shape), p.dtype),
        params)
    return jm, params


def _torch_model(dtype, params, **kw):
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tm = tvit.vit_small_patch2_32(num_classes=NC, dtype=tdt,
                                  use_fused_mlp=True, **ARCH, **kw)
    return load_flax_params(tm, jax.device_get(params))


def _inputs():
    rs = np.random.RandomState(0)
    return (rs.randn(3, S, S, 3).astype(np.float32),
            rs.randn(3, NC).astype(np.float32))


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_layer_scale_vit_forward_matches_jax(dtype, rel):
    jm, params = _jax_pair(dtype)
    x, _ = _inputs()
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x, train=False))(
        params, jnp.asarray(x))
    tm = _torch_model(dtype, params)
    assert tm.blocks[1].ls2.dtype == torch.float32
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=False)
    for k in ("logits", "feat"):
        assert_rel_close(got[k], np.asarray(want[k], np.float32), rel, k)


def test_layer_scale_vit_backward_matches_jax_and_remat_keeps_the_bits():
    jm, params = _jax_pair("float32")
    x, r = _inputs()

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), train=True)
        return (out["logits"] * jnp.asarray(r)).sum()

    want = flax_to_torch(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss))(params)))
    grads = {}
    for remat in (False, True):
        tm = _torch_model("float32", params, remat=remat)
        out = tm(torch.from_numpy(x), train=True,
                 generator=torch.Generator().manual_seed(0))
        names, ps = zip(*tm.named_parameters())
        g = torch.autograd.grad((out["logits"] * torch.from_numpy(r)).sum(),
                                ps)
        grads[remat] = dict(zip(names, g))
    assert sorted(grads[False]) == sorted(want)
    assert "blocks.1.ls1" in want and "blocks.0.ls2" in want
    for n, g in grads[False].items():
        assert_rel_close(g, want[n], 1e-4, n)
        assert torch.equal(g, grads[True][n]), n


@pytest.mark.parametrize("name,dim,depth,heads", [
    ("dinov2_vitb14", 768, 12, 12), ("dinov2_vitl14", 1024, 24, 16)])
def test_builders_geometry_at_full_width(name, dim, depth, heads):
    jb, tb = getattr(jdinov2, name), getattr(tdinov2, name)
    jm = jb(num_classes=NC)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
        train=False))["params"]
    # the converter's layouts (Dense kernels transposed, the patch conv
    # HWIO -> OIHW) on the shapes alone: no ViT-L array is made
    layout = {2: (1, 0), 4: (3, 2, 0, 1)}
    want = {}
    for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key for k in path]
        order = layout[len(v.shape)] if keys[-1] == "kernel" else range(
            len(v.shape))
        want[torch_name(keys)] = tuple(v.shape[i] for i in order)
    tm = tb(num_classes=NC, device="meta", use_fused_mlp=True, use_flash=True,
            remat=True, embed_dim=32, depth=1)
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == want
    assert want["pos_embed"] == (1, 257, dim)
    assert want["patch_embed.weight"] == (dim, 3, 14, 14)
    assert want[f"blocks.{depth - 1}.ls2"] == (dim,)
    assert want[f"blocks.{depth - 1}.mlp.fc1.weight"] == (4 * dim, dim)
    assert len(tm.blocks) == depth and tm.blocks[0].attn.num_heads == heads
    assert tb.num_layers == jb.num_layers == depth + 1
    assert tb.layer_id_fn is tvit.layer_id
    blk = tm.blocks[0]
    assert blk.init_values == jm.init_values == 1e-5
    assert blk.mlp.use_fused and blk.attn.use_flash and blk.remat
    # the size rounds down to whole patches, as in the JAX builder
    assert tb(num_classes=NC, device="meta", img_size=230).img_size == 224


def test_builder_starts_layer_scale_at_its_init():
    tm = tdinov2.dinov2_vitb14(num_classes=NC, dtype=torch.float32,
                               generator=torch.Generator().manual_seed(0))
    for blk in tm.blocks:
        assert torch.equal(blk.ls1, torch.full((768,), 1e-5))
        assert torch.equal(blk.ls2, torch.full((768,), 1e-5))
    assert float(tm.pos_embed.detach().abs().max()) == 0.0


def test_converter_layer_decay_and_weight_decay_mask_equal_jax():
    _, params = _jax_pair("float32")
    flat = flax_to_torch(jax.tree_util.tree_map(np.asarray, params))
    assert {"blocks.0.ls1", "blocks.0.ls2", "blocks.1.ls1",
            "blocks.1.ls2"} <= set(flat)
    tm = _torch_model("float32", params)
    builder = jdinov2.dinov2_vitb14
    num_layers = ARCH["depth"] + 1
    scales = joptim.layer_decay_scales(params, 0.75, builder.layer_id_fn,
                                       num_layers)
    want = {torch_name([k.key for k in path]): float(v) for path, v in
            jax.tree_util.tree_flatten_with_path(scales)[0]}
    names = [n for n, _ in tm.named_parameters()]
    got = toptim.layer_decay_scales(names, 0.75,
                                    tdinov2.dinov2_vitb14.layer_id_fn,
                                    num_layers)
    assert got == want
    assert got["blocks.0.ls1"] == got["blocks.0.attn.qkv.weight"]
    assert got["blocks.1.ls2"] == got["blocks.1.mlp.fc2.weight"]
    mask = {torch_name([k.key for k in path]): bool(v) for path, v in
            jax.tree_util.tree_flatten_with_path(
                joptim.default_wd_mask(params))[0]}
    assert toptim.default_wd_mask(tm) == mask
    assert not mask["blocks.0.ls1"] and not mask["blocks.1.ls2"]


def _dinov2_state_dict(grid, seed=0):
    """A DINOv2 checkpoint's names and layouts for the small LayerScale
    ViT: ``patch_embed.proj``, ``blocks.i.ls1.gamma`` / ``ls2.gamma``, a
    ``mask_token``, a ``grid`` x ``grid`` position embedding, no head."""
    _, params = _jax_pair("float32")
    own = flax_to_torch(jax.tree_util.tree_map(np.asarray, params))
    rs = np.random.RandomState(seed)
    sd = {}
    for n, v in own.items():
        if n.startswith("head."):
            continue
        key = n.replace("patch_embed.", "patch_embed.proj.")
        key = key.replace(".ls1", ".ls1.gamma").replace(".ls2", ".ls2.gamma")
        sd[key] = torch.from_numpy(rs.randn(*v.shape).astype(np.float32))
    sd["pos_embed"] = torch.from_numpy(
        rs.randn(1, grid * grid + 1, ARCH["embed_dim"]).astype(np.float32))
    sd["mask_token"] = torch.zeros(1, ARCH["embed_dim"])
    return sd


@pytest.mark.parametrize("grid", [2, 3])
def test_dinov2_graft_equals_the_jax_graft(tmp_path, grid):
    path = str(tmp_path / "dinov2.pth")
    torch.save(_dinov2_state_dict(grid), path)
    _, params = _jax_pair("float32")
    own = flax_to_torch(jax.tree_util.tree_map(np.asarray, params))
    want = flax_to_torch(jax.tree_util.tree_map(
        np.asarray, jutils.load_pretrained("dinov2_vitb14", params, path)))
    got = {n: v.numpy() for n, v in tutils.load_pretrained(
        "dinov2_vitl14", {n: torch.from_numpy(np.array(v))
                          for n, v in own.items()}, path).items()}
    assert sorted(got) == sorted(want)
    for n in want:
        if n == "pos_embed" and grid != 2:
            np.testing.assert_allclose(got[n], want[n], rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        if ".ls" in n or n.startswith("head."):
            # LayerScale is not read (the JAX package's graft): at init
            np.testing.assert_array_equal(got[n], own[n], err_msg=n)
        else:
            assert not np.array_equal(got[n], own[n]), n


def test_three_srflexmatch_steps_on_a_tiny_dinov2():
    """SRFlexMatch on DINOv2's block (patch 14, LayerScale) at 28 px: N 5,
    C ``EMB``, the fused MLP on. LayerScale starts at 0.5 here: at DINOv2's
    1e-5 (0.02 after the harness's perturbation) the blocks barely move the
    class token, every sample takes one pseudo label, so one reward, and
    the stage-2 reward filter that the harness requires active keeps
    them all."""
    arch = dict(depth=2, embed_dim=EMB, num_heads=2, img_size=S,
                patch_size=14, drop_path_rate=0.0, use_fused_mlp=True,
                init_values=0.5)

    def check(step, tstate, jstate, tm, jm):
        assert float(tm["util_ratio"]) == float(jm["util_ratio"]), step
        np.testing.assert_array_equal(tstate.algo.selected_label.numpy(),
                                      np.asarray(jstate.algo.selected_label))

    tstate, _ = run_three_sr_steps("srflexmatch", check, arch=arch, size=S)
    assert tstate.model.blocks[0].ls1 is not None
