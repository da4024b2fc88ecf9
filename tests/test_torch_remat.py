"""Gradient checkpointing (``gradient_checkpointing`` / ``remat``) in the
port, held against the JAX package: a narrow 2-block ViT at drop-path 0.5,
the same drop-path masks injected into both packages' ``_drop_path``.

- The port's gradients with every block checkpointed equal those without,
  bit for bit on the CPU (the recompute applies the masks drawn before the
  checkpointed region, and replays the generator for the dropout inside
  it); the fused-MLP and flash layers (their plain versions here) run once
  more per backward.
- Both equal the gradients of the JAX ViT built with ``remat=True`` (each
  block under ``nn.remat``) within the ViT tests' float32 tolerance: 1e-4
  of each leaf's largest magnitude.
- The other builders take the flag and ignore it, as the JAX ones do; the
  trainer passes it to the net where the config asks for it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_rel_close
from semireward_tpu.models import vit as jvit
from semireward_tpu.models import wrn as jwrn
from semireward_tpu.models import resnet as jresnet
from semireward_tpu_torch.convert import flax_to_torch, load_flax_params
from semireward_tpu_torch.models import bert as tbert
from semireward_tpu_torch.models import hubert as thubert
from semireward_tpu_torch.models import resnet as tresnet
from semireward_tpu_torch.models import vit as tvit
from semireward_tpu_torch.models import wrn as twrn

B, S, NC, RATE = 4, 16, 10, 0.5
ARCH = dict(depth=2, embed_dim=64, num_heads=2, img_size=S, patch_size=4,
            drop_path_rate=RATE)


def _masks():
    """Per forward: two drop-path calls in each of the two blocks (block 0
    runs at rate 0, so only block 1's two draw)."""
    rs = np.random.RandomState(11)
    return [rs.rand(B, 1, 1) >= RATE for _ in range(2)]


class _Masks:
    """``_drop_path`` with injected masks, in call order."""

    def __init__(self):
        self.masks, self.calls = _masks(), 0

    def __call__(self, x, rate, off, *, module):
        if off or rate == 0.0:
            return x
        m = self.masks[self.calls % len(self.masks)]
        self.calls += 1
        keep = 1.0 - rate
        if module == "jax":
            return jnp.where(jnp.asarray(m), x / keep, jnp.zeros_like(x))
        return torch.where(torch.from_numpy(m), x / keep, torch.zeros_like(x))


def _install(monkeypatch):
    jm, tm = _Masks(), _Masks()
    monkeypatch.setattr(jvit, "_drop_path",
                        lambda x, r, det, rng: jm(x, r, det, module="jax"))
    monkeypatch.setattr(tvit, "_drop_path",
                        lambda x, r, train, g: tm(x, r, not train,
                                                  module="torch"))
    return jm, tm


@functools.lru_cache(maxsize=1)
def _jax_params():
    jm = jvit.vit_small_patch2_32(num_classes=NC, dtype=jnp.float32,
                                  use_fused_mlp=True, **ARCH)
    params = jax.jit(lambda k: jm.init(k, jnp.zeros((2, S, S, 3)),
                                       train=False))(jax.random.PRNGKey(1))
    # the flax init zeroes biases and tokens: perturb every weight
    return jax.tree_util.tree_map(
        lambda p: p + 0.02 * jnp.asarray(
            np.random.RandomState(p.size % 9973).randn(*p.shape), p.dtype),
        params["params"])


def _inputs():
    rs = np.random.RandomState(0)
    return (rs.randn(B, S, S, 3).astype(np.float32),
            rs.randn(B, NC).astype(np.float32))


def _port_grads(remat, drop_rate=0.0, use_flash=True, own_generator=True):
    """The gradients and the generator's state after the step: the
    trainer's own generator, or (``own_generator`` False) the global one."""
    tm = tvit.vit_small_patch2_32(num_classes=NC, dtype=torch.float32,
                                  use_fused_mlp=True, use_flash=use_flash,
                                  remat=remat, drop_rate=drop_rate, **ARCH)
    load_flax_params(tm, jax.device_get(_jax_params()))
    x, w = (torch.from_numpy(a) for a in _inputs())
    gen = torch.Generator().manual_seed(5) if own_generator else None
    with torch.random.fork_rng(devices=[]):  # the global state restored
        torch.manual_seed(5)
        out = tm(x, train=True, generator=gen)
        loss = (out["logits"] * w).sum()
        grads = torch.autograd.grad(loss, list(tm.parameters()))
        state = gen.get_state() if own_generator else torch.get_rng_state()
    names = [n for n, _ in tm.named_parameters()]
    return dict(zip(names, grads)), state


@pytest.mark.parametrize("drop_rate,use_flash,own_generator", [
    (0.0, True, True), (0.0, False, True), (0.2, False, True),
    (0.2, False, False)])
def test_remat_gradients_equal_the_unchecked_ones_bit_for_bit(
        monkeypatch, drop_rate, use_flash, own_generator):
    """Also with dropout inside the blocks (the unfused MLP and attention
    then draw inside the checkpointed region, from the given generator or
    the global one): the recompute replays it, and the generator ends
    where it would."""
    _, tmasks = _install(monkeypatch)
    off, g_off = _port_grads(False, drop_rate, use_flash, own_generator)
    assert tmasks.calls == 2
    on, g_on = _port_grads(True, drop_rate, use_flash, own_generator)
    assert tmasks.calls == 4  # the masks are drawn once, not recomputed
    assert torch.equal(g_on, g_off)
    for n in off:
        assert torch.equal(on[n], off[n]), n
    assert any(bool(g.abs().max() > 0) for g in on.values())


def test_remat_forward_runs_each_block_again_in_the_backward(monkeypatch):
    """The fused MLP of a checkpointed block runs once in the forward and
    once more in the backward; eval and no-grad forwards run it once."""
    from semireward_tpu_torch.ops import fused_mlp as F

    calls = []
    orig = F.fused_mlp

    def spy(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return orig(*a, **kw)

    monkeypatch.setattr(tvit, "fused_mlp", spy)
    tm = tvit.vit_small_patch2_32(num_classes=NC, dtype=torch.float32,
                                  use_fused_mlp=True, remat=True, **ARCH)
    x = torch.from_numpy(_inputs()[0])
    gen = torch.Generator().manual_seed(0)
    tm(x, train=True, generator=gen)["logits"].sum().backward()
    assert len(calls) == 4
    calls.clear()
    tm(x, train=False)
    with torch.no_grad():
        tm(x, train=True, generator=gen)
    assert len(calls) == 4


def test_remat_gradients_equal_jax_remat(monkeypatch):
    jmasks, tmasks = _install(monkeypatch)
    jm = jvit.vit_small_patch2_32(num_classes=NC, dtype=jnp.float32,
                                  use_fused_mlp=True, remat=True, **ARCH)
    x, w = _inputs()

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), train=True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return (out["logits"] * jnp.asarray(w)).sum()

    want = flax_to_torch(jax.device_get(jax.grad(loss)(_jax_params())))
    assert jmasks.calls == 2  # nn.remat traced each block once
    got, _ = _port_grads(True)
    assert sorted(got) == sorted(want)
    for n, g in got.items():
        assert_rel_close(g, want[n], 1e-4, n)


def test_other_builders_take_and_ignore_remat():
    """As in the JAX package, only the ViTs checkpoint; the WRN, ResNet-50,
    BERT and HuBERT builders take ``remat`` and build the same net."""
    def same(build, **kw):
        a = build(NC, dtype=torch.float32,
                  generator=torch.Generator().manual_seed(0), **kw)
        b = build(NC, dtype=torch.float32,
                  generator=torch.Generator().manual_seed(0), remat=True,
                  **kw)
        assert not any(getattr(m, "remat", False) for m in b.modules())
        for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
            assert torch.equal(p, q), n

    same(twrn.wrn_28_2, depth=10, widen_factor=1)
    same(tresnet.resnet50)
    same(tbert.bert_base_uncased, hidden=64, layers=1, heads=2,
         intermediate=128, use_fused_mlp=False)
    same(thubert.hubert_base, hidden=64, layers=1, heads=2,
         use_fused_mlp=False)
    vit = tvit.vit_small_patch2_32(NC, remat=True, **ARCH)
    assert all(blk.remat for blk in vit.blocks)
    # the JAX builders swallow it in **kw the same way
    assert not hasattr(jwrn.wrn_28_2(NC, remat=True), "remat")
    assert not hasattr(jresnet.resnet50(NC, remat=True), "remat")
    assert jvit.vit_small_patch2_32(num_classes=NC, remat=True).remat


def test_the_trainer_passes_gradient_checkpointing_to_the_net():
    from semireward_tpu_torch.config import get_config
    from semireward_tpu_torch.core.trainer import Trainer

    def trainer(remat):
        return Trainer(get_config(
            algorithm="fixmatch", net="vit_small_patch2_32",
            dataset="synthetic", num_classes=4, num_labels=8, batch_size=2,
            uratio=1, img_size=S, gradient_checkpointing=remat,
            use_pretrain=False, save_dir="unused",
            net_kwargs={k: v for k, v in ARCH.items() if k != "img_size"},
            synthetic_train=32, synthetic_test=8), device="cpu")

    assert all(b.remat for b in trainer(True).model.blocks)
    assert not any(b.remat for b in trainer(False).model.blocks)
