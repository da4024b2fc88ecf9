"""On-device augmentation of the port against the JAX package, bit for bit:
every RandAugment op, Cutout, reflect-pad crop + flip (also against a numpy
np.pad reference), and whole weak/strong views. The two random streams
differ, so the draws are taken from the JAX key derivation and handed to the
port's deterministic apply functions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semireward_tpu.data.augment import ops as jops
from semireward_tpu.data.augment import pipeline as jpipe
from semireward_tpu_torch.data.augment import ops as tops
from semireward_tpu_torch.data.augment import pipeline as tpipe

B, S = 6, 16
SPEC_KW = dict(crop_size=S, crop_pad=2, mean=(0.5, 0.4, 0.3),
               std=(0.25, 0.2, 0.3), randaug_n=3)


def _images(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 256, (B, S, S, 3)).astype(np.uint8)
    x[1] = np.clip(x[1] // 4 + 100, 0, 255)        # low contrast
    x[2] = x[2] // 64 * 64                         # few levels
    x[3, :, :, 1] = 7                              # a flat channel
    return x


@pytest.mark.parametrize("op,lo,hi", jpipe._FULL_OPS,
                         ids=[op.__name__ for op, _, _ in jpipe._FULL_OPS])
def test_op_bit_exact(op, lo, hi):
    x = _images().astype(np.float32)
    v = np.random.RandomState(1).uniform(lo, hi, B).astype(np.float32)
    want = np.asarray(jax.vmap(op)(jnp.asarray(x), jnp.asarray(v)))
    got = getattr(tops, op.__name__)(torch.from_numpy(x), torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_cutout_draws(keys, H, W):
    xs, ys = [], []
    for k in keys:
        kx, ky = jax.random.split(k)
        xs.append(float(jax.random.uniform(kx, (), minval=0.0, maxval=W)))
        ys.append(float(jax.random.uniform(ky, (), minval=0.0, maxval=H)))
    return (torch.tensor(xs, dtype=torch.float32),
            torch.tensor(ys, dtype=torch.float32))


def test_cutout_bit_exact():
    x = _images().astype(np.float32)
    v = np.random.RandomState(2).uniform(0, S / 2, B).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    want = np.asarray(jax.vmap(jops.cutout_abs)(jnp.asarray(x),
                                                jnp.asarray(v), keys))
    cx, cy = _jax_cutout_draws(keys, S, S)
    got = tops.cutout_abs(torch.from_numpy(x), torch.from_numpy(v), cx, cy)
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_crop_draws(rng, pad):
    keys = jax.random.split(rng, B)
    oy, ox, fl = [], [], []
    for k in keys:
        kx, ky, kf = jax.random.split(k, 3)
        oy.append(int(jax.random.randint(ky, (), 0, 2 * pad + 1)))
        ox.append(int(jax.random.randint(kx, (), 0, 2 * pad + 1)))
        fl.append(bool(jax.random.bernoulli(kf, 0.5)))
    return tpipe.CropDraws(torch.tensor(oy), torch.tensor(ox),
                           torch.tensor(fl))


def test_crop_flip_matches_jax_and_numpy_pad():
    x = _images()
    pad = SPEC_KW["crop_pad"]
    rng = jax.random.PRNGKey(4)
    want = np.asarray(jpipe._crop_flip_batch(rng, jnp.asarray(x, jnp.float32),
                                             pad, True))
    d = _jax_crop_draws(rng, pad)
    got = tpipe.crop_flip(torch.from_numpy(x).float(), pad, d).numpy()
    np.testing.assert_array_equal(got, want)
    for i in range(B):
        p = np.pad(x[i], ((pad, pad), (pad, pad), (0, 0)), mode="reflect")
        ref = p[int(d.oy[i]):int(d.oy[i]) + S, int(d.ox[i]):int(d.ox[i]) + S]
        if d.flip[i]:
            ref = ref[:, ::-1]
        np.testing.assert_array_equal(got[i], ref.astype(np.float32))
    assert 0 < int(d.flip.sum()) < B


def test_weak_view_bit_exact():
    x = _images(5)
    spec_j = jpipe.AugmentSpec(**SPEC_KW)
    rng = jax.random.PRNGKey(6)
    want = np.asarray(jpipe.weak_augment(rng, jnp.asarray(x), spec_j))
    got = tpipe.weak_augment(torch.from_numpy(x),
                             tpipe.AugmentSpec(**SPEC_KW),
                             _jax_crop_draws(rng, SPEC_KW["crop_pad"]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [7, 8])
def test_strong_view_bit_exact(seed):
    """crop/flip + 3 RandAugment rounds + Cutout + normalize, with the draws
    of jpipe.randaugment's key derivation."""
    x = _images(seed)
    spec_j = jpipe.AugmentSpec(**SPEC_KW)
    rng = jax.random.PRNGKey(seed)
    want = np.asarray(jpipe.randaugment(rng, jnp.asarray(x), spec_j))

    k1, k2 = jax.random.split(rng)
    dc = _jax_crop_draws(k1, SPEC_KW["crop_pad"])
    k = len(jpipe._FULL_OPS)
    ops_, us = [], []
    r = k2
    for _ in range(SPEC_KW["randaug_n"]):
        r, kop, kval = jax.random.split(r, 3)
        ops_.append(np.asarray(jax.random.randint(kop, (B,), 0, k)))
        us.append(np.asarray(jax.random.uniform(kval, (B,))))
    r, kcv, kcut = jax.random.split(r, 3)
    cut_v = np.asarray(jax.random.uniform(kcv, (B,)) * 0.5 * S)
    cx, cy = _jax_cutout_draws(jax.random.split(kcut, B), S, S)
    dr = tpipe.RandAugDraws(torch.tensor(np.stack(ops_)).long(),
                            torch.tensor(np.stack(us)), torch.tensor(cut_v),
                            cx, cy)
    got = tpipe.strong_augment(torch.from_numpy(x),
                               tpipe.AugmentSpec(**SPEC_KW), dc, dr)
    np.testing.assert_array_equal(got.numpy(), want)


def test_augment_views_shapes_and_draw_ranges():
    x = torch.from_numpy(_images())
    g = torch.Generator().manual_seed(0)
    spec = tpipe.AugmentSpec(**SPEC_KW)
    views = tpipe.augment_views(x, x, spec, ("x_lb", "x_ulb_w", "x_ulb_s"), g)
    assert set(views) == {"x_lb", "x_ulb_w", "x_ulb_s"}
    for v in views.values():
        assert v.shape == (B, S, S, 3) and v.dtype == torch.float32
        assert torch.isfinite(v).all()
    d = tpipe.draw_randaug(1000, spec, g, "cpu")
    assert int(d.op_idx.min()) == 0 and int(d.op_idx.max()) == 13
    assert float(d.cut_v.max()) < S / 2 and float(d.cut_x.max()) < S
