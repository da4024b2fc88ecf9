"""K4, the sharded kernel forms, across 4 gloo ranks on the CPU against the
JAX package's ``shard_map`` forms on 4 of its 8 CPU devices (their Pallas
kernels in interpret mode), on the same whole inputs:

- ``fused_mlp_sharded`` on 4 data ranks and ``fused_mlp_tp_sharded`` on 2 x
  2 data x model: each rank's output rows and its blocks of all five
  gradients (the weights' summed over the batch ranks as the step's sync
  sums them, where JAX's backward does; the TP hidden slices local)
  against the JAX form's, within
  ``test_torch_fused_mlp.py``'s float32 tolerance (1e-5 of the largest
  magnitude: f32 sums in another order, the TPU kernel's erf within
  1.5e-7);
- ``flash_attention_sharded`` with a key bias and dropout 0.1 on 4 batch
  ranks and on 2 x 2 batch x heads: each rank's output and gradients
  against the slice of JAX's, within ``test_torch_attention.py``'s f32
  tolerance (1e-5), and the keep mask its counter draws bit-equal to
  JAX's ``attention_keep_mask`` with the same offsets and to the slice of
  the unsharded mask.

One spawn of the 4 ranks runs every form (``_torch_mesh_ranks.k4_forms``,
no JAX in the ranks) while this process runs JAX's; it fails within its
90 s limit rather than hang.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import Ranks
from _torch_port import assert_rel_close
import _torch_mesh_ranks as R
from semireward_tpu.ops import attention as JA
from semireward_tpu.ops import fused_mlp as JF
from semireward_tpu.parallel import mesh as jmesh
from semireward_tpu_torch.ops import attention as TA

M, C, H = 32, 64, 256
AB, AN, AH, AD = 4, 128, 4, 64
RATE, SEED = 0.1, 1234
SHAPES = {"dp": ((4,), ("data",)), "tp": ((2, 2), ("data", "model")),
          "batch": ((4,), ("data",)),
          "batch_heads": ((2, 2), ("data", "model"))}


def _inputs():
    rs = np.random.RandomState(0)
    mlp = {"x": rs.randn(M, C), "w1": rs.randn(H, C) * 0.05,
           "b1": rs.randn(H) * 0.1, "w2": rs.randn(C, H) * 0.05,
           "b2": rs.randn(C) * 0.1, "g": rs.randn(M, C)}
    attn = {n: rs.randn(AB, AN, AH, AD) * (0.3 if n != "g" else 1.0)
            for n in ("q", "k", "v", "g")}
    lens = np.array([AN, 100, 37, 120])
    attn["bias"] = np.where(np.arange(AN)[None] < lens[:, None], 0.0,
                            -1e9)[:, None, None, :]
    mlp = {k: v.astype(np.float32) for k, v in mlp.items()}
    attn = {k: v.astype(np.float32) for k, v in attn.items()}
    attn.update(seed=SEED, rate=RATE)
    return mlp, attn


def _jmesh(name):
    shape, axes = SHAPES[name]
    return jmesh.build_mesh(shape, axes, devices=jax.devices()[:4])


def _jax_mlp(mlp, form):
    mesh = _jmesh(form)
    fn = JF.fused_mlp_sharded if form == "dp" else JF.fused_mlp_tp_sharded
    # the JAX layout: kernels [in, out]
    args = [jnp.asarray(a) for a in (mlp["x"], mlp["w1"].T, mlp["b1"],
                                     mlp["w2"].T, mlp["b2"])]

    @jax.jit
    def run(*a):
        y, vjp = jax.vjp(lambda *t: fn(*t, mesh=mesh, interpret=True), *a)
        return y, vjp(jnp.asarray(mlp["g"]))

    y, grads = run(*args)
    return [np.asarray(t) for t in (y, *grads)]


def _jax_attention(attn, form):
    mesh = _jmesh(form)
    q, k, v, g, bias = (jnp.asarray(attn[n]) for n in ("q", "k", "v", "g",
                                                       "bias"))

    @jax.jit
    def run(q, k, v):
        o, vjp = jax.vjp(lambda *t: JA.flash_attention_sharded(
            *t, bias=bias, dropout_rate=RATE, dropout_seed=SEED, mesh=mesh,
            interpret=True, force=True), q, k, v)
        return o, vjp(g)

    o, grads = run(q, k, v)
    return np.asarray(o), [np.asarray(t) for t in grads]


@pytest.fixture(scope="module")
def k4():
    """The ranks' blocks and JAX's whole results, computed here while the
    ranks run."""
    mlp, attn = _inputs()
    from concurrent.futures import ThreadPoolExecutor
    ranks = Ranks(R.k4_forms, 4, mlp, attn, timeout=90)
    # four compiles at once (XLA compiles without the GIL)
    jobs = [(_jax_mlp, mlp, "dp"), (_jax_mlp, mlp, "tp"),
            (_jax_attention, attn, "batch"),
            (_jax_attention, attn, "batch_heads")]
    with ThreadPoolExecutor(4) as pool:
        want = dict(zip((j[2] for j in jobs),
                        pool.map(lambda j: j[0](j[1], j[2]), jobs)))
    return mlp, attn, ranks.result(), want


def _coords(name, rank):
    shape, _ = SHAPES[name]
    return np.unravel_index(rank, shape) if len(shape) == 2 else (rank, 0)


@pytest.mark.parametrize("form", ["dp", "tp"])
def test_mlp_forms_match_jax(k4, form):
    _, _, ranks, want = k4
    y, dx, dw1, db1, dw2, db2 = want[form]
    n_rows = 4 if form == "dp" else 2
    rows = M // n_rows
    by_rank = [r[f"mlp_{form}"] for r in ranks]
    for rank, got in enumerate(by_rank):
        d, m = _coords(form, rank)
        r0 = d * rows
        hs = slice(None) if form == "dp" else slice(m * H // 2,
                                                    (m + 1) * H // 2)
        assert_rel_close(got["y"], y[r0:r0 + rows], 1e-5, f"{form} y")
        assert_rel_close(got["grads"][0], dx[r0:r0 + rows], 1e-5, f"{form} dx")
        # the weights' gradients after the step's sum over the batch ranks
        gw1, gb1, gw2, gb2 = got["synced"]
        assert_rel_close(gw1, dw1[:, hs].T, 1e-5, f"{form} dw1")
        assert_rel_close(gb1, db1[hs], 1e-5, f"{form} db1")
        assert_rel_close(gw2, dw2[hs, :].T, 1e-5, f"{form} dw2")
        assert_rel_close(gb2, db2, 1e-5, f"{form} db2")
        # the form itself left them local: the sync is their only sum
        peers = [r for r, _ in enumerate(by_rank)
                 if _coords(form, r)[1] == m]
        for local, synced in zip(zip(*(by_rank[r]["grads"][1:]
                                       for r in peers)), got["synced"]):
            assert_rel_close(sum(local), synced, 1e-6, f"{form} local")


@pytest.mark.parametrize("form", ["batch", "batch_heads"])
def test_attention_forms_match_jax(k4, form):
    _, _, ranks, want = k4
    o, grads = want[form]
    nb = 4 if form == "batch" else 2
    rows, hl = AB // nb, AH // (4 // nb)
    for rank, got in enumerate(r[f"attn_{form}"] for r in ranks):
        d, m = _coords(form, rank)
        blk = (slice(d * rows, (d + 1) * rows), slice(None),
               slice(m * hl, (m + 1) * hl))
        assert_rel_close(got["o"], o[blk], 1e-5, f"{form} out")
        for name, a, b in zip("qkv", got["grads"], grads):
            assert_rel_close(a, b[blk], 1e-5, f"{form} d{name}")


@pytest.mark.parametrize("form", ["batch", "batch_heads"])
def test_sharded_keep_masks_are_jax_bits(k4, form):
    _, _, ranks, _ = k4
    Np = TA.padded_len(AN)
    thresh = TA.keep_threshold(RATE)
    whole = np.asarray(JA.attention_keep_mask(
        jnp.int32(SEED), AB * AH, AN, Np, thresh)).reshape(AB, AH, AN, AN)
    nb = 4 if form == "batch" else 2
    rows, hl = AB // nb, AH // (4 // nb)
    for rank, got in enumerate(r[f"attn_{form}"] for r in ranks):
        d, m = _coords(form, rank)
        off = d * rows * AH + m * hl
        want = np.asarray(JA.attention_keep_mask(
            jnp.int32(SEED), rows * hl, AN, Np, thresh, bh_offset=off,
            local_heads=hl, head_stride=AH))
        np.testing.assert_array_equal(got["keep"], want)
        np.testing.assert_array_equal(
            got["keep"].reshape(rows, hl, AN, AN),
            whole[d * rows:(d + 1) * rows, m * hl:(m + 1) * hl])
