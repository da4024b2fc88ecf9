"""The port's audio data (``data/audio.py``, ``data/modality.py``) against the
JAX package.

- ``AudioCollator`` and ``AudioSSLLoader`` batches are bit-equal to JAX's
  (the same RandomState calls for the crop starts, the same crop/pad).
- Each strong effect (the 32-tap sinc resampler at several rates, ``gain
  -n``, the exact sox reverb) and the two-slot chain of
  ``strong_augment_wave``, with the draws computed from a JAX key the way
  ``strong_augment_wave`` computes them and handed to the port's
  ``apply_strong_wave``, against JAX's output on the same waves: within
  1e-4 of max|JAX| (float32 on both sides, sums in another order, sinc,
  cosine and FFT implementations that differ in the last bits; measured
  4e-7 in most runs, but one run of the file in eighteen on this CPU put
  54 of 6400 resampled samples 3e-5 of max|JAX| apart, and the cause was
  not found: each side gives the same bits run after run in one process).
- The fast reverb (``audio_exact_reverb False``) against JAX's
  ``_sox_reverb_wet`` within 1e-5, its chain at the chain's tolerance, and
  against the exact reverb within the bound of JAX's own test.
- The seeded synthetic corpus round-trips through both packages'
  ``load_pkl_dataset`` and ``get_audio_dataset``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semireward_tpu.config import get_config as jax_config
from semireward_tpu.data import audio as jaudio
from semireward_tpu.data import modality as jmodality
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.data import audio as taudio
from semireward_tpu_torch.data import modality as tmodality

T, B = 1600, 4
RATES = (0.5, 0.77, 1.0, 1.003, 1.9)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()) + 1e-12)


def _clips(n=12, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(int(rs.randint(T // 2, 3 * T))) * 0.3).astype(np.float32)
            for _ in range(n)]


def test_collator_batches_are_bit_equal():
    waves = _clips()
    jcol, tcol = jaudio.AudioCollator(0.1, 16000), taudio.AudioCollator(0.1, 16000)
    assert jcol.T == tcol.T == T
    for seed in (0, 1):
        want = jcol(waves, np.random.RandomState(seed))
        got = tcol(waves, np.random.RandomState(seed))
        assert got.dtype == np.float32 and got.shape == (len(waves), T)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcol(waves), jcol(waves))   # eval: no crop


def test_ssl_loader_batches_are_bit_equal():
    waves = _clips(20)
    ys = np.arange(20) % 5
    splits_j = {"train_lb": jaudio.AudioDataset(waves[:8], ys[:8]),
                "train_ulb": jaudio.AudioDataset(waves[8:], ys[8:])}
    splits_t = {"train_lb": taudio.AudioDataset(waves[:8], ys[:8]),
                "train_ulb": taudio.AudioDataset(waves[8:], ys[8:])}
    keys = ("x_lb", "y_lb", "idx_ulb", "x_ulb_w", "x_ulb_s")
    jl = jmodality.AudioSSLLoader(splits_j, jaudio.AudioCollator(0.1), 3, 3,
                                  keys, seed=5)
    tl = tmodality.AudioSSLLoader(splits_t, taudio.AudioCollator(0.1), 3, 3,
                                  keys, seed=5)
    for _ in range(6):
        want, got = next(jl), next(tl)
        assert sorted(got) == sorted(want)
        assert "x_ulb_s_base" in got and "x_ulb_s" not in got
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_draws(key):
    """The draws of ``strong_augment_wave`` from ``key``, computed as it
    computes them."""
    keys = jax.random.split(key, 5)
    return {"speed": jax.random.uniform(keys[0], (B,), minval=0.5, maxval=2.0),
            "pitch_cents": jax.random.uniform(keys[1], (B,), minval=-2.0,
                                              maxval=2.0),
            "atten_db": jnp.trunc(jax.random.uniform(keys[2], (B,), minval=-5.0,
                                                     maxval=5.0)),
            "choice": jax.random.randint(keys[3], (B, 2), 0, 4)}


@jax.jit
def _jax_effects(x, key):
    """Every JAX effect in one compiled program: the chain from ``key``, the
    resampler at each of RATES, gain -n at -3 dBFS, the exact reverb."""
    res = jnp.stack([jax.vmap(lambda w: jaudio._resample_sinc(w, r))(x)
                     for r in RATES])
    gain = jax.vmap(lambda w: jaudio._sox_gain_n(w, None, None, -3.0))(x)
    rev = jax.vmap(jaudio._sox_reverb_wet_exact)(x)
    return jaudio.strong_augment_wave(key, x), res, gain, rev, _jax_draws(key)


@pytest.mark.parametrize("seed", [3, 11])
def test_strong_effects_and_chain_match_jax(seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(B, T) * 0.3).astype(np.float32)
    x[-1, T // 3:] = 0.0                           # a padded clip
    chain, res, gain, rev, draws = jax.device_get(
        _jax_effects(jnp.asarray(x), jax.random.PRNGKey(seed)))
    tx = torch.from_numpy(x)
    for r, want in zip(RATES, res):
        _close(taudio._resample_sinc(tx, torch.full((B,), r)).numpy(), want)
    _close(taudio._sox_gain_n(tx, torch.full((B,), -3.0)).numpy(), gain)
    _close(taudio._sox_reverb_wet_exact(tx).numpy(), rev)
    tdraws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    tdraws["choice"] = tdraws["choice"].long()
    _close(taudio.apply_strong_wave(tx, tdraws).numpy(), chain)


def test_draws_have_the_reference_support_and_fast_reverb_waits():
    from semireward_tpu_torch.core.trainer import Trainer

    d = taudio.draw_strong_wave(torch.Generator().manual_seed(0), 4000)
    assert 0.5 <= float(d["speed"].min()) and float(d["speed"].max()) < 2.0
    assert -2.0 <= float(d["pitch_cents"].min()) < float(d["pitch_cents"].max()) < 2.0
    att = d["atten_db"].long()
    assert set(att.tolist()) == set(range(-4, 5))   # trunc: -5 never, 0 twice
    assert abs(float((att == 0).float().mean()) - 0.2) < 0.03
    assert set(d["choice"].flatten().tolist()) == {0, 1, 2, 3}
    # the fast reverb is ported: the config passes the trainer's checks
    # and reaches the loader, which reads the (missing) local corpus
    cfg = torch_config(net="hubert_base", dataset="esc50", data_dir="/nowhere",
                       audio_exact_reverb=False)
    with pytest.raises(FileNotFoundError, match="esc50"):
        Trainer(cfg, device="cpu")


@jax.jit
def _jax_fast(x, key):
    return (jax.vmap(jaudio._sox_reverb_wet)(x),
            jaudio.strong_augment_wave(key, x, exact_reverb=False),
            _jax_draws(key))


def test_fast_reverb_and_its_chain_match_jax():
    """The fast reverb (one FFT convolution against the fast filter's
    impulse response) against JAX's associative-scan ``_sox_reverb_wet``
    within 1e-5 of max|JAX| (measured 2e-7: float64 response, float32
    FFT, against JAX's float32 scan), and the chain with
    ``exact_reverb=False`` against JAX's at the chain's tolerance."""
    rs = np.random.RandomState(7)
    x = (rs.randn(B, T) * 0.3).astype(np.float32)
    rev, chain, draws = jax.device_get(_jax_fast(jnp.asarray(x),
                                                 jax.random.PRNGKey(7)))
    assert (np.asarray(draws["choice"]) == 3).any()   # a reverb is drawn
    tx = torch.from_numpy(x)
    _close(taudio._sox_reverb_wet(tx).numpy(), rev, 1e-5)
    tdraws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    tdraws["choice"] = tdraws["choice"].long()
    _close(taudio.apply_strong_wave(tx, tdraws, exact_reverb=False).numpy(),
           chain)
    assert not np.allclose(taudio.apply_strong_wave(tx, tdraws).numpy(),
                           chain, atol=1e-3)


def test_fast_reverb_is_bounded_by_jaxs_test_against_the_exact_one():
    """The bound of JAX's ``tests/test_modalities.py::TestSoxEffectKernels::
    test_fast_reverb_bounded_vs_exact`` on the port's two reverbs: the same
    first echo (sample 405), the octave-band energies of the impulse
    responses within its factors, the broadband energy within 4x."""
    x = torch.zeros(1, 16000)
    x[0, 0] = 1.0
    h_fast = taudio._sox_reverb_wet(x)[0].numpy()
    h_exact = taudio._sox_reverb_wet_exact(x)[0].numpy()
    assert np.nonzero(np.abs(h_fast) > 1e-6)[0][0] == 405
    assert np.nonzero(np.abs(h_exact) > 1e-6)[0][0] == 405
    Hf, He = np.abs(np.fft.rfft(h_fast)), np.abs(np.fft.rfft(h_exact))
    freqs = np.fft.rfftfreq(16000, 1 / 16000)
    for (lo, hi), top in zip([(62, 250), (250, 1000), (1000, 4000),
                              (4000, 8000)], (2.0, 3.0, 5.0, 8.0)):
        sel = (freqs >= lo) & (freqs < hi)
        ratio = float((Hf[sel] ** 2).sum() / (He[sel] ** 2).sum())
        assert 0.8 < ratio < top, (lo, hi, ratio)
    tot = float((h_fast ** 2).sum() / (h_exact ** 2).sum())
    assert 0.5 < tot < 4.0, tot


def test_synthetic_corpus_round_trips_through_both_loaders(tmp_path):
    root = taudio.write_synthetic_corpus(
        str(tmp_path), "esc50", num_classes=5,
        sizes=(("train", 40), ("dev", 10), ("test", 4)))
    assert taudio.write_synthetic_corpus(str(tmp_path), "esc50", 5) == root
    jsplits = jaudio.load_pkl_dataset(str(tmp_path), "esc50")
    tsplits = taudio.load_pkl_dataset(str(tmp_path), "esc50")
    for split in ("train", "dev", "test"):
        np.testing.assert_array_equal(tsplits[split].targets,
                                      jsplits[split].targets)
        for a, b in zip(tsplits[split].waves, jsplits[split].waves):
            np.testing.assert_array_equal(a, b)
    lens = np.array([len(w) for w in tsplits["train"].waves]) / 16000
    assert lens.min() < 4.0 < lens.max() and 3.0 <= lens.min()
    kw = dict(dataset="esc50", data_dir=str(tmp_path), num_classes=5,
              num_labels=10, net="hubert_base")
    jd = jaudio.get_audio_dataset(jax_config(**kw))
    td = taudio.get_audio_dataset(torch_config(**kw))
    for k in ("train_lb", "train_ulb", "eval"):
        np.testing.assert_array_equal(td[k].targets, jd[k].targets)
        assert len(td[k]) == len(jd[k])
    assert np.bincount(td["train_lb"].targets).tolist() == [2] * 5
