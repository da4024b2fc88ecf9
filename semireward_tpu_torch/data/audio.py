"""Audio datasets and on-device waveform augmentation (port of
``semireward_tpu/data/audio.py``).

- pickle-per-split loaders (``{train,dev,test}.pkl`` of ``(wave, label)``),
  numpy only, so both packages load the same waves;
- weak view = the collator's random crop to ``max_length_seconds`` (the
  on-device leg is the identity);
- collator pads/crops to the static ``max_length_seconds * sample_rate``
  bucket, with the crop starts drawn from the caller's ``RandomState`` in
  the JAX collator's order, so both give the same batches;
- strong view = the reference's sox chain (two of gain -n / pitch / speed /
  reverb -w, drawn with replacement), split in two as the CV augmentation
  is (``data/augment``): :func:`draw_strong_wave` draws speed, pitch cents,
  the truncated attenuation and two effect ids per sample from a
  ``torch.Generator``, and :func:`apply_strong_wave` applies them on the
  device. The tests hand both packages the same draws.

The resampler is the JAX package's 32-tap Nuttall-windowed sinc, evaluated
per output sample (the JAX file's banded Hankel-window layout is a TPU
gather workaround that computes the same filter). Both reverbs are one
``torch.fft`` convolution against an impulse response computed once per
buffer length on the host with scipy: sox reverb.c's exact filter (the JAX
trainer's default, ``audio_exact_reverb True``) or the JAX package's fast
filter (``audio_exact_reverb False``: the same combs without their
HF-damping pole, which the JAX file solves with an associative scan; the
filter is linear and time-invariant, so its impulse response gives the
same output).
"""
from __future__ import annotations

import functools
import math
import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from semireward_tpu_torch import rng


@dataclass
class AudioDataset:
    waves: List[np.ndarray]
    targets: np.ndarray

    @property
    def data(self):
        return self.waves

    def __len__(self):
        return len(self.waves)


def load_pkl_dataset(data_dir: str, name: str):
    """reference audio_datasets/pkl_data.py."""
    base = os.path.join(data_dir, name)
    out = {}
    for split in ("train", "dev", "test"):
        with open(os.path.join(base, f"{split}.pkl"), "rb") as f:
            d = pickle.load(f)
        waves = [np.asarray(w, np.float32) for w, _ in d]
        ys = np.asarray([y for _, y in d], np.int64)
        out[split] = AudioDataset(waves, ys)
    return out


def crop_pad_f32(waves, starts, T: int) -> np.ndarray:
    """Batched crop / zero-pad of variable-length float32 waveforms to
    ``[n, T]`` from ``starts`` (the JAX package's native ``crop_pad_f32``)."""
    out = np.zeros((len(waves), T), np.float32)
    for i, w in enumerate(waves):
        s = int(starts[i])
        seg = w[s:s + T]
        out[i, :len(seg)] = seg
    return out


class AudioCollator:
    """Fixed-bucket batching: random crop (train, a ``RandomState`` given) or
    the first ``T`` samples (eval) of each clip, zero-padding shorter clips;
    float32 ``[B, T]`` (reference audio_collactor.py pads to
    ``max_length_seconds * sr``)."""

    def __init__(self, max_length_seconds: float = 4.0,
                 sample_rate: int = 16000):
        self.T = int(max_length_seconds * sample_rate)

    def __call__(self, waves, rng: Optional[np.random.RandomState] = None):
        starts = np.zeros(len(waves), np.int64)
        if rng is not None:
            for i, w in enumerate(waves):
                if len(w) > self.T:
                    starts[i] = rng.randint(0, len(w) - self.T + 1)
        return crop_pad_f32(waves, starts, self.T)


def weak_augment_wave(batch):
    """Weak = the random crop already applied by the collator."""
    return batch


def get_audio_dataset(cfg, alg: str = "fixmatch"):
    from semireward_tpu_torch.data.split import sample_labeled_unlabeled_data

    splits = load_pkl_dataset(cfg.data_dir, cfg.dataset)
    train = splits["train"]
    rng = np.random.RandomState(cfg.seed)
    lb_i, ulb_i = sample_labeled_unlabeled_data(
        train.targets, cfg.num_classes, cfg.num_labels,
        ulb_num_labels=cfg.ulb_num_labels, rng=rng)
    if cfg.include_lb_to_ulb:
        ulb_i = np.concatenate([lb_i, ulb_i])

    def sub(ds, idx):
        return AudioDataset([ds.waves[i] for i in idx], ds.targets[idx])

    return {"train_lb": sub(train, lb_i), "train_ulb": sub(train, ulb_i),
            "eval": splits["dev"], "test": splits["test"]}


def write_synthetic_corpus(data_dir: str, name: str = "esc50",
                           num_classes: int = 50, seed: int = 0,
                           sample_rate: int = 16000,
                           sizes=(("train", 600), ("dev", 160),
                                  ("test", 32))) -> str:
    """Write a seeded corpus in the ESC-50 pickle layout
    (``<data_dir>/<name>/{train,dev,test}.pkl``, lists of ``(wave,
    label)``) and return its folder.

    Clips last 3 to 7 s (uniform, so about a quarter are shorter than the
    4 s bucket and take the pad path) at ``sample_rate``. A clip of class
    ``c`` is two tones at class frequencies (log-spaced over 120 Hz - 6 kHz,
    the second a fifth above the first) with a class-specific amplitude
    modulation rate, random phases and levels, in white noise at about
    10 dB SNR, so the label can be heard. The default sizes give 250
    labeled train clips (5 per class at 50 classes) plus an unlabeled pool
    of 350. The marker ``_complete`` is written last; a finished corpus is
    kept as it is."""
    base = os.path.join(data_dir, name)
    if os.path.exists(os.path.join(base, "_complete")):
        return base
    os.makedirs(base, exist_ok=True)
    rs = np.random.RandomState(seed)
    freqs = 120.0 * (6000.0 / 120.0) ** (np.arange(num_classes)
                                         / max(num_classes - 1, 1))
    am = 1.0 + 7.0 * (np.arange(num_classes) % 8) / 7.0
    for split, count in sizes:
        items = []
        for i in range(count):
            y = i % num_classes if split == "train" else int(
                rs.randint(num_classes))
            n = int(rs.uniform(3.0, 7.0) * sample_rate)
            t = np.arange(n) / sample_rate
            ph = rs.uniform(0, 2 * np.pi, 3)
            tone = (np.sin(2 * np.pi * freqs[y] * t + ph[0])
                    + 0.5 * np.sin(2 * np.pi * 1.5 * freqs[y] * t + ph[1]))
            tone *= 0.6 + 0.4 * np.sin(2 * np.pi * am[y] * t + ph[2])
            wave = rs.uniform(0.1, 0.5) * tone + 0.05 * rs.randn(n)
            items.append((wave.astype(np.float32), y))
        with open(os.path.join(base, f"{split}.pkl"), "wb") as f:
            pickle.dump(items, f, protocol=4)
    open(os.path.join(base, "_complete"), "w").close()
    return base


# ---------------------------------------------------------------------------
# on-device waveform transforms (strong view)
# ---------------------------------------------------------------------------

_SINC_TAPS = 32
# Nuttall continuous-first-derivative window: value and slope vanish at the
# edges, sidelobes ~-93 dB
_NUTTALL = (0.355768, 0.487396, 0.144232, 0.012604)


def _resample_sinc(x, rate):
    """Nuttall-windowed-sinc resample of each row of ``x [B, T]`` by its
    ``rate [B]`` (same length out, content plays faster for rate > 1,
    zero tail): output t reads the source at ``pos = t * rate`` through the
    32 taps ``s = floor(pos) - 15 .. floor(pos) + 16`` with weight
    ``cut * sinc(cut * (s - pos)) * nuttall((s - pos) / 16)`` where
    ``|s - pos| < 16`` (else 0), ``cut = min(1, 1 / rate)``, renormalized to
    unit DC gain; sources outside ``[0, T)`` read zeros, and outputs with
    ``pos >= T - 1`` are zero. Float32, as the JAX version."""
    B, T = x.shape
    half = _SINC_TAPS // 2
    rate = rate.to(torch.float32).reshape(B, 1)
    pos = torch.arange(T, device=x.device, dtype=torch.float32)[None] * rate
    base = torch.floor(pos) - (half - 1)                      # [B, T]
    taps = torch.arange(_SINC_TAPS, device=x.device, dtype=torch.float32)
    src = base[..., None] + taps                              # [B, T, K]
    off = src - pos[..., None]
    cut = torch.clamp(1.0 / rate, max=1.0)[..., None]         # [B, 1, 1]
    a0, a1, a2, a3 = _NUTTALL
    c = torch.cos(math.pi * torch.clamp(off / half, -1.0, 1.0))
    win = torch.where(off.abs() < half,
                      (a0 - a2) + (a1 - 3 * a3) * c + 2 * a2 * c * c
                      + 4 * a3 * c * c * c, torch.zeros_like(off))
    w = cut * torch.sinc(cut * off) * win
    w = w / w.sum(-1, keepdim=True)
    idx = src.long()
    inside = (idx >= 0) & (idx < T)
    xs = torch.gather(x.float(), 1, idx.clamp(0, T - 1).reshape(B, -1))
    xs = torch.where(inside, xs.reshape(B, T, _SINC_TAPS), 0.0)
    y = (w * xs).sum(-1)
    return torch.where(pos < T - 1, y, torch.zeros_like(y))


def _sox_gain_n(x, att):
    """``gain -n <att>``: normalize each row's peak to ``att`` dBFS."""
    peak = x.abs().amax(-1, keepdim=True) + 1e-9
    return x / peak * (10.0 ** (att.reshape(-1, 1) / 20.0))


# sox `reverb` (reverb.c, the Freeverb structure with sox's own parameter
# mappings): 8 parallel feedback combs with a one-pole HF-damping lowpass
# inside the loop, then 4 series Freeverb allpasses; delays quoted at
# 44.1 kHz, scaled by sample rate and room scale; every parameter at its sox
# default, wet-only output (reference datasetbase.py applies bare
# `reverb -w`).
_SR = 16000
_COMB_DELAYS_44K = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
_ALLPASS_DELAYS_44K = (225, 341, 441, 556)


def _sox_reverb_constants(reverberance=50.0, hf_damping=50.0,
                          room_scale=100.0, wet_gain_db=0.0):
    a = -1.0 / math.log(1.0 - 0.3)
    b = 100.0 / (math.log(1.0 - 0.98) * a + 1.0)
    feedback = 1.0 - math.exp((reverberance - b) / (a * b))
    damping = hf_damping / 100.0 * 0.3 + 0.2
    scale = room_scale / 100.0 * 0.9 + 0.1
    gain = 0.015 * 10.0 ** (wet_gain_db / 20.0)
    return feedback, damping, scale, gain


@functools.lru_cache(maxsize=8)
def _reverb_ir_rfft(T: int, sr: int = _SR, exact: bool = True):
    """(rfft of the length-T wet impulse response, fft length L), computed
    once per buffer length on the host with scipy.lfilter in float64.
    ``exact``: sox's difference equations (comb: H = z^-d (1 - damp z^-1) /
    (1 - damp z^-1 - f (1 - damp) z^-d)); else the JAX package's fast
    filter (``_sox_reverb_wet``: comb y[t] = x[t-d] + f y[t-d], H = z^-d /
    (1 - f z^-d)). Allpass either way: H = (1.5 z^-d - 1) / (1 - 0.5 z^-d).
    L >= 2T - 1 makes the circular convolution linear for the first T
    outputs."""
    from scipy.signal import lfilter

    f, damp, scale, gain = _sox_reverb_constants()
    imp = np.zeros(T, np.float64)
    imp[0] = 1.0
    h = np.zeros(T, np.float64)
    for d44 in _COMB_DELAYS_44K:
        d = max(1, int(d44 * scale * sr / 44100.0 + 0.5))
        num = np.zeros(d + 2)
        num[d] = 1.0
        den = np.zeros(d + 1)
        den[0] = 1.0
        if exact:
            num[d + 1] = -damp
            den[1] = -damp
            den[d] += -f * (1.0 - damp)
        else:
            den[d] = -f
        h += lfilter(num, den, imp)
    for d44 in _ALLPASS_DELAYS_44K:
        d = max(1, int(d44 * scale * sr / 44100.0 + 0.5))
        num = np.zeros(d + 1)
        num[0] = -1.0
        num[d] = 1.5
        den = np.zeros(d + 1)
        den[0] = 1.0
        den[d] = -0.5
        h = lfilter(num, den, h)
    h *= gain
    L = 1 << max(1, (2 * T - 1)).bit_length()
    return np.fft.rfft(h, L).astype(np.complex64), L


_ir_on_device: Dict = {}


def _reverb_wet(x, exact: bool):
    """One rfft / irfft pair per row of ``x`` against the precomputed
    impulse-response spectrum (``_reverb_ir_rfft``)."""
    T = x.shape[-1]
    key = (T, str(x.device), exact)
    if key not in _ir_on_device:
        Hf, L = _reverb_ir_rfft(T, exact=exact)
        _ir_on_device[key] = (torch.from_numpy(Hf).to(x.device), L)
    Hf, L = _ir_on_device[key]
    y = torch.fft.irfft(torch.fft.rfft(x.float(), n=L) * Hf, n=L)
    return y[..., :T].to(x.dtype)


def _sox_reverb_wet_exact(x):
    """``reverb -w`` (wet only), sox reverb.c's exact filter."""
    return _reverb_wet(x, exact=True)


def _sox_reverb_wet(x):
    """``reverb -w`` (wet only), the JAX package's fast filter: sox's
    feedback 0.8818 and allpasses, the combs without their HF-damping pole
    (high frequencies ring longer than sox's; JAX's
    ``tests/test_modalities.py::TestSoxEffectKernels::
    test_fast_reverb_bounded_vs_exact`` bounds the difference)."""
    return _reverb_wet(x, exact=False)


def draw_strong_wave(generator: torch.Generator, B: int, device=None
                     ) -> Dict[str, torch.Tensor]:
    """The strong view's random draws for ``B`` clips (reference
    WaveformTransforms, datasetbase.py:12-39): speed in [0.5, 2.0), pitch in
    [-2, 2) cents, the attenuation ``trunc(uniform(-5, 5))`` dBFS (Python's
    ``int()`` of the reference, so -5 never occurs and 0 has double mass),
    and two effect ids in 0..3 (gain, pitch, speed, reverb; with
    replacement) per clip."""
    u = rng.rand(3, B, generator=generator, device=device, rows=1)
    return {"speed": 0.5 + 1.5 * u[0],
            "pitch_cents": -2.0 + 4.0 * u[1],
            "atten_db": torch.trunc(-5.0 + 10.0 * u[2]),
            "choice": rng.randint(0, 4, (B, 2), generator=generator,
                                  device=device, rows=0)}


def _apply_one(x, c, sp, pc, att, reverb):
    rate = torch.where(c == 1, 2.0 ** (pc / 1200.0),
                       torch.where(c == 2, sp, torch.ones_like(sp)))
    res = _resample_sinc(x, rate)
    c = c.reshape(-1, 1)
    # every effect for every clip, then a select: no host sync on the ids
    out = torch.where(c == 0, _sox_gain_n(x, att), res)
    return torch.where(c == 3, reverb(x), out)


def apply_strong_wave(batch: torch.Tensor, draws: Dict[str, torch.Tensor],
                      exact_reverb: bool = True) -> torch.Tensor:
    """Apply the two drawn effects of each clip, in draw order, to
    ``batch [B, T]`` float32 on its device (JAX ``strong_augment_wave``):
    gain -n normalizes the peak to the drawn dBFS; pitch is one resample at
    ``2^(cents/1200)``; speed one resample at the drawn speed (the trailing
    ``rate`` of the sox chain leaves the 1/speed duration change in the
    fixed buffer); reverb -w is the exact sox filter, or with
    ``exact_reverb`` False the JAX package's fast one."""
    reverb = _sox_reverb_wet_exact if exact_reverb else _sox_reverb_wet
    x = batch.float()
    for slot in range(2):
        x = _apply_one(x, draws["choice"][:, slot], draws["speed"],
                       draws["pitch_cents"], draws["atten_db"], reverb)
    return x
