"""Multi-channel FM receiver (leanmlmrx equivalent) tests."""

import numpy as np

from leansdr_jax.pipelines.mlm_rx import (MlmReceiver, MlmConfig, Channel,
                                          resolve_rates)


def test_rate_resolution_defaults():
    cfg = MlmConfig()          # Fau=44100, maxdev=75e3
    fq, fau, decim = resolve_rates(cfg)
    assert decim == int(np.ceil(2 * 75e3 / 44100))
    assert fq == 44100 * decim


def test_fm_tone_demodulation():
    Fs, Fc = 25.6e6, 98e6
    cfg = MlmConfig(Fs=Fs, Fc=Fc, channels=[Channel(F=98.4e6)])
    rx = MlmReceiver(cfg)
    n = 1 << 21
    t = np.arange(n)
    tone = 1000.0
    phase = (2 * np.pi * (98.4e6 - Fc) * t / Fs
             + (75e3 / tone) * np.sin(2 * np.pi * tone * t / Fs))
    x = (1000 * np.exp(1j * phase)).astype(np.complex64)
    au = rx.process(x).astype(np.float64)
    assert len(au) > 3000
    w = au[500:500 + 2048] * np.hanning(2048)
    sp = np.abs(np.fft.rfft(w))
    f = np.fft.rfftfreq(2048, 1 / rx.Fau)
    peak = f[np.argmax(sp[5:]) + 5]
    assert abs(peak - tone) < 50, peak


def test_squelch_mutes_dead_channel():
    Fs, Fc = 25.6e6, 98e6
    cfg = MlmConfig(Fs=Fs, Fc=Fc, channels=[Channel(F=98.4e6)],
                    squelch=0.5)
    rx = MlmReceiver(cfg)
    rng = np.random.default_rng(0)
    # Pure noise: the discriminator output is full-scale random ->
    # rms stays high -> squelched.
    x = (rng.normal(size=1 << 18) + 1j * rng.normal(size=1 << 18)
         ).astype(np.complex64) * 100
    au = rx.process(x).astype(np.float64)
    assert np.abs(au).mean() < 5


def test_mlmrx_golden_vs_reference_binary(ref_mlmrx):
    """Golden against the reference leanmlmrx binary (built with
    tests/fftw_shim since the container lacks libfftw3f): identical
    synthetic 2-carrier FM capture through both CLIs; the mixed mono
    audio streams must be near-identical (channelizer weight matrix,
    discriminator, de-emphasis, audio decimation — leanmlmrx.cc:
    575-626, 686-745), and a muted '(...)' channel's tone must be
    absent from BOTH."""
    import subprocess
    import sys

    fs = 25.6e6
    dur = 0.4
    t = np.arange(int(fs * dur)) / fs

    def fm(foff, fmod, dev=75e3, amp=8000):
        ph = (2 * np.pi * foff * t
              + dev / fmod * (1 - np.cos(2 * np.pi * fmod * t)))
        return amp * np.exp(1j * ph)

    # Carriers at +-800 kHz (demodulated) and +1.6 MHz (present in the
    # capture but MUTED via '(...)' channel syntax).
    z = fm(800e3, 1000) + fm(-800e3, 2500) + fm(1.6e6, 3700)
    iq = np.empty((len(t), 2), np.int16)
    iq[:, 0] = np.round(z.real)
    iq[:, 1] = np.round(z.imag)
    args = ["--fs", "25.6e6", "--fc", "100e6", "-N", "64",
            "--fa", "44100", "100.8", "99.2", "(101.6)"]

    r_ref = subprocess.run([str(ref_mlmrx)] + args, input=iq.tobytes(),
                           capture_output=True, check=True)
    r_our = subprocess.run(
        [sys.executable, "-m", "leansdr_jax.apps.leanmlmrx"] + args,
        input=iq.tobytes(), capture_output=True, check=True)
    a = np.frombuffer(r_ref.stdout, np.int8).astype(np.float32)
    b = np.frombuffer(r_our.stdout, np.int8).astype(np.float32)
    m = min(len(a), len(b))
    assert m > 8000, (len(a), len(b))
    a, b = a[:m], b[:m]
    assert abs(a.std() - b.std()) < 0.1 * a.std(), (a.std(), b.std())

    # Peak normalized correlation over a small lag search (the two
    # pipelines have slightly different startup transients).
    mid = slice(m // 4, 3 * m // 4)
    best = max(float(np.corrcoef(a[mid], np.roll(b, lag)[mid])[0, 1])
               for lag in range(-40, 41))
    assert best > 0.99, best

    # Spectral golden: both carry the 1 kHz and 2.5 kHz tones; the
    # muted channel's 3.7 kHz tone appears in NEITHER.
    for name, au in (("ref", a), ("ours", b)):
        seg = au[mid] * np.hanning(mid.stop - mid.start)
        sp = np.abs(np.fft.rfft(seg))
        f = np.fft.rfftfreq(len(seg), 1 / 44100)

        def level(freq):
            return sp[(np.abs(f - freq) < 30)].max()

        floor = np.median(sp)
        assert level(1000) > 50 * floor, name
        assert level(2500) > 50 * floor, name
        assert level(3700) < 10 * floor, name
