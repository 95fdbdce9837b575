"""Batched device preprocessing (dsp/blocks_device.py) vs the
single-channel host blocks (dsp/blocks.py) — same streams, same
decimation phase, per-channel parity."""

import numpy as np
import pytest

from leansdr_jax.dsp import blocks, blocks_device


def _streams(C, n, seed=0, tones=None):
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
         ).astype(np.complex64)
    if tones:
        t = np.arange(n)
        for c, (f, a) in enumerate(tones):
            z[c] += a * np.exp(2j * np.pi * f * t).astype(np.complex64)
    return z


def _planes(z):
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)


def test_batched_spectrum_matches_host():
    C, n = 3, 6 * 1024
    z = _streams(C, n)
    batched = blocks_device.BatchedSpectrum(C, decimation=1024)
    lines_b = batched.process(_planes(z))
    for c in range(C):
        host = blocks.Spectrum(decimation=1024)
        lines_h = host.process(z[c])
        assert len(lines_b) == len(lines_h)
        for lb, lh in zip(lines_b, lines_h):
            np.testing.assert_allclose(lb[c], lh, atol=0.05)  # dB


def test_batched_cnr_matches_host():
    C, n = 2, 3 * 4096
    # Narrowband "carrier" at different offsets per channel.
    z = _streams(C, n, tones=[(0.01, 8.0), (-0.03, 6.0)])
    taps = np.array([0.01, -0.03], np.float32)
    batched = blocks_device.BatchedCnrFft(C, bandwidth=0.2,
                                          decimation=4096)
    out_b = batched.process(_planes(z), taps)
    for c in range(C):
        host = blocks.CnrFft(bandwidth=0.2, decimation=4096)
        out_h = host.process(z[c], float(taps[c]))
        assert len(out_b) == len(out_h)
        for vb, vh in zip(out_b, out_h):
            assert abs(vb[c] - vh) < 0.1, (c, vb[c], vh)


def test_batched_autonotch_matches_host():
    C, n = 2, 2 * 4096
    # Strong birdies at exact bin centers so detection is unambiguous.
    z = _streams(C, n, tones=[(64 / 4096, 30.0), (300 / 4096, 25.0)])
    batched = blocks_device.BatchedAutoNotch(C, 1, decimation=4096)
    out_b = batched.process(_planes(z))
    for c in range(C):
        host = blocks.AutoNotch(1, decimation=4096)
        out_h = host.process(z[c])
        assert batched.slot_i[c, 0] == host.slot_i[0]
        zb = out_b[c, :, 0] + 1j * out_b[c, :, 1]
        np.testing.assert_allclose(zb, out_h, atol=2e-2)


def test_batched_fir_matches_host():
    C, n = 2, 8192
    z = _streams(C, n)
    coeffs = np.hanning(9).astype(np.float32)
    coeffs /= coeffs.sum()
    taps = np.array([0.0, 0.004], np.float32)
    batched = blocks_device.BatchedFirFilter(C, coeffs, decim=2)
    out_b = batched.process(_planes(z), taps)
    for c in range(C):
        host = blocks.FirFilter(coeffs, decim=2, freq_tol=1e-9)
        out_h = host.process(z[c], float(taps[c]))
        zb = out_b[c, :, 0] + 1j * out_b[c, :, 1]
        m = min(len(zb), len(out_h))
        assert m > 3000
        np.testing.assert_allclose(zb[:m], out_h[:m], atol=1e-3)


def test_multi_rx_taps_and_spectrum():
    """MultiDvbsReceiver with cnr/spectrum taps enabled still decodes and
    produces per-channel metrics."""
    from leansdr_jax.pipelines import tsgen, dvbs_tx
    from leansdr_jax.pipelines.dvbs_rx import RxConfig
    from leansdr_jax.pipelines.multi_rx import MultiDvbsReceiver
    nchan = 2
    iqs, payloads = [], []
    for c in range(nchan):
        pkts = tsgen.generate(120, start=1000 * c)
        payloads.append(pkts)
        # CNR needs Fs > 4x Fm (sdr.h:1280) -> 5 samples/symbol.
        iqs.append(dvbs_tx.modulate(
            pkts, dvbs_tx.TxConfig(rate="1/2", interp=5)))
    n = min(len(q) for q in iqs)
    x = np.stack([q[:n] for q in iqs])
    cfg = RxConfig(Fs=10e6, Fm=2e6, rate="1/2", fastlock=True,
                   float_scale=75.0, exact_lut=False, cnr=True,
                   want_spectrum=True)
    rx = MultiDvbsReceiver(cfg, nchan, use_pallas=False)
    rx.cnr_est.decimation = 4096
    rx.spectrum.decimation = 4096
    got = 0
    for i in range(0, n, 1 << 16):
        for o in rx.process(x[:, i:i + (1 << 16)]):
            got += len(o)
    assert got >= 100
    assert len(rx.cnr) > 0 and rx.cnr[0].shape == (nchan,)
    assert len(rx.spectrum_lines) > 0
    assert rx.spectrum_lines[0].shape == (nchan, 1024)


def test_single_channel_adapters_match_host():
    """The nchan=1 adapters (AutoNotch1/CnrFft1/Spectrum1) that the
    single-channel CLI uses on accelerators behave like the host
    dsp/blocks.py implementations on the same complex stream."""
    n = 6 * 4096
    z = _streams(1, n)[0]
    tone = 0.35 * np.exp(2j * np.pi * 0.07 * np.arange(n)).astype(
        np.complex64)
    zt = (z + tone).astype(np.complex64)

    a1 = blocks_device.AutoNotch1(1)
    a1.b.decimation = 4096
    ah = blocks.AutoNotch(1, decimation=4096)
    out1 = a1.process(zt)
    outh = ah.process(zt)
    assert a1.b.slot_i[0, 0] == ah.slot_i[0]
    m = min(len(out1), len(outh))
    assert m >= 4 * 4096
    np.testing.assert_allclose(out1[:m], outh[:m], atol=2e-2)

    c1 = blocks_device.CnrFft1(0.2)
    c1.decimation = 4096
    ch = blocks.CnrFft(0.2)
    ch.decimation = 4096
    v1 = c1.process(zt, 0.07)
    vh = [float(v) for v in ch.process(zt, 0.07)]
    assert len(v1) == len(vh) >= 4
    np.testing.assert_allclose(v1, vh, atol=0.2)

    s1 = blocks_device.Spectrum1()
    s1.decimation = 1024
    sh = blocks.Spectrum()
    sh.decimation = 1024
    l1 = s1.process(zt)
    lh = sh.process(zt)
    assert len(l1) == len(lh) >= 4
    np.testing.assert_allclose(np.stack(l1), np.stack(lh), atol=0.5)
