"""FFT planes, banded-matmul FIR, matched filter and the device
streaming FIR."""

import numpy as np
import jax.numpy as jnp
import pytest

from leansdr_jax.dsp.fft import fft, fft_planes


@pytest.mark.parametrize("n", [64, 256, 1024, 4096])
def test_mxu_fft_matches_numpy(n):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(8, n))
         + 1j * rng.normal(size=(8, n))).astype(np.complex64)
    y = np.asarray(fft(jnp.asarray(x)))
    ref = np.fft.fft(x, axis=1)
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5


def test_fft_planes_matches_numpy():
    """fft_planes (the planes interface of blocks_device, acquisition
    and mlm_rx) vs np.fft.fft on a batch of frames, complex64."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 512)) + 1j * rng.normal(size=(3, 5, 512))
    yr, yi = fft_planes(jnp.asarray(x.real, jnp.float32),
                        jnp.asarray(x.imag, jnp.float32), 512)
    ref = np.fft.fft(x, axis=-1)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("nt", [33, 65, 129])
def test_fir_mxu_matches_convolve(nt):
    """Banded-matmul FIR (dsp/fir_mxu.py) vs np.convolve, spanning
    several 128-output blocks, including the max band width (129)."""
    from leansdr_jax.dsp.fir_mxu import fir_mxu
    rng = np.random.default_rng(7)
    R, n = 8, 4 * 1024
    x = rng.normal(size=(R, n)).astype(np.float32)
    taps = tuple(np.hanning(nt).astype(np.float32).tolist())
    y = np.asarray(fir_mxu(jnp.asarray(x), taps))
    ref = np.stack([np.convolve(r, np.array(taps))[:n] for r in x])
    np.testing.assert_allclose(y, ref, atol=1e-3)


def test_fir_mxu_band_limit():
    from leansdr_jax.dsp.fir_mxu import make_bands
    with pytest.raises(ValueError):
        make_bands(np.ones(130, np.float32))


def test_fir_mxu_valid_matches_convolve():
    """fir_mxu_valid: VALID-mode correlation with in-band history and
    arbitrary (non-128-multiple) lengths."""
    from leansdr_jax.dsp.fir_mxu import fir_mxu_valid
    rng = np.random.default_rng(9)
    R, S, nt = 4, 3001, 65
    x = rng.normal(size=(R, S)).astype(np.float32)
    taps = tuple(np.hanning(nt).astype(np.float32).tolist())
    y = np.asarray(fir_mxu_valid(jnp.asarray(x), taps))
    ref = np.stack([np.correlate(r, np.array(taps), mode="valid")
                    for r in x])
    assert y.shape == ref.shape == (R, S - nt + 1)
    np.testing.assert_allclose(y, ref, atol=1e-3)


def test_mf_prefilter_mxu_matches_vpu():
    """The matmul matched filter (derotate -> banded matmul -> re-rotate,
    dsp/mf_prefilter.py) vs the streaming VPU formulation, at real
    carrier offsets incl. negative and fractional freqw."""
    from leansdr_jax.dsp.mf_prefilter import (make_mf_taps, mf_prefilter,
                                              mf_prefilter_vpu)
    rng = np.random.default_rng(3)
    taps = make_mf_taps(4e6, 2e6, 0.35, 30.0)
    C, n = 5, 4096
    x = rng.normal(scale=75.0,
                   size=(C, n + len(taps) - 1, 2)).astype(np.float32)
    freqw = jnp.asarray([0.0, 327.68, -1200.5, 8000.25, 65536.0 / 3],
                        jnp.float32)
    y = np.asarray(mf_prefilter(tuple(taps), freqw, jnp.asarray(x)))
    ref = np.asarray(mf_prefilter_vpu(tuple(taps), freqw, jnp.asarray(x)))
    assert y.shape == ref.shape == (C, n, 2)
    np.testing.assert_allclose(y, ref, atol=2e-2 * 75.0)
    # and the zero-offset channel equals a plain convolution
    z = x[0, :, 0] + 1j * x[0, :, 1]
    zk = np.correlate(z, np.asarray(taps, np.complex64), mode="valid")
    np.testing.assert_allclose(y[0, :, 0], zk.real, atol=1e-2 * 75.0)
    np.testing.assert_allclose(y[0, :, 1], zk.imag, atol=1e-2 * 75.0)


def test_fir_filter_device_matches_host_streaming():
    """FirFilterDevice (the --resample device path) vs blocks.FirFilter:
    identical streaming output across chunks, decimation, and a
    mid-stream carrier retune."""
    from leansdr_jax.dsp.blocks import FirFilter
    from leansdr_jax.dsp.fir_device import FirFilterDevice
    rng = np.random.default_rng(3)
    n = 40000
    z = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    coeffs = np.hanning(41).astype(np.float32)
    coeffs /= coeffs.sum()
    host = FirFilter(coeffs, decim=3, freq_tol=1e-6)
    dev = FirFilterDevice(coeffs, decim=3, freq_tol=1e-6)
    taps = [0.0, 0.0, 0.011, 0.011]     # retune at chunk 2
    out_h, out_d = [], []
    for i, f in zip(range(0, n, 10000), taps):
        out_h.append(host.process(z[i:i + 10000], f))
        out_d.append(dev.process(z[i:i + 10000], f))
    oh = np.concatenate(out_h)
    od = np.concatenate(out_d)
    assert len(oh) == len(od) and len(oh) > 10000
    np.testing.assert_allclose(od, oh, atol=1e-4)
