"""Streaming decimating complex FIR on device (the --resample path), as
one strided XLA convolution."""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

BUCKET = 4096     # input lengths are padded to a multiple: few shapes


@partial(jax.jit, static_argnames=("decim",))
def cfir_decimate(x, taps_r, taps_i, decim: int):
    """y[m] = sum_k taps[k] * x[m*decim + n-1 - k] for every m with a
    full window (VALID), computed only at the decimated outputs.

    x [2, L] (re, im rows), taps [n] float32. Returns [2, M]."""
    w = jnp.stack([taps_r[::-1], taps_i[::-1]])[:, None, :]  # [2, 1, n]
    y = jax.lax.conv_general_dilated(
        x[:, None, :], w, (decim,), "VALID",
        precision=jax.lax.Precision.HIGHEST)                # [2, 2, M]
    re = y[0, 0] - y[1, 1]
    im = y[0, 1] + y[1, 0]
    return jnp.stack([re, im])


class FirFilterDevice:
    """Streaming fir_filter (dsp.h:219-285) on device: carrier-re-
    modulated complex taps, decimation, history — drop-in for
    dsp/blocks.FirFilter on the --resample path. Taps are runtime
    arrays, so a carrier retune does not recompile."""

    def __init__(self, coeffs: np.ndarray, decim: int = 1,
                 freq_tol: float = 0.1):
        self.coeffs = np.asarray(coeffs, np.float32)
        self.n = len(self.coeffs)
        self.decim = decim
        self.freq_tol = freq_tol
        self.current_freq = 0.0
        self._set_freq(0.0)
        self.hist = np.zeros(self.n, np.complex64)
        self._primed = False

    def _set_freq(self, f: float):
        i = np.arange(self.n)
        a = 2 * np.pi * f * (i - self.n // 2)
        self.taps_r = jnp.asarray((self.coeffs * np.cos(a)
                                   ).astype(np.float32))
        self.taps_i = jnp.asarray((self.coeffs * np.sin(a)
                                   ).astype(np.float32))
        self.current_freq = f

    def process(self, x: np.ndarray, freq_tap: float = None) -> np.ndarray:
        """[n] complex64 in -> decimated complex64 out (equal to
        blocks.FirFilter up to f32 summation order)."""
        if freq_tap is not None and \
           abs(self.current_freq - freq_tap) > self.freq_tol:
            self._set_freq(freq_tap)
        buf = np.concatenate([self.hist, np.asarray(x, np.complex64)])
        if not self._primed:
            buf = buf[self.n:]
            self._primed = True
        count = (len(buf) - self.n) // self.decim
        if count <= 0:
            self.hist = buf[-min(len(buf), self.n + self.decim - 1):]
            return np.empty(0, np.complex64)
        # Output m reads buf[n + m*decim - k]: the VALID window starting
        # at buf[1 + m*decim].
        m = len(buf) - 1
        planes = np.zeros((2, -(-m // BUCKET) * BUCKET), np.float32)
        planes[0, :m] = buf.real[1:]
        planes[1, :m] = buf.imag[1:]
        y = np.asarray(cfir_decimate(jnp.asarray(planes), self.taps_r,
                                     self.taps_i, self.decim))[:, :count]
        self.hist = buf[count * self.decim:]
        return (y[0] + 1j * y[1]).astype(np.complex64)
