"""Batched FFT on (re, im) float32 planes (the cfft_engine equivalent,
reference dsp.h:56-116), as XLA's FFT (cuFFT on the GPU).

fft_planes keeps the planes interface its callers use
(dsp/blocks_device.py, dsp/acquisition.py, pipelines/mlm_rx.py).
"""

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("n",))
def fft_planes(xr: jnp.ndarray, xi: jnp.ndarray, n: int):
    """Batched forward DFT of the last axis (length n).

    xr/xi: [..., n] float32 planes. Returns (yr, yi), complex64
    arithmetic throughout."""
    assert xr.shape[-1] == n
    y = jnp.fft.fft(jax.lax.complex(xr, xi), axis=-1)
    return jnp.real(y), jnp.imag(y)


def fft(x: jnp.ndarray) -> jnp.ndarray:
    """complex64 [..., n] forward FFT."""
    return jnp.fft.fft(x.astype(jnp.complex64), axis=-1)
