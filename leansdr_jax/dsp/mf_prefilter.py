"""Matched-filter prefilter for the fast RRC path.

The reference's `fir_sampler` (sdr.h:635-689) runs a polyphase RRC
matched filter *inside* the per-sample timing loop: at each emitted
symbol it picks the polyphase branch trunc((1-mu)*subsampling) and dots
`ncoeffs/subsampling` taps, with the taps pre-rotated by the current
carrier estimate (freqw) so one derotation of the accumulated sum
suffices (sdr.h:667-682).  That shape exists to avoid per-sample
interpolation cost on a CPU; it quantizes symbol timing to
1/subsampling of a sample.

Device equivalent: apply the matched filter ONCE at input rate as a
batched convolution *before* the demodulator, then run the standard
linear-sampler kernel (receiver_pallas.py) on the filtered stream.
Linear interpolation of the filtered signal replaces the reference's
1/32-sample polyphase quantization (strictly finer timing resolution),
and the timing-loop dynamics are unchanged: the sampled position still
moves as t + mu, only delayed by the constant filter group delay, which
the timing loop absorbs.

Carrier rotation of the taps is preserved: each channel's taps are
rotated by its current freqw estimate (re-derived once per processed
chunk, vs the reference's throttled update every ncoeffs*16 samples —
freqw moves slowly at either cadence).  The rotated 2x2 real kernels
feed one XLA grouped convolution (channels = feature groups), which XLA
runs as a matmul.

The bit-exact reference-parity path remains the exact_lut=True XLA scan
(receiver.py sampler="rrc", golden tests).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def make_mf_taps(Fs_eff: float, Fm: float, rolloff: float,
                 rej: float) -> tuple:
    """Input-rate root-raised-cosine taps (filtergen.h:151-173 sampled at
    the input rate instead of the polyphase oversampled rate)."""
    from . import filtergen
    transition = (Fm / 2) * rolloff
    order = int(rej * Fs_eff / (22 * transition))
    taps = filtergen.root_raised_cosine(order, Fm / Fs_eff, rolloff)
    return tuple(float(t) for t in taps)


@partial(jax.jit, static_argnames=("taps",))
def mf_prefilter(taps: tuple, freqw: jnp.ndarray, x: jnp.ndarray):
    """[C, n + ntaps - 1, 2] float32 -> [C, n, 2] matched-filtered.

    taps: static input-rate RRC taps.  freqw: [C] current carrier step
    (u16 units/sample); taps are rotated by exp(-i*w*(j - ntaps//2)) so
    the filter passband tracks each channel's carrier (sdr.h:676-681).

    Matmul formulation: the per-channel tap rotation factors out of the
    convolution —

        sum_k c[k] e^{-iw(k-h)} x[t+k]
          = e^{iw(t+h)} * sum_k c[k] (e^{-iws} x[s])|_{s=t+k}

    so the chain is derotate (VPU, 6 ops/sample) -> REAL static-tap
    banded-Toeplitz matmul (dsp/fir_mxu.py, re/im as rows)
    -> re-rotate.  This replaces the 65-tap unrolled shift-and-add VPU
    sweep (~8 ops/sample/tap) that shipped before; parity vs that
    formulation is pinned by tests/test_fft_fir.py (the VPU variant
    stays below as mf_prefilter_vpu).  Rotation phases are computed
    mod-65536 in the freqw integer domain before the 2*pi scaling, so
    float32 cos/sin never see large arguments.
    """
    from .fir_mxu import fir_mxu_valid
    c = np.asarray(taps, np.float32)
    ntaps = c.shape[0]
    C = x.shape[0]
    n = x.shape[1] - (ntaps - 1)
    h = ntaps // 2
    s = jnp.arange(x.shape[1], dtype=jnp.float32)[None, :]      # [1, S]
    # phase in u16 units, wrapped exactly: split freqw into integer and
    # fractional parts; the integer product wraps in int32 (mod 2^16
    # after masking), the fractional product stays small enough for f32.
    fi = jnp.floor(freqw)[:, None]
    ff = (freqw[:, None] - fi)
    ph = ((fi.astype(jnp.int32) * s.astype(jnp.int32)) & 0xFFFF
          ).astype(jnp.float32) + ff * s
    ang = -(2 * np.pi / 65536.0) * ph                           # [C, S]
    dr, di = jnp.cos(ang), jnp.sin(ang)
    xr, xi = x[:, :, 0], x[:, :, 1]
    ur = xr * dr - xi * di                  # u = e^{-iws} x
    ui = xr * di + xi * dr
    v = fir_mxu_valid(jnp.concatenate([ur, ui], axis=0),
                      tuple(float(t) for t in c))               # [2C, n]
    vr, vi = v[:C], v[C:]
    ang2 = -ang[:, :n] + (2 * np.pi / 65536.0) * (
        jnp.mod(freqw[:, None], 65536.0) * np.float32(h))
    rr, ri = jnp.cos(ang2), jnp.sin(ang2)   # e^{iw(t+h)}
    zr = vr * rr - vi * ri
    zi = vr * ri + vi * rr
    return jnp.stack([zr, zi], axis=-1)


@partial(jax.jit, static_argnames=("taps",))
def mf_prefilter_vpu(taps: tuple, freqw: jnp.ndarray, x: jnp.ndarray):
    """The streaming VPU formulation (unrolled shift-and-add over the
    taps, rotated per channel) — kept as the parity reference for the
    matmul path and for shapes where a matmul is not profitable."""
    c = np.asarray(taps, np.float32)
    ntaps = c.shape[0]
    n = x.shape[1] - (ntaps - 1)
    j = np.arange(ntaps, dtype=np.float32) - (ntaps // 2)
    ang = -(freqw[:, None] / 65536.0) * (2 * np.pi) * jnp.asarray(j)[None]
    cr = jnp.asarray(c)[None, :] * jnp.cos(ang)         # [C, ntaps]
    ci = jnp.asarray(c)[None, :] * jnp.sin(ang)
    xr, xi = x[:, :, 0], x[:, :, 1]
    zr = jnp.zeros((x.shape[0], n), jnp.float32)
    zi = zr
    for k in range(ntaps):
        wr = cr[:, k:k + 1]
        wi = ci[:, k:k + 1]
        sr = xr[:, k:k + n]
        si = xi[:, k:k + n]
        zr = zr + wr * sr - wi * si
        zi = zi + wr * si + wi * sr
    return jnp.stack([zr, zi], axis=-1)
