"""The integer fast-QPSK receiver (--hs path).

Mirrors fast_qpsk_receiver (reference sdr.h:946-1189): u8 IQ input, no
AGC, phase-only processing through three lookup tables (polar 256x256 ->
(angle, radius); rect 256-angle x 256-radius -> cu8; sincos 65536 -> cu8),
16-bit fixed-point PLL (alpha=0.04*65536, beta=0.0012*256*65536/omega) and
integer modified Mueller&Muller, emitting hard symbols by quadrant.

Expressed as a batched lax.scan like the float receiver; all table
lookups are gathers on u8-derived indices so the arithmetic is bit-exact
integer math (mu/mucorr stay float as in the reference).
"""

from dataclasses import dataclass
from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp

from .cstln import CSTLN_AMP

CHUNK = 128
RLUT_BITS = 8
RLUT_ANGLES = 1 << RLUT_BITS


@lru_cache(maxsize=None)
def hs_tables():
    """init_lookup_tables (sdr.h:1146-1170)."""
    i = np.arange(256)
    re = (i[:, None] - 128).astype(np.float32)
    im = (i[None, :] - 128).astype(np.float32)
    a = np.trunc(np.arctan2(im, re).astype(np.float64) * 65536 / (2 * np.pi))
    lut_a = a.astype(np.int64).astype(np.int16)          # [256,256] s_angle
    lut_r = np.trunc(np.hypot(re, im)).astype(np.int32).astype(np.uint8)

    aa = np.arange(65536)
    f = 2 * np.pi * aa / 65536
    sin_re = np.trunc(128 + CSTLN_AMP * np.cos(f).astype(np.float32)
                      ).astype(np.uint8)
    sin_im = np.trunc(128 + CSTLN_AMP * np.sin(f).astype(np.float32)
                      ).astype(np.uint8)

    ang = np.arange(RLUT_ANGLES)
    r = np.arange(256)
    rect_re = np.trunc(128 + r[None, :] * np.cos(
        2 * np.pi * ang[:, None] / RLUT_ANGLES)).astype(np.int32)
    rect_im = np.trunc(128 + r[None, :] * np.sin(
        2 * np.pi * ang[:, None] / RLUT_ANGLES)).astype(np.int32)
    # Plain tables + the pre-scan bulk polar hoist (see run_chunks_hs);
    # XLA batches the paired in-loop gathers.
    return {
        "polar_a": jnp.asarray(lut_a.reshape(-1).astype(np.int32)),
        "polar_r": jnp.asarray(lut_r.reshape(-1).astype(np.int32)),
        "rect_re": jnp.asarray((rect_re & 0xFF).reshape(-1)),
        "rect_im": jnp.asarray((rect_im & 0xFF).reshape(-1)),
        "sincos_re": jnp.asarray(sin_re.astype(np.int32)),
        "sincos_im": jnp.asarray(sin_im.astype(np.int32)),
    }


@dataclass(frozen=True)
class HsParams:
    omega: float
    pll_adjustment: float = 1.0
    allow_drift: bool = False
    freq0: float = 0.0
    meas_decimation: int = 1 << 20

    @property
    def freq_limits(self):
        # +-SR/8 (update_freq_limits, sdr.h:988-992)
        freqw0 = int(self.freq0 * 65536)
        half = int(65536 / self.omega / 8)
        return freqw0 - half, freqw0 + half


def init_state(params: HsParams, nchan: int):
    C = nchan
    return {
        "mu": jnp.zeros(C, jnp.float32),
        "phase": jnp.zeros(C, jnp.int32),
        "freqw": jnp.full(C, int(params.freq0 * 65536), jnp.int32),
        # hist as u8 component ints [C,3,2] for p and c
        "hist_p": jnp.zeros((C, 3, 2), jnp.int32),
        "hist_c": jnp.zeros((C, 3, 2), jnp.int32),
        "meas_count": jnp.zeros(C, jnp.int32),
    }


def _s8(x):
    """(signed char) cast of an int lane."""
    return ((x & 0xFF) ^ 0x80) - 0x80


@partial(jax.jit, static_argnames=("params",))
def run_chunks_hs(params: HsParams, tables, state, x):
    """Demodulate [C, nsamp+1] u8 IQ (as int32 [C, nsamp+1, 2]).

    Returns (state, dict(symbol [C,nsamp] u8, valid, freq [C,K])).
    """
    C, n1, _ = x.shape
    nsamp = n1 - 1
    K = nsamp // CHUNK

    freq_alpha = jnp.int32(int(0.04 * 65536))
    freq_beta = jnp.int32(int(0.0012 * 256 * 65536 / params.omega
                              * params.pll_adjustment))
    gain_mu = jnp.float32(0.02 / (CSTLN_AMP * CSTLN_AMP) * 2)
    omega = jnp.float32(params.omega)
    min_freqw, max_freqw = params.freq_limits
    quad_map = jnp.asarray(np.array([0, 2, 3, 1], np.int32))

    pa, pr = tables["polar_a"], tables["polar_r"]
    rre, rim = tables["rect_re"], tables["rect_im"]
    scre, scim = tables["sincos_re"], tables["sincos_im"]

    def sample_step(carry, inp):
        st, last = carry
        # Polar coordinates of the two raw samples arrive PRECOMPUTED:
        # pa/pr of the input pairs are state-independent, so the
        # per-sample table gathers are hoisted out of the scan into one
        # bulk vectorized lookup (the in-loop gathers that remain —
        # rect and sincos — depend on the PLL phase).
        p0a, p0r, p1a, p1r = inp               # [C] int32 each
        mu, phase, freqw = st["mu"], st["phase"], st["freqw"]
        emit = mu < 1.0

        a0 = ((p0a - phase) & 0xFFFF) >> (16 - RLUT_BITS)
        r0 = a0 * 256 + (p0r >> 1)
        p0r_re = rre[r0]
        p0r_im = rim[r0]
        a1 = ((p1a - (phase + freqw)) & 0xFFFF) >> (16 - RLUT_BITS)
        r1 = a1 * 256 + (p1r >> 1)
        p1r_re = rre[r1]
        p1r_im = rim[r1]

        # s = p0r + (p1r-p0r)*mu, float mul then int truncation, u8 wrap
        s_re = (p0r_re + jnp.trunc(
            (p1r_re - p0r_re).astype(jnp.float32) * mu).astype(jnp.int32)
        ) & 0xFF
        s_im = (p0r_im + jnp.trunc(
            (p1r_im - p0r_im).astype(jnp.float32) * mu).astype(jnp.int32)
        ) & 0xFF
        symbol_arg = pa[s_re * 256 + s_im] & 0xFFFF     # u_angle

        quadrant = symbol_arg >> 14
        sym = quad_map[quadrant]

        # PLL in 16-bit fixed point (sdr.h:1072-1075)
        pe = (symbol_arg & 16383) - 8192
        phase_u = phase + ((pe * freq_alpha + 32768) >> 16)
        freqw_u = freqw + ((pe * freq_beta + 32768 * 256) >> 24)

        # Integer modified M&M (sdr.h:1099-1108)
        hp, hc = st["hist_p"], st["hist_c"]
        cp_idx = ((symbol_arg & 49152) + 8192) & 0xFFFF
        c_re = scre[cp_idx]
        c_im = scim[cp_idx]
        muerr = (_s8(s_re - hp[:, 1, 0]) * (hc[:, 0, 0] - 128) +
                 _s8(s_im - hp[:, 1, 1]) * (hc[:, 0, 1] - 128)) - \
                (_s8(c_re - hc[:, 1, 0]) * (hp[:, 0, 0] - 128) +
                 _s8(c_im - hc[:, 1, 1]) * (hp[:, 0, 1] - 128))
        mucorr = jnp.clip(muerr.astype(jnp.float32) * gain_mu, -0.1, 0.1)
        mu_u = mu + mucorr + omega

        h0p = jnp.stack([s_re, s_im], -1)
        h0c = jnp.stack([c_re, c_im], -1)
        new_hp = jnp.where(emit[:, None, None],
                           jnp.stack([h0p, hp[:, 0], hp[:, 1]], 1), hp)
        new_hc = jnp.where(emit[:, None, None],
                           jnp.stack([h0c, hc[:, 0], hc[:, 1]], 1), hc)
        mu = jnp.where(emit, mu_u, mu)
        phase = jnp.where(emit, phase_u, phase)
        freqw = jnp.where(emit, freqw_u, freqw)

        mu = mu - 1.0
        # phase is a u_angle (u16) in the reference; keep it wrapped so the
        # int32 lane cannot overflow (all uses are mod-65536).
        phase = (phase + freqw) & 0xFFFF

        st = dict(st, mu=mu, phase=phase, freqw=freqw,
                  hist_p=new_hp, hist_c=new_hc)
        # cstln_out (sdr.h:1120-1122): remember the last interpolated
        # u8 point; one per chunk is emitted below.
        last = (jnp.where(emit, s_re, last[0]),
                jnp.where(emit, s_im, last[1]),
                last[2] | emit)
        return (st, last), (sym.astype(jnp.uint8), emit)

    def chunk_step(state, xc):
        C_ = state["mu"].shape[0]
        last0 = (jnp.zeros(C_, jnp.int32), jnp.zeros(C_, jnp.int32),
                 jnp.zeros(C_, bool))
        (state, last), (sym, valid) = jax.lax.scan(
            sample_step, (state, last0),
            (xc[:, :, 0], xc[:, :, 1], xc[:, :, 2], xc[:, :, 3]),
            unroll=8)
        freqw = state["freqw"]
        if not params.allow_drift:
            bad = (freqw < min_freqw) | (freqw > max_freqw)
            freqw = jnp.where(bad, (min_freqw + max_freqw) // 2, freqw)
        meas_count = state["meas_count"] + CHUNK
        nmeas = (meas_count // params.meas_decimation).astype(jnp.int32)
        meas_count = meas_count % params.meas_decimation
        state = dict(state, freqw=freqw, meas_count=meas_count)
        sampled = jnp.stack([last[0], last[1]], -1)       # [C, 2] u8
        return state, (sym, valid, freqw.astype(jnp.float32) / 65536,
                       nmeas, sampled, last[2])

    # Bulk polar lookup of every raw sample (ONE vectorized gather per
    # table instead of four per scan step).
    flat = x[:, :, 0] * 256 + x[:, :, 1]           # [C, nsamp+1]
    A = pa[flat]
    R = pr[flat]
    quad = jnp.stack([A[:, :nsamp], R[:, :nsamp],
                      A[:, 1:nsamp + 1], R[:, 1:nsamp + 1]], axis=2)
    xs = quad.transpose(1, 0, 2).reshape(K, CHUNK, C, 4)
    state, (sym, valid, freq, nmeas, sampled, samp_ok) = jax.lax.scan(
        chunk_step, state, xs)
    sym = sym.transpose(2, 0, 1).reshape(C, nsamp)
    valid = valid.transpose(2, 0, 1).reshape(C, nsamp)
    return state, dict(symbol=sym, valid=valid,
                       freq=freq.T, nmeas=nmeas.T,
                       sampled=sampled.transpose(1, 0, 2),
                       sampled_ok=samp_ok.T)
