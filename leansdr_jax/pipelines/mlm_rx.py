"""Multi-channel FM receiver (the leanmlmrx equivalent, reference
src/apps/leanmlmrx.cc).

The reference's pthread pipeline (reader -> 2 FFT workers with 1024-job
ring buffers and busy-wait flags -> joiner) collapses into ONE batched
FFT over a [nframes, N] window tensor plus vectorized per-channel math —
the textbook device win (SURVEY.md section 2.10 P3):

  windows    x[k*stride : k*stride+N] for stride = round(Fs/Fq)
  channelize batched FFT, gather 2 adjacent bins per channel, apply the
             precomputed 2x2x2 combining weights (leanmlmrx.cc:575-615)
  discriminate  8-bit-quantized atan2 -> u16 phase, dph - derot
  audio      squelch RMS gate, channel mixdown with 1/sqrt(n) scaling,
             one-pole de-emphasis, +-decimation to Fau, int8 out

Only the de-emphasis filter and squelch EMA are sequential — first-order
recurrences evaluated with associative scans at audio rate.
"""

from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

MAXCHANS = 201


@dataclass
class Channel:
    F: float
    enabled: bool = True


@dataclass
class MlmConfig:
    Fs: float = 25.6e6
    Fc: float = 98e6
    Fq: float = 0.0          # quadrature rate; 0 = autoselect
    maxdev: float = 75e3
    deemph: float = 50e-6
    N: int = 64
    channels: list = field(default_factory=list)
    squelch: float = 0.0
    Fau: float = 44100.0
    wav: bool = False


def resolve_rates(cfg: MlmConfig):
    """Fq/Fau/audiodecim selection (leanmlmrx.cc:530-559)."""
    Fq, Fau = cfg.Fq, cfg.Fau
    if not Fq:
        if Fau:
            if Fau > 2 * cfg.maxdev:
                audiodecim = -int(np.floor(Fau / (2 * cfg.maxdev)))
                Fq = Fau / (-audiodecim)
            else:
                audiodecim = int(np.ceil((2 * cfg.maxdev) / Fau))
                Fq = Fau * audiodecim
        else:
            Fq = cfg.Fs / cfg.N
            Fau = Fq
            audiodecim = 1
    else:
        if not Fau:
            Fau = Fq
            audiodecim = 1
        else:
            audiodecim = int(np.floor(Fq / Fau + 0.5))
            if abs(Fau * audiodecim - Fq) > 0.5:
                raise ValueError("Audio decimation ratio must be integer")
    return Fq, Fau, audiodecim


def channel_weights(cfg: MlmConfig, Fq: float):
    """Per-channel bin index, 2x2x2 combining weights and derotation
    (leanmlmrx.cc:575-625)."""
    N = cfg.N
    stride = int(np.floor(cfg.Fs / Fq + 0.5))
    if stride < N:
        raise ValueError("FFT windows overlap")
    ibins, weights, derots = [], [], []
    for ch in cfg.channels:
        fbin = N * (ch.F - cfg.Fc) / cfg.Fs
        b = int(np.floor(fbin))
        frel = fbin - b
        if frel < 0.125:
            bw = [[[1, 0], [0, 1]], [[0, 0], [0, 0]]]
        elif frel < 0.375:
            bw = [[[0.707, 0.707], [-0.070, 0.707]],
                  [[-0.2, -0.2], [0.2, -0.2]]]
        elif frel < 0.625:
            bw = [[[0, 1], [-1, 0]], [[0, -1], [1, 0]]]
        elif frel < 0.875:
            bw = [[[-0.2, 0.2], [-0.2, -0.2]],
                  [[0.707, -0.707], [0.707, 0.707]]]
        else:
            bw = [[[0, 0], [0, 0]], [[1, 0], [0, 1]]]
        bw = np.array(bw, np.float32) * np.float32(8.0 * 128 / 2048 / N)
        ibins.append((N + b) % N)
        weights.append(bw)
        derot = 2 * np.pi * (ch.F - cfg.Fc) * stride / cfg.Fs
        derot = (derot + np.pi) % (2 * np.pi) - np.pi
        derots.append(np.int16(int(derot * 65536 / (2 * np.pi))))
    return (np.array(ibins), np.stack(weights) if weights else
            np.zeros((0, 2, 2, 2), np.float32),
            np.array(derots, np.int16), stride)


def _atan2_u16(y, x):
    """lut_atan2 semantics (leanmlmrx.cc:203-208): s8-quantized atan2 as
    u16 angle; inputs already halved into [-126,126] and truncated."""
    from ..dsp.math_utils import atan2_poly
    a = atan2_poly(y, x)
    return jnp.trunc(a * jnp.float32(65536 / (2 * np.pi))
                     ).astype(jnp.int32) & 0xFFFF


@jax.jit
def channelize(xr: jnp.ndarray, xi: jnp.ndarray, ibins: jnp.ndarray,
               weights: jnp.ndarray):
    """[nframes, N] float32 window planes -> [nframes, nchan] u16 phases.

    Plane-based throughout (fft_planes takes and returns planes)."""
    from ..dsp.fft import fft_planes
    N = xr.shape[1]
    br, bi = fft_planes(xr, xi, N)                  # FFTW sign -1
    b0r, b0i = br[:, ibins], bi[:, ibins]           # [F, C]
    i1 = (ibins + 1) % N
    b1r, b1i = br[:, i1], bi[:, i1]
    # d[i] = sum_b bw[b,i,0]*re_b + bw[b,i,1]*im_b
    d_re = (weights[None, :, 0, 0, 0] * b0r
            + weights[None, :, 0, 0, 1] * b0i
            + weights[None, :, 1, 0, 0] * b1r
            + weights[None, :, 1, 0, 1] * b1i)
    d_im = (weights[None, :, 0, 1, 0] * b0r
            + weights[None, :, 0, 1, 1] * b0i
            + weights[None, :, 1, 1, 0] * b1r
            + weights[None, :, 1, 1, 1] * b1i)
    for _ in range(10):
        over = ((d_re < -126) | (d_re > 126)
                | (d_im < -126) | (d_im > 126))
        d_re = jnp.where(over, d_re * 0.5, d_re)
        d_im = jnp.where(over, d_im * 0.5, d_im)
    return _atan2_u16(jnp.trunc(d_im), jnp.trunc(d_re))


class MlmReceiver:
    """Streaming multi-channel FM demodulator."""

    def __init__(self, cfg: MlmConfig):
        self.cfg = cfg
        self.Fq, self.Fau, self.audiodecim = resolve_rates(cfg)
        self.ibins, self.weights, self.derots, self.stride = \
            channel_weights(cfg, self.Fq)
        self.nchan = len(cfg.channels)
        self.enabled = np.array([c.enabled for c in cfg.channels], bool)
        self.prevph = np.zeros(self.nchan, np.int32)
        self.rms = np.ones(self.nchan, np.float32)
        self.deemph_state = 0.0
        self.audioclock = 0
        self.backlog = np.empty(0, np.complex64)
        self.alpha_deemph = 1 / (self.Fq * cfg.deemph)
        self.alpha_squelch = 1 / (self.Fau * 0.1)
        self.discr_gain = (self.Fq / 65536 / (2 * cfg.maxdev)) * 0.75 * 256

    def process(self, iq: np.ndarray) -> np.ndarray:
        """[n] complex64 -> int8 audio samples."""
        cfg = self.cfg
        self.backlog = np.concatenate([self.backlog,
                                       np.asarray(iq, np.complex64)])
        nframes = max(0, (len(self.backlog) - cfg.N) // self.stride + 1)
        if nframes == 0 or self.nchan == 0:
            return np.empty(0, np.int8)
        idx = (np.arange(nframes)[:, None] * self.stride
               + np.arange(cfg.N)[None, :])
        windows = self.backlog[idx]
        self.backlog = self.backlog[nframes * self.stride:]

        ph = np.asarray(channelize(
            jnp.asarray(windows.real.astype(np.float32)),
            jnp.asarray(windows.imag.astype(np.float32)),
            jnp.asarray(self.ibins),
            jnp.asarray(self.weights)))  # [F, C]

        # FM discriminator: dph = ph - prevph - derot (u16 -> s16)
        prev = np.concatenate([self.prevph[None, :], ph[:-1]], axis=0)
        dph = (ph - prev - self.derots[None, :].astype(np.int32))
        dph = ((dph & 0xFFFF) ^ 0x8000) - 0x8000
        self.prevph = ph[-1]

        from ..dsp.blocks import _first_order_scan
        dev = dph.astype(np.float32)
        active = np.broadcast_to(self.enabled[None, :], dev.shape).copy()
        if cfg.squelch:
            # Per-channel RMS EMA gate (leanmlmrx.cc:701-705), first-order
            # recurrence via associative scan.
            r = np.asarray(_first_order_scan(
                jnp.asarray(dev ** 2 / np.float32(32768.0 ** 2)),
                jnp.asarray(self.rms), self.alpha_squelch))
            self.rms = r[-1]
            active &= r <= 1 - cfg.squelch
        audio = np.where(active, dev, 0).sum(axis=1)
        nactive = active.sum(axis=1)

        # De-emphasis one-pole over frames (leanmlmrx.cc:710-711).
        out = np.asarray(_first_order_scan(
            jnp.asarray(audio.astype(np.float32)),
            jnp.float32(self.deemph_state), self.alpha_deemph))
        self.deemph_state = float(out[-1])

        scale = np.where(nactive > 0, 1 / np.sqrt(np.maximum(nactive, 1)),
                         0.0)
        samples = out * scale * np.float32(self.discr_gain)

        if self.audiodecim < 0:
            rep = -self.audiodecim
            au = np.repeat(samples, rep)
        else:
            # Emit every audiodecim-th frame, phase carried in audioclock.
            sel = (np.arange(len(samples)) + self.audioclock + 1) \
                % self.audiodecim == 0
            self.audioclock = (self.audioclock + len(samples)) \
                % self.audiodecim
            au = samples[sel]
        au8 = (np.trunc(au).astype(np.int64) & 0xFF).astype(np.uint8)
        if cfg.wav:
            au8 ^= 128
        return au8.astype(np.int8) if not cfg.wav else au8.view(np.int8)
