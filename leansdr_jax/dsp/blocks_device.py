"""Device-batched preprocessing for channel fleets.

The single-channel streaming blocks (dsp/blocks.py: auto_notch
sdr.h:46-154, cnr_fft sdr.h:1273-1345, spectrum sdr.h:1347-1404) compute
one host FFT per 1k-4k-sample block — fine for one carrier, serializing
for a 64-channel fleet. These batched variants keep the same per-block
semantics but run ONE batched FFT (dsp/fft.py) over all channels' blocks,
and vectorize the per-sample notch estimator recurrence with an
associative scan. Block-rate FSM logic (slot election, EMA bookkeeping)
stays on the host at negligible rate.

Inputs are [C, n, 2] float32 (re, im) planes — the fleet ingest format
of pipelines/multi_rx.py.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .fft import fft_planes


@partial(jax.jit, static_argnames=("nfft",))
def _batched_power(blocks: jnp.ndarray, nfft: int):
    """[C, B, nfft, 2] -> power [C, B, nfft] via the batched FFT."""
    yr, yi = fft_planes(blocks[..., 0], blocks[..., 1], nfft)
    return yr * yr + yi * yi


class _Backlog:
    def __init__(self, nchan):
        self.buf = np.empty((nchan, 0, 2), np.float32)

    def add(self, x):
        self.buf = np.concatenate([self.buf, np.asarray(x, np.float32)],
                                  axis=1)

    def take(self, nfft):
        """Yield [C, B, nfft, 2] whole blocks, keep the remainder."""
        B = self.buf.shape[1] // nfft
        if not B:
            return None
        blk = self.buf[:, :B * nfft].reshape(
            self.buf.shape[0], B, nfft, 2)
        self.buf = self.buf[:, B * nfft:]
        return blk


class BatchedSpectrum:
    """spectrum (sdr.h:1347-1404) over a channel fleet: EMA'd dB
    spectra, [positive-half | negative-half] order, one batched DFT."""

    NFFT = 1024

    def __init__(self, nchan: int, decimation: int = 1 << 20,
                 kavg: float = 0.1):
        self.nchan = nchan
        self.decimation = decimation
        self.kavg = kavg
        self.avgpower = None            # [C, NFFT]
        self.phase = 0
        self.backlog = _Backlog(nchan)

    def process(self, x) -> list:
        """x: [C, n, 2]. Returns a list of [C, NFFT] dB lines."""
        self.backlog.add(x)
        blocks = self.backlog.take(self.NFFT)
        out = []
        if blocks is None:
            return out
        for b in range(blocks.shape[1]):
            self.phase += self.NFFT
            if self.phase >= self.decimation:
                self.phase -= self.decimation
                # Only the triggered block's DFT (blocks that never
                # trigger would waste B x the FFT work).
                p = np.asarray(_batched_power(
                    jnp.asarray(blocks[:, b:b + 1]), self.NFFT))[:, 0]
                if self.avgpower is None:
                    self.avgpower = p.copy()
                self.avgpower = (self.avgpower * (1 - self.kavg)
                                 + p * self.kavg)
                half = self.NFFT // 2
                line = np.concatenate(
                    [10 * np.log10(self.avgpower[:, half:]),
                     10 * np.log10(self.avgpower[:, :half])], axis=1)
                out.append(line.astype(np.float32))
        return out


class BatchedCnrFft:
    """cnr_fft (sdr.h:1273-1345) over a channel fleet."""

    def __init__(self, nchan: int, bandwidth: float, nfft: int = 4096,
                 decimation: int = 1 << 20, kavg: float = 0.1):
        if bandwidth > 0.25:
            raise ValueError("CNR estimator requires Fsampling > 4x Fsignal")
        self.nchan = nchan
        self.bw = bandwidth
        self.nfft = nfft
        self.decimation = decimation
        self.kavg = kavg
        self.avgpower = None            # [C, nfft]
        self.phase = 0
        self.backlog = _Backlog(nchan)

    def _cnr(self, freq_tap: np.ndarray) -> np.ndarray:
        n = self.nfft
        icf = np.floor(freq_tap * n + 0.5).astype(np.int64)   # [C]
        bwslots = int((self.bw / 4) * n)
        if not bwslots:
            return None

        # Vectorized per-channel slot averages around each carrier bin.
        def avg(lo, hi):
            idx = (icf[:, None] + np.arange(lo, hi + 1)[None, :]) & (n - 1)
            return np.take_along_axis(self.avgpower, idx, axis=1).mean(1)

        c2plusn2 = avg(-bwslots, bwslots)
        n2 = (avg(-bwslots * 4, -bwslots * 3)
              + avg(bwslots * 3, bwslots * 4)) / 2
        c2 = c2plusn2 - n2
        ok = (c2 > 0) & (n2 > 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            v = 10 * np.log10(c2 / n2)
        return np.where(ok, v, -50.0).astype(np.float32)

    def process(self, x, freq_tap=None) -> list:
        """x: [C, n, 2]; freq_tap: [C] tracked carrier (cycles/sample).
        Returns a list of [C] CNR vectors (dB)."""
        if freq_tap is None:
            freq_tap = np.zeros(self.nchan, np.float32)
        self.backlog.add(x)
        blocks = self.backlog.take(self.nfft)
        out = []
        if blocks is None:
            return out
        for b in range(blocks.shape[1]):
            self.phase += self.nfft
            if self.phase >= self.decimation:
                self.phase -= self.decimation
                p = np.asarray(_batched_power(
                    jnp.asarray(blocks[:, b:b + 1]), self.nfft))[:, 0]
                if self.avgpower is None:
                    self.avgpower = p.copy()
                self.avgpower = (self.avgpower * (1 - self.kavg)
                                 + p * self.kavg)
                cnr = self._cnr(np.asarray(freq_tap))
                if cnr is not None:
                    out.append(cnr)
        return out


@partial(jax.jit, static_argnames=("k", "nfft"))
def _notch_block(block, slot_i, estim, gain, k: float, nfft: int):
    """One fleet block: track and subtract each channel's slots.

    block [C, nfft, 2]; slot_i [C, S] i32 (-1 = empty); estim [C, S, 2];
    gain [C]. Returns (out [C, nfft, 2], new estim)."""
    t = jnp.arange(nfft, dtype=jnp.float32)
    ang = (2 * np.pi / nfft) * slot_i.astype(jnp.float32)[..., None] \
        * t[None, None, :]                              # [C, S, n]
    ejr = jnp.cos(ang)
    eji = jnp.sin(ang)
    br = block[:, None, :, 0] * ejr + block[:, None, :, 1] * eji
    bi = block[:, None, :, 1] * ejr - block[:, None, :, 0] * eji
    # First-order tracker y_t = (1-k) y_{t-1} + k bb_t, y_{-1} = estim.
    a = jnp.full(br.shape, 1 - k, jnp.float32)

    def comb(l, r):
        return l[0] * r[0], l[1] * r[0] + r[1], l[2] * r[0] + r[2]

    a_o, yr_o, yi_o = jax.lax.associative_scan(
        comb, (a, k * br, k * bi), axis=2)
    yr = a_o * estim[..., 0:1] + yr_o
    yi = a_o * estim[..., 1:2] + yi_o
    active = (slot_i >= 0).astype(jnp.float32)[..., None]
    sub_r = jnp.sum(active * (yr * ejr - yi * eji), axis=1)
    sub_i = jnp.sum(active * (yr * eji + yi * ejr), axis=1)
    out = jnp.stack([block[:, :, 0] - sub_r,
                     block[:, :, 1] - sub_i], axis=-1) * gain[:, None,
                                                              None]
    new_est = jnp.stack([yr[..., -1], yi[..., -1]], axis=-1)
    return out, new_est


class BatchedAutoNotch:
    """auto_notch (sdr.h:46-154) over a channel fleet: batched-FFT
    detection, associative-scan tone tracking, batched subtraction."""

    NFFT = 4096

    def __init__(self, nchan: int, nslots: int,
                 agc_rms_setpoint: float = 0.0,
                 decimation: int = 1024 * 4096, k: float = 0.002):
        self.nchan = nchan
        self.nslots = nslots
        self.agc_rms_setpoint = agc_rms_setpoint
        self.decimation = decimation
        self.k = k
        self.slot_i = np.full((nchan, nslots), -1, np.int32)
        self.estim = np.zeros((nchan, nslots, 2), np.float32)
        self.gain = np.ones(nchan, np.float32)
        self.phase = 0
        self.backlog = _Backlog(nchan)

    def _detect(self, block: np.ndarray, power: np.ndarray):
        if self.agc_rms_setpoint:
            m2 = (block[..., 0] ** 2 + block[..., 1] ** 2).sum(axis=1)
            rms = np.sqrt(m2 / self.NFFT)
            nz = rms > 0
            self.gain[nz] = (self.gain[nz] * 0.9
                             + (self.agc_rms_setpoint / rms[nz]) * 0.1)
        amp = np.sqrt(power).copy()                     # [C, NFFT]
        for s in range(self.nslots):
            iamax = amp.argmax(axis=1)                  # [C]
            changed = iamax != self.slot_i[:, s]
            self.slot_i[:, s] = iamax
            self.estim[changed, s] = 0
            cols = np.stack([iamax - 1, iamax, iamax + 1], 1)
            cols = np.clip(cols, 0, self.NFFT - 1)
            np.put_along_axis(amp, cols, 0.0, axis=1)

    def process(self, x) -> np.ndarray:
        """x: [C, n, 2] -> notch-filtered [C, m, 2] (whole blocks)."""
        self.backlog.add(x)
        blocks = self.backlog.take(self.NFFT)
        if blocks is None:
            return np.empty((self.nchan, 0, 2), np.float32)
        outs = []
        for b in range(blocks.shape[1]):
            blk = blocks[:, b]
            self.phase += self.NFFT
            if self.phase >= self.decimation:
                self.phase -= self.decimation
                power = np.asarray(_batched_power(
                    jnp.asarray(blk[:, None]), self.NFFT))[:, 0]
                self._detect(blk, power)
            out, est = _notch_block(jnp.asarray(blk),
                                    jnp.asarray(self.slot_i),
                                    jnp.asarray(self.estim),
                                    jnp.asarray(self.gain),
                                    self.k, self.NFFT)
            self.estim = np.array(est)       # writable (np.asarray of a
                                             # device array is read-only)
            outs.append(np.asarray(out))
        return np.concatenate(outs, axis=1)


@partial(jax.jit, static_argnames=("taps", "decim", "count"))
def _tracking_fir(taps: tuple, decim: int, count: int,
                  freq: jnp.ndarray, buf: jnp.ndarray):
    """Decimating carrier-tracked FIR over a fleet (fir_filter,
    dsp.h:219-285): out[c, j] = sum_k taps_rot[c, k] * buf[c, n+j*d-k]
    with taps_rot[k] = taps[k] * exp(i*2pi*freq_c*(k - n//2)).

    buf: [C, m, 2] with m >= n + count*decim; freq: [C] cycles/sample.
    Returns [C, count, 2].
    """
    c = np.asarray(taps, np.float32)
    nt = c.shape[0]
    k = np.arange(nt, dtype=np.float32) - (nt // 2)
    ang = (2 * np.pi) * freq[:, None] * jnp.asarray(k)[None]
    cr = jnp.asarray(c)[None] * jnp.cos(ang)           # [C, nt]
    ci = jnp.asarray(c)[None] * jnp.sin(ang)
    xr, xi = buf[:, :, 0], buf[:, :, 1]
    C = buf.shape[0]
    zr = jnp.zeros((C, count), jnp.float32)
    zi = zr
    # out index j reads buf[nt + j*decim - k]; base offset for tap k is
    # nt - k, stride decim.
    for kk in range(nt):
        off = nt - kk
        sr = jax.lax.slice(xr, (0, off), (C, off + count * decim),
                           (1, decim))
        si = jax.lax.slice(xi, (0, off), (C, off + count * decim),
                           (1, decim))
        wr = cr[:, kk:kk + 1]
        wi = ci[:, kk:kk + 1]
        zr = zr + wr * sr - wi * si
        zi = zi + wr * si + wi * sr
    return jnp.stack([zr, zi], axis=-1)


class BatchedFirFilter:
    """fir_filter (dsp.h:219-285) over a channel fleet: per-channel
    carrier-rotated taps, decimation, streaming history — one fused
    device pass per chunk (the --resample stage for multi-channel
    runs; single-channel semantics in dsp/blocks.py:FirFilter)."""

    def __init__(self, nchan: int, coeffs, decim: int = 1):
        self.taps = tuple(float(v) for v in np.asarray(coeffs))
        self.n = len(self.taps)
        self.nchan = nchan
        self.decim = decim
        self.hist = np.zeros((nchan, self.n, 2), np.float32)
        self._primed = False

    def process(self, x, freq_tap=None) -> np.ndarray:
        """x: [C, n, 2]; freq_tap: [C] tracked carrier (cycles/sample).
        Returns decimated [C, m, 2]."""
        if freq_tap is None:
            freq_tap = np.zeros(self.nchan, np.float32)
        buf = np.concatenate([self.hist, np.asarray(x, np.float32)],
                             axis=1)
        if not self._primed:
            buf = buf[:, self.n:]
            self._primed = True
        count = (buf.shape[1] - self.n) // self.decim
        if count <= 0:
            keep = min(buf.shape[1], self.n + self.decim - 1)
            self.hist = buf[:, -keep:]
            return np.empty((self.nchan, 0, 2), np.float32)
        out = np.asarray(_tracking_fir(
            self.taps, self.decim, count, jnp.asarray(freq_tap),
            jnp.asarray(buf)))
        self.hist = buf[:, count * self.decim:]
        return out


# -- single-channel adapters -------------------------------------------------
#
# The single-channel CLI (pipelines/dvbs_rx.DvbsReceiver) reuses the
# batched device implementations above through complex-stream adapters,
# so on the GPU the CLI and the fleet run the SAME preprocessing code (the
# host dsp/blocks.py variants remain the CPU path and the parity
# reference).

def _c2p(z):
    return np.stack([z.real, z.imag], -1).astype(np.float32)[None]


class AutoNotch1:
    """blocks.AutoNotch interface over BatchedAutoNotch(nchan=1)."""

    def __init__(self, nslots: int, agc_rms_setpoint: float = 0.0):
        self.b = BatchedAutoNotch(1, nslots, agc_rms_setpoint)

    def process(self, z: np.ndarray) -> np.ndarray:
        y = self.b.process(_c2p(np.asarray(z, np.complex64)))[0]
        return (y[:, 0] + 1j * y[:, 1]).astype(np.complex64)


class CnrFft1:
    """blocks.CnrFft interface over BatchedCnrFft(nchan=1)."""

    def __init__(self, bandwidth: float):
        self.b = BatchedCnrFft(1, bandwidth)

    @property
    def decimation(self):
        return self.b.decimation

    @decimation.setter
    def decimation(self, v):
        self.b.decimation = v

    def process(self, z, freq_tap: float = 0.0):
        vs = self.b.process(_c2p(np.asarray(z, np.complex64)),
                            np.asarray([freq_tap], np.float32))
        return [float(v[0]) for v in vs]


class Spectrum1:
    """blocks.Spectrum interface over BatchedSpectrum(nchan=1)."""

    def __init__(self):
        self.b = BatchedSpectrum(1)

    @property
    def decimation(self):
        return self.b.decimation

    @decimation.setter
    def decimation(self, v):
        self.b.decimation = v

    def process(self, z):
        return [line[0] for line in
                self.b.process(_c2p(np.asarray(z, np.complex64)))]
