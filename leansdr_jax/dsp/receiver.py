"""The constellation receiver: carrier PLL + Mueller&Muller timing + soft
demapping, as a batched `lax.scan`.

Re-designs cstln_receiver (reference sdr.h:697-938) for a device: the
per-sample feedback loop (2nd-order PLL, decision-directed modified M&M
timing, sdr.h:800-847) is the one irreducible recurrence in the whole
receive chain, so it runs as a `lax.scan` over samples with all independent
channels (and, later, demodulation hypotheses) batched on vector lanes.
Everything around it — derotation tables, constellation LUT gathers, AGC,
MER estimation — is vectorized inside the scan body or hoisted to chunk
boundaries exactly where the reference updates them (chunk_size=128,
sdr.h:706).

All magic constants match Appendix A of SURVEY.md: freq_alpha=0.04,
freq_beta=0.0012/omega*pll_adjustment, gain_mu=0.02/cstln_amp^2*2,
max_mucorr=0.1, kest=0.01, angle convention 65536=2pi.
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .math_utils import trig16_table, atan2_poly
from .cstln import CSTLN_AMP, Cstln

CHUNK = 128


@dataclass(frozen=True)
class ReceiverParams:
    """Static configuration (compiled into the jitted step)."""
    omega: float                 # samples per symbol
    sampler: str = "linear"      # "nearest" | "linear" | "rrc"
    pll_adjustment: float = 1.0
    allow_drift: bool = False
    kest: float = 0.01
    meas_decimation: int = 1 << 20
    nsymbols: int = 4            # for BPSK MER special case + freq limits
    freq0: float = 0.0           # initial freq offset, cycles/sample
    # RRC sampler (fir_sampler, sdr.h:635-689):
    rrc_coeffs: tuple = ()       # float taps
    rrc_steps: int = 1           # subsampling
    # exact_lut=True gathers the reference's precomputed 256x256 decision
    # grid + trig16 table (bit-exact against the C++ trajectories).
    # exact_lut=False computes the same quantities on the VPU with no
    # gathers: integer symbol distances over the s8-quantized grid give
    # bit-identical decisions and costs; trig/atan2 agree to ~1 ulp.
    # The gather-free path is the one the demod kernel implements.
    exact_lut: bool = True
    # True: omega (and the derived loop constants / freq limits) come
    # from per-channel state arrays instead of this static scalar —
    # enables batching candidate symbol rates as channels (the
    # leansdrscan configuration sweep as one device batch).
    omega_per_channel: bool = False

    @property
    def readahead(self) -> int:
        if self.sampler == "nearest":
            return 0
        if self.sampler == "linear":
            return 1
        return (len(self.rrc_coeffs) - 1) // self.rrc_steps + 1

    @property
    def freq_limits(self) -> tuple:
        # update_freq_limits (sdr.h:755-770)
        n = {2: 2, 4: 4, 8: 8, 16: 12, 32: 16}.get(self.nsymbols, 4)
        freqw0 = self.freq0 * 65536
        half = 65536 / self.omega / n / 2
        return (freqw0 - half, freqw0 + half)


def per_channel_omega_state(params: ReceiverParams, omegas):
    """State entries for omega_per_channel mode: one candidate symbol
    rate per channel (freq_beta and freq limits follow omega)."""
    omegas = np.asarray(omegas, np.float32)
    n = {2: 2, 4: 4, 8: 8, 16: 12, 32: 16}.get(params.nsymbols, 4)
    freqw0 = params.freq0 * 65536
    half = 65536 / omegas / n / 2
    return {
        "omega": jnp.asarray(omegas),
        "freq_beta": jnp.asarray(
            (0.0012 / omegas * params.pll_adjustment).astype(np.float32)),
        "min_freqw": jnp.asarray((freqw0 - half).astype(np.float32)),
        "max_freqw": jnp.asarray((freqw0 + half).astype(np.float32)),
    }


def init_state(params: ReceiverParams, nchan: int):
    """Initial per-channel loop state (mirrors sdr.h:724-736)."""
    C = nchan
    extra = {}
    if params.omega_per_channel:
        extra.update(per_channel_omega_state(
            params, np.full(C, params.omega, np.float32)))
    if params.sampler == "rrc":
        nc = len(params.rrc_coeffs)
        extra.update({
            # update_freq_phase starts 0 -> first chunk shifts the coeffs
            # (fir_sampler, sdr.h:640, 667-675).
            "rrc_phase": jnp.zeros(C, jnp.int32),
            "rrc_shifted": jnp.zeros((C, nc, 2), jnp.float32),
        })
    return extra | {
        "mu": jnp.zeros(C, jnp.float32),
        "phase": jnp.zeros(C, jnp.float32),
        "freqw": jnp.full(C, params.freq0 * 65536, jnp.float32),
        "hist_p": jnp.zeros((C, 3, 2), jnp.float32),
        "hist_c": jnp.zeros((C, 3, 2), jnp.float32),
        "est_insp": jnp.full(C, CSTLN_AMP * CSTLN_AMP, jnp.float32),
        "agc_gain": jnp.ones(C, jnp.float32),
        "est_sp": jnp.zeros(C, jnp.float32),
        "est_ep": jnp.zeros(C, jnp.float32),
        "meas_count": jnp.zeros(C, jnp.int32),
    }


def _lookup(tabs, I, Q):
    """LUT gather with the reference's overflow-halving and s8 truncation
    (sdr.h:470-485) — delegates to the one implementation."""
    from .cstln import lookup_float
    return lookup_float(*tabs, I, Q)


def _expi(trig, a):
    """trig16.expi(float): truncate toward zero, wrap to u16 (math.h:108)."""
    from .math_utils import expi_float
    e = expi_float(trig, a)
    return e[..., 0], e[..., 1]


def _expi_computed(a):
    """Gather-free expi: same u16 angle quantization, cos/sin on the VPU."""
    idx = (jnp.trunc(a).astype(jnp.int32) & 0xFFFF).astype(jnp.float32)
    ang = idx * jnp.float32(2 * np.pi / 65536)
    return jnp.cos(ang), jnp.sin(ang)


def _lookup_computed(tables, I, Q):
    """Gather-free constellation decision over the s8-quantized grid.

    Reproduces the LUT contents (sdr.h:529-559) by direct computation:
    integer squared distances to each constellation point -> nearest
    (first-wins ties like the reference's strict '<' scan) and
    second-nearest; cost = clamp(d1)-clamp(d2); phase error =
    atan2(Q,I) - atan2(sym) scaled to the s16 angle convention.
    """
    sym_re, sym_im = tables["sym_re"], tables["sym_im"]      # [nsym] f32
    sym_phase = tables["sym_phase"]                          # [nsym] f32
    for _ in range(12):    # 12 rounds like the reference (sdr.h:470-485)
        over = (I < -128) | (I > 127) | (Q < -128) | (Q > 127)
        I = jnp.where(over, I * 0.5, I)
        Q = jnp.where(over, Q * 0.5, Q)
    i8 = jnp.trunc(I)
    q8 = jnp.trunc(Q)
    d = ((i8[:, None] - sym_re) ** 2 + (q8[:, None] - sym_im) ** 2)
    near = jnp.argmin(d, axis=1)
    onehot = jax.nn.one_hot(near, d.shape[1], dtype=jnp.float32)
    d1 = jnp.min(d, axis=1)
    d2 = jnp.min(jnp.where(onehot > 0, jnp.inf, d), axis=1)
    cost = (jnp.minimum(d1, 32767.0) - jnp.minimum(d2, 32767.0)
            ).astype(jnp.int16)
    ph_sym = jnp.sum(onehot * sym_phase, axis=1)
    ph_err = atan2_poly(q8, i8) - ph_sym
    pe = jnp.trunc(ph_err * jnp.float32(65536) / jnp.float32(2 * np.pi)
                   ).astype(jnp.int32)
    pe16 = (((pe & 0xFFFF) ^ 0x8000) - 0x8000).astype(jnp.int16)
    cpt_re = jnp.sum(onehot * sym_re, axis=1)
    cpt_im = jnp.sum(onehot * sym_im, axis=1)
    return cost, near.astype(jnp.uint8), pe16, cpt_re, cpt_im


def run_chunks_impl(params: ReceiverParams, tables, state, x):
    """Demodulate [C, n] complex samples (as [C, n, 2] float32 planes).

    n must be a multiple of CHUNK, plus `params.readahead` extra samples of
    lookahead at the end. Returns (state, outputs) where outputs contains
    per-sample symbol decisions with validity masks plus per-chunk
    measurement snapshots:
      cost   [C, nsamp] int16     soft metric of emitted symbol
      symbol [C, nsamp] uint8     hard decision
      valid  [C, nsamp] bool      True where a symbol was emitted
      sampled[C, K, 2]  float32   last interpolated symbol per chunk
      freq   [C, K] float32       freq_tap per chunk (cycles/sample)
      ss     [C, K] float32       signal strength per chunk
      mer    [C, K] float32       MER dB per chunk
      nmeas  [C, K] int32         measurements due per chunk
    """
    trig = tables["trig"]
    tabs = (tables["lut_cost"], tables["lut_symbol"], tables["lut_phase"])
    cstln_pts = tables["symbols"]          # [nsym, 2] float32

    C, n, _ = x.shape
    ra = params.readahead
    nsamp = n - ra
    K = nsamp // CHUNK

    freq_alpha = jnp.float32(0.04)
    gain_mu = jnp.float32(0.02 / (CSTLN_AMP * CSTLN_AMP) * 2)
    if params.omega_per_channel:
        omega = state["omega"]
        freq_beta = state["freq_beta"]
        min_freqw = state["min_freqw"]
        max_freqw = state["max_freqw"]
    else:
        freq_beta = jnp.float32(0.0012 / params.omega
                                * params.pll_adjustment)
        omega = jnp.float32(params.omega)
        min_freqw, max_freqw = params.freq_limits
    use_rrc = params.sampler == "rrc"
    if use_rrc:
        rrc_c = jnp.asarray(np.asarray(params.rrc_coeffs, np.float32))
        ncoeffs = rrc_c.shape[0]
        sub = params.rrc_steps

    def sample_step(carry, inp):
        st, chunk_freqw, last = carry
        pin0, pin1 = inp          # [C,2] each (re,im)
        mu, phase, freqw = st["mu"], st["phase"], st["freqw"]
        emit = mu < 1.0

        expi = (lambda a: _expi(trig, a)) if params.exact_lut \
            else _expi_computed

        # --- sampler->interp (linear_sampler, sdr.h:617-623) ---
        if params.sampler == "linear":
            c0, s0 = expi(-phase)
            sg0_re = pin0[:, 0] * c0 - pin0[:, 1] * s0
            sg0_im = pin0[:, 0] * s0 + pin0[:, 1] * c0
            if params.exact_lut:
                c1, s1 = expi(-(phase + chunk_freqw))
            else:
                # Fast path (mirrors the Pallas kernel): derive the
                # second rotation from the first by one angle addition
                # with the chunk-constant delta.
                idx_d = jnp.trunc(-chunk_freqw)
                idx_d = idx_d - jnp.floor(idx_d / 65536.0) * 65536.0
                a_d = idx_d * jnp.float32(2 * np.pi / 65536)
                dc, dsn = jnp.cos(a_d), jnp.sin(a_d)
                c1 = c0 * dc - s0 * dsn
                s1 = s0 * dc + c0 * dsn
            sg1_re = pin1[:, 0] * c1 - pin1[:, 1] * s1
            sg1_im = pin1[:, 0] * s1 + pin1[:, 1] * c1
            sg_re = sg0_re * (1 - mu) + sg1_re * mu
            sg_im = sg0_im * (1 - mu) + sg1_im * mu
        elif params.sampler == "nearest":
            c0, s0 = expi(-phase)
            sg_re = pin0[:, 0] * c0 - pin0[:, 1] * s0
            sg_im = pin0[:, 0] * s0 + pin0[:, 1] * c0
        elif params.sampler == "rrc":
            # fir_sampler.interp (sdr.h:646-665): polyphase matched filter
            # at phase index (1-mu)*subsampling, stride subsampling, then
            # ONE derotation of the accumulated sum.
            win = pin1                       # [C, ntaps, 2] window view
            sub = params.rrc_steps
            nc = len(params.rrc_coeffs)
            ntaps = win.shape[1]
            idx0 = jnp.trunc((1 - mu) * sub).astype(jnp.int32)   # [C]
            pc = idx0[:, None] + jnp.arange(ntaps)[None, :] * sub
            ok = pc < nc
            pcc = jnp.minimum(pc, nc - 1)
            co = jnp.take_along_axis(
                st["rrc_shifted"], pcc[:, :, None], axis=1)      # [C,ntaps,2]
            okf = ok.astype(jnp.float32)
            acc_re = jnp.sum(okf * (co[:, :, 0] * win[:, :, 0]
                                    - co[:, :, 1] * win[:, :, 1]), axis=1)
            acc_im = jnp.sum(okf * (co[:, :, 0] * win[:, :, 1]
                                    + co[:, :, 1] * win[:, :, 0]), axis=1)
            c0, s0 = expi(-phase)
            sg_re = c0 * acc_re - s0 * acc_im
            sg_im = c0 * acc_im + s0 * acc_re
        else:
            raise NotImplementedError(params.sampler)

        s_re = sg_re * st["agc_gain"]
        s_im = sg_im * st["agc_gain"]

        if params.exact_lut:
            cost, sym, perr = _lookup(tabs, s_re, s_im)
            cpt = cstln_pts[sym]
            cpt_re, cpt_im = cpt[:, 0], cpt[:, 1]
        else:
            cost, sym, perr, cpt_re, cpt_im = _lookup_computed(
                tables, s_re, s_im)
        perr_f = perr.astype(jnp.float32)

        # --- PLL (sdr.h:813-815) ---
        phase_u = phase + perr_f * freq_alpha
        freqw_u = freqw + perr_f * freq_beta

        # --- modified Mueller & Muller (sdr.h:817-840) ---
        hp, hc = st["hist_p"], st["hist_c"]
        h0p = jnp.stack([s_re, s_im], axis=-1)
        h0c = jnp.stack([cpt_re, cpt_im], axis=-1)
        # hist[0]=new, hist[1]=hp[:,0] (previous), hist[2]=hp[:,1]:
        # muerr = dot(p[k]-p[k-2], c[k-1]) - dot(c[k]-c[k-2], p[k-1])
        muerr = ((h0p[:, 0] - hp[:, 1, 0]) * hc[:, 0, 0] +
                 (h0p[:, 1] - hp[:, 1, 1]) * hc[:, 0, 1]) - \
                ((h0c[:, 0] - hc[:, 1, 0]) * hp[:, 0, 0] +
                 (h0c[:, 1] - hc[:, 1, 1]) * hp[:, 0, 1])
        mucorr = jnp.clip(muerr * gain_mu, -0.1, 0.1)
        mu_u = mu + mucorr + omega

        # Commit updates only on emitting samples.
        emf = emit[:, None]
        new_hist_p = jnp.where(
            emit[:, None, None],
            jnp.stack([h0p, hp[:, 0], hp[:, 1]], axis=1), hp)
        new_hist_c = jnp.where(
            emit[:, None, None],
            jnp.stack([h0c, hc[:, 0], hc[:, 1]], axis=1), hc)
        mu = jnp.where(emit, mu_u, mu)
        phase = jnp.where(emit, phase_u, phase)
        freqw = jnp.where(emit, freqw_u, freqw)

        # Track last emitted interp for chunk-end AGC/MER (sdr.h:857-890).
        last_sg = jnp.where(emf, jnp.stack([sg_re, sg_im], -1), last["sg"])
        last_s = jnp.where(emf, jnp.stack([s_re, s_im], -1), last["s"])
        last_sym = jnp.where(emit, sym, last["sym"])
        last_any = last["any"] | emit

        # Next sample (sdr.h:843-846).
        mu = mu - 1.0
        phase = phase + freqw

        st = dict(st, mu=mu, phase=phase, freqw=freqw,
                  hist_p=new_hist_p, hist_c=new_hist_c)
        last = dict(sg=last_sg, s=last_s, sym=last_sym, any=last_any)
        out = (jnp.where(emit, cost, 0).astype(jnp.int16),
               jnp.where(emit, sym, 0).astype(jnp.uint8),
               emit)
        return (st, chunk_freqw, last), out

    def chunk_step(state, xc):
        # xc: [CHUNK, C, 2, 2] (pin0, pin1) pairs, or [CHUNK, C, ntaps, 2]
        # windows for the rrc sampler.
        chunk_freqw = state["freqw"]       # sampler->update_freq (sdr.h:790)
        if use_rrc:
            # Throttled coefficient re-shift (sdr.h:667-682): one update
            # per ncoeffs*16 processed samples.
            ph = state["rrc_phase"] - CHUNK
            do_upd = ph <= 0
            ph = jnp.where(do_upd, ncoeffs * 16, ph)
            f = state["freqw"] / sub                              # [C]
            i_c = jnp.arange(ncoeffs, dtype=jnp.float32) - ncoeffs // 2
            if params.exact_lut:
                ec, es = _expi(trig, -f[:, None] * i_c[None, :])
            else:
                ec, es = _expi_computed(-f[:, None] * i_c[None, :])
            shifted = jnp.stack([ec * rrc_c[None, :],
                                 es * rrc_c[None, :]], axis=-1)
            rrc_shifted = jnp.where(do_upd[:, None, None], shifted,
                                    state["rrc_shifted"])
            state = dict(state, rrc_phase=ph, rrc_shifted=rrc_shifted)
        last0 = {
            "sg": jnp.zeros((C, 2), jnp.float32),
            "s": jnp.zeros((C, 2), jnp.float32),
            "sym": jnp.zeros(C, jnp.uint8),
            "any": jnp.zeros(C, bool),
        }
        xs_pair = (xc, xc) if use_rrc else (xc[:, :, 0], xc[:, :, 1])
        (state, _, last), (cost, sym, valid) = jax.lax.scan(
            sample_step, (state, chunk_freqw, last0), xs_pair, unroll=8)

        # ---- end of chunk (sdr.h:852-913) ----
        phase = jnp.fmod(state["phase"], 65536.0)

        any_sym = last["any"]
        sg, s, symv = last["sg"], last["s"], last["sym"]
        insp = sg[:, 0] ** 2 + sg[:, 1] ** 2
        kest = jnp.float32(params.kest)
        est_insp = jnp.where(any_sym,
                             insp * kest + state["est_insp"] * (1 - kest),
                             state["est_insp"])
        agc_gain = jnp.where(any_sym & (est_insp > 0),
                             CSTLN_AMP / jnp.sqrt(est_insp),
                             state["agc_gain"])
        cpt = cstln_pts[symv]
        ev = s - cpt
        if params.nsymbols == 2:
            sig_real = (cpt[:, 0] + cpt[:, 1]) * jnp.float32(0.707)
            ev_real = (ev[:, 0] + ev[:, 1]) * jnp.float32(0.707)
            sig_power = sig_real * sig_real
            ev_power = ev_real * ev_real
        else:
            sig_power = cpt[:, 0] ** 2 + cpt[:, 1] ** 2
            ev_power = ev[:, 0] ** 2 + ev[:, 1] ** 2
        est_sp = jnp.where(any_sym,
                           sig_power * kest + state["est_sp"] * (1 - kest),
                           state["est_sp"])
        est_ep = jnp.where(any_sym,
                           ev_power * kest + state["est_ep"] * (1 - kest),
                           state["est_ep"])

        freqw = state["freqw"]
        if not params.allow_drift:
            bad = (freqw < min_freqw) | (freqw > max_freqw)
            freqw = jnp.where(bad, (min_freqw + max_freqw) / 2, freqw)

        meas_count = state["meas_count"] + CHUNK
        nmeas = (meas_count // params.meas_decimation).astype(jnp.int32)
        meas_count = meas_count % params.meas_decimation

        freq_tap = freqw / 65536.0
        ss = jnp.sqrt(est_insp)
        mer = jnp.where(est_ep > 0,
                        10 * jnp.log(est_sp / est_ep) / jnp.log(10.0), 0.0)

        state = dict(state, phase=phase, freqw=freqw, est_insp=est_insp,
                     agc_gain=agc_gain, est_sp=est_sp, est_ep=est_ep,
                     meas_count=meas_count)
        meta = (s, freq_tap, ss, mer, nmeas)
        return state, ((cost, sym, valid), meta)

    if use_rrc:
        # Window views for the polyphase sampler: win[t] = x[:, t:t+ntaps].
        ntaps = (ncoeffs + sub - 1) // sub
        win = jnp.stack([x[:, j:j + nsamp] for j in range(ntaps)], axis=2)
        xs = win.transpose(1, 0, 2, 3).reshape(K, CHUNK, C, ntaps, 2)
    else:
        # Per-sample (pin0, pin1) views: [K, CHUNK, C, 2, 2]
        pin0 = x[:, :nsamp]
        pin1 = x[:, 1:nsamp + 1] if ra >= 1 else x[:, :nsamp]
        pairs = jnp.stack([pin0, pin1], axis=2)     # [C, nsamp, 2, 2]
        xs = pairs.transpose(1, 0, 2, 3).reshape(K, CHUNK, C, 2, 2)

    state, ((cost, sym, valid), meta) = jax.lax.scan(chunk_step, state, xs)
    # cost/sym/valid: [K, CHUNK, C] -> [C, K*CHUNK]
    cost = cost.transpose(2, 0, 1).reshape(C, nsamp)
    sym = sym.transpose(2, 0, 1).reshape(C, nsamp)
    valid = valid.transpose(2, 0, 1).reshape(C, nsamp)
    sampled, freq, ss, mer, nmeas = [m.transpose(1, 0, *range(2, m.ndim))
                                     for m in meta]
    outputs = dict(cost=cost, symbol=sym, valid=valid, sampled=sampled,
                   freq=freq, ss=ss, mer=mer, nmeas=nmeas)
    return state, outputs


run_chunks = partial(jax.jit, static_argnames=("params",))(run_chunks_impl)


def make_tables(cstln: Cstln):
    """Device-resident tables for run_chunks."""
    sym = cstln.symbols.astype(np.float32)
    return {
        "trig": jnp.asarray(trig16_table()),
        "lut_cost": jnp.asarray(cstln.lut_cost),
        "lut_symbol": jnp.asarray(cstln.lut_symbol),
        "lut_phase": jnp.asarray(cstln.lut_phase),
        "symbols": jnp.asarray(sym),
        # For the gather-free computed path:
        "sym_re": jnp.asarray(sym[:, 0]),
        "sym_im": jnp.asarray(sym[:, 1]),
        "sym_phase": jnp.asarray(
            np.arctan2(sym[:, 1], sym[:, 0]).astype(np.float32)),
    }
