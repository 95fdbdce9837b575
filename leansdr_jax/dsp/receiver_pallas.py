"""Pallas kernel (Triton route) for the constellation receiver hot loop.

The XLA `lax.scan` path (receiver.py) is behavior-exact but runs one
device-loop iteration per sample step. This kernel runs the whole
per-sample recurrence inside one program: each program owns a block of
LANE_BLOCK lanes (a lane is one channel, or one channel x time segment),
one thread per lane, and walks every sample of the chunk with all loop
state in registers. The reference's 128-sample chunk-boundary updates
(AGC/MER/clamp/phase-wrap, sdr.h:852-898) run inside that loop.

Samples are laid out [nsamp+1, lanes] so each step reads one coalesced
row; the last row is the lookahead sample the linear sampler peeks at.

Decision math is the gather-free computed form proven equivalent to the
256x256 LUT in receiver._lookup_computed: integer squared distances over
the s8-quantized grid (bit-identical symbol + cost), trig/atan2 computed
in registers (~1 ulp vs the trig16 table).

Outputs are packed one int32 per sample per lane:
  bits 0..15  = -cost  (0..32767)
  bits 16..23 = symbol
  bit  24     = valid (symbol emitted at this sample)

State is a [NSTATE, lanes] float32 plane stack (pack_state).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .cstln import CSTLN_AMP, Cstln
from .math_utils import atan2_poly as _atan2
from .receiver import ReceiverParams, CHUNK

LANE_BLOCK = 32          # lanes per program: one warp, one lane per thread
GROUP = 8                # samples whose input rows are loaded together
NSTATE = 19
# plane index: 0 mu, 1 phase, 2 freqw, 3 agc_gain, 4 est_insp, 5 est_sp,
# 6 est_ep, 7..12 hist_p (re,im) for k, k-1, k-2, 13..18 hist_c likewise.


def sym_constants(cstln: Cstln):
    """Static constellation constants for demod_pallas."""
    sym = cstln.symbols.astype(np.float32)
    phase = np.arctan2(sym[:, 1], sym[:, 0]).astype(np.float32)
    return (tuple(float(v) for v in sym[:, 0]),
            tuple(float(v) for v in sym[:, 1]),
            tuple(float(v) for v in phase))


def _mkparams(params: ReceiverParams):
    f32 = jnp.float32
    return dict(
        omega=f32(params.omega),
        freq_alpha=f32(0.04),
        freq_beta=f32(0.0012 / params.omega * params.pll_adjustment),
        gain_mu=f32(0.02 / (CSTLN_AMP * CSTLN_AMP) * 2),
        kest=f32(params.kest),
        min_freqw=f32(params.freq_limits[0]),
        max_freqw=f32(params.freq_limits[1]),
    )


def _is_qpsk_grid(sym_re, sym_im) -> bool:
    """QPSK sign-quadrant grid in the 0:(+,+) 1:(+,-) 2:(-,+) 3:(-,-)
    order: the 4-symbol argmin collapses to a closed form."""
    return (len(sym_re) == 4
            and len({abs(v) for v in sym_re} | {abs(v) for v in sym_im}) == 1
            and [(v > 0, w > 0) for v, w in zip(sym_re, sym_im)]
            == [(True, True), (True, False), (False, True), (False, False)])


def _demod_kernel(params: ReceiverParams, sym_re, sym_im, sym_phase, nT,
                  xre_ref, xim_ref, st_in_ref, st_out_ref, out_ref):
    """One program = one LANE_BLOCK-lane block over the whole chunk."""
    P = _mkparams(params)
    nsym = len(sym_re)
    qpsk_grid = _is_qpsk_grid(sym_re, sym_im)
    f32, i32 = jnp.float32, jnp.int32

    def sample(r, x0r, x0i, x1r, x1i, dcos, dsin, agc_gain, carry):
        (mu, phase, freqw, p0r, p0i, p1r, p1i, p2r, p2i,
         c0r, c0i, c1r, c1i, c2r, c2i,
         lsg_re, lsg_im, ls_re, ls_im, lc_re, lc_im, any_f) = carry
        emit = mu < 1.0

        # linear sampler interp (sdr.h:617-623); -phase rotation.
        # expi(float a): truncate toward zero FIRST, then wrap mod 65536
        # (math.h:108-110 casts (uint16)(int16)(int32)a). The second
        # rotation is the first advanced by the chunk-constant delta.
        idx0 = jnp.trunc(-phase)
        idx0 = idx0 - jnp.floor(idx0 / 65536.0) * 65536.0
        a0 = idx0 * f32(2 * np.pi / 65536)
        cr0 = jnp.cos(a0)
        sr0 = jnp.sin(a0)
        cr1 = cr0 * dcos - sr0 * dsin
        sr1 = sr0 * dcos + cr0 * dsin
        sg0_re = x0r * cr0 - x0i * sr0
        sg0_im = x0r * sr0 + x0i * cr0
        sg1_re = x1r * cr1 - x1i * sr1
        sg1_im = x1r * sr1 + x1i * cr1
        sg_re = sg0_re * (1 - mu) + sg1_re * mu
        sg_im = sg0_im * (1 - mu) + sg1_im * mu

        s_re = sg_re * agc_gain
        s_im = sg_im * agc_gain

        # Constellation decision (computed LUT semantics). The reference
        # halves out-of-range IQ up to 12 rounds (sdr.h:470-485); round
        # j triggers iff any coordinate exceeds [-128*2^j, 127*2^j], so
        # the round count is k = min(12, max over coords/sides of
        # ceil(log2(v / bound))), computed EXACTLY from the f32 exponent
        # bits: for positive normals v > b*2^j <=> bits(v) > bits(b) +
        # (j << 23). 2^-k is built directly as exponent bits.
        I, Q = s_re, s_im
        B_HI = i32(0x42FE0000)       # bits(127.0f)
        B_LO = i32(0x43000000)       # bits(128.0f)

        def _kceil(v, bref, bound):
            b = jax.lax.bitcast_convert_type(v, i32)
            k = (b - bref + i32(0x7FFFFF)) >> 23
            return jnp.where(v > bound, k, 0)

        k_half = jnp.maximum(
            jnp.maximum(_kceil(I, B_HI, 127.0), _kceil(-I, B_LO, 128.0)),
            jnp.maximum(_kceil(Q, B_HI, 127.0), _kceil(-Q, B_LO, 128.0)))
        k_half = jnp.minimum(k_half, 12)
        scale = jax.lax.bitcast_convert_type((i32(127) - k_half) << 23, f32)
        i8 = jnp.trunc(I * scale)
        q8 = jnp.trunc(Q * scale)
        if qpsk_grid:
            # All quantities are integers < 2^24, so the closed form is
            # bit-identical to the argmin (ties at 0 go to the lower
            # index, as the strict-< scan picks).
            a = sym_re[0]
            ai = jnp.abs(i8)
            aq = jnp.abs(q8)
            d1 = (ai - a) ** 2 + (aq - a) ** 2
            d2 = d1 + (4 * a) * jnp.minimum(ai, aq)
            neg_i = i8 < 0
            neg_q = q8 < 0
            near = neg_i.astype(i32) * 2 + neg_q.astype(i32)
            cpt_re = jnp.where(neg_i, f32(-a), f32(a))
            cpt_im = jnp.where(neg_q, f32(-a), f32(a))
            ph_sym = jnp.where(
                neg_q,
                jnp.where(neg_i, sym_phase[3], sym_phase[1]),
                jnp.where(neg_i, sym_phase[2], sym_phase[0]))
        else:
            d1 = jnp.full_like(i8, 3.4e38)
            d2 = jnp.full_like(i8, 3.4e38)
            near = jnp.zeros_like(i8, i32)
            cpt_re = cpt_im = ph_sym = jnp.zeros_like(i8)
            for s in range(nsym):
                ds = (i8 - sym_re[s]) ** 2 + (q8 - sym_im[s]) ** 2
                better = ds < d1
                d2 = jnp.where(better, d1, jnp.minimum(d2, ds))
                d1 = jnp.where(better, ds, d1)
                near = jnp.where(better, s, near)
                cpt_re = jnp.where(better, sym_re[s], cpt_re)
                cpt_im = jnp.where(better, sym_im[s], cpt_im)
                ph_sym = jnp.where(better, sym_phase[s], ph_sym)
        cost = jnp.minimum(d1, 32767.0) - jnp.minimum(d2, 32767.0)

        ph_err = _atan2(q8, i8) - ph_sym
        pe_i = jnp.trunc(ph_err * f32(65536 / (2 * np.pi))).astype(i32)
        pe16 = ((pe_i & 0xFFFF) ^ 0x8000) - 0x8000
        perr_f = pe16.astype(f32)

        # PLL (sdr.h:813-815)
        phase_u = phase + perr_f * P["freq_alpha"]
        freqw_u = freqw + perr_f * P["freq_beta"]

        # modified M&M (sdr.h:817-840):
        # muerr = dot(p[k]-p[k-2], c[k-1]) - dot(c[k]-c[k-2], p[k-1])
        muerr = ((s_re - p1r) * c0r + (s_im - p1i) * c0i) - \
                ((cpt_re - c1r) * p0r + (cpt_im - c1i) * p0i)
        mucorr = jnp.clip(muerr * P["gain_mu"], -0.1, 0.1)
        mu_u = mu + mucorr + P["omega"]

        def upd(new, old):
            return jnp.where(emit, new, old)

        out = (upd(mu_u, mu) - 1.0,
               upd(phase_u, phase) + upd(freqw_u, freqw),
               upd(freqw_u, freqw),
               upd(s_re, p0r), upd(s_im, p0i), upd(p0r, p1r),
               upd(p0i, p1i), upd(p1r, p2r), upd(p1i, p2i),
               upd(cpt_re, c0r), upd(cpt_im, c0i), upd(c0r, c1r),
               upd(c0i, c1i), upd(c1r, c2r), upd(c1i, c2i),
               upd(sg_re, lsg_re), upd(sg_im, lsg_im),
               upd(s_re, ls_re), upd(s_im, ls_im),
               upd(cpt_re, lc_re), upd(cpt_im, lc_im),
               upd(1.0, any_f))
        packed = ((-cost).astype(i32) | (near << 16)
                  | (emit.astype(i32) << 24))
        out_ref[pl.ds(r, 1), :] = packed
        return out

    def chunk(ci, st):
        (mu, phase, freqw, agc_gain, est_insp, est_sp, est_ep,
         p0r, p0i, p1r, p1i, p2r, p2i, c0r, c0i, c1r, c1i, c2r, c2i) = st
        # sampler->update_freq at chunk start: the pin1 rotation delta.
        idx_d = jnp.trunc(-freqw)
        idx_d = idx_d - jnp.floor(idx_d / 65536.0) * 65536.0
        a_d = idx_d * f32(2 * np.pi / 65536)
        dcos = jnp.cos(a_d)
        dsin = jnp.sin(a_d)
        zero = jnp.zeros_like(mu)

        def group(g, c):
            # All GROUP+1 input rows are loaded before the recurrence
            # needs the first: their memory latency overlaps instead of
            # stalling every sample step.
            r = ci * CHUNK + g * GROUP
            xr = [xre_ref[pl.ds(r + i, 1), :] for i in range(GROUP + 1)]
            xi = [xim_ref[pl.ds(r + i, 1), :] for i in range(GROUP + 1)]
            for i in range(GROUP):
                c = sample(r + i, xr[i], xi[i], xr[i + 1], xi[i + 1],
                           dcos, dsin, agc_gain, c)
            return c

        (mu, phase, freqw, p0r, p0i, p1r, p1i, p2r, p2i,
         c0r, c0i, c1r, c1i, c2r, c2i,
         lsg_re, lsg_im, ls_re, ls_im, lc_re, lc_im, any_f) = \
            jax.lax.fori_loop(0, CHUNK // GROUP, group,
                              (mu, phase, freqw, p0r, p0i, p1r, p1i, p2r,
                               p2i, c0r, c0i, c1r, c1i, c2r, c2i)
                              + (zero,) * 7)

        # ---- chunk-end updates (sdr.h:852-898) ----
        any_sym = any_f > 0
        phase = phase - jnp.trunc(phase / 65536.0) * 65536.0   # fmodf
        insp = lsg_re * lsg_re + lsg_im * lsg_im
        kest = P["kest"]
        est_insp = jnp.where(any_sym, insp * kest + est_insp * (1 - kest),
                             est_insp)
        agc_gain = jnp.where(any_sym & (est_insp > 0),
                             CSTLN_AMP / jnp.sqrt(est_insp), agc_gain)
        ev_re = ls_re - lc_re
        ev_im = ls_im - lc_im
        if params.nsymbols == 2:
            sig_r = (lc_re + lc_im) * f32(0.707)
            evr = (ev_re + ev_im) * f32(0.707)
            sig_power = sig_r * sig_r
            ev_power = evr * evr
        else:
            sig_power = lc_re * lc_re + lc_im * lc_im
            ev_power = ev_re * ev_re + ev_im * ev_im
        est_sp = jnp.where(any_sym, sig_power * kest + est_sp * (1 - kest),
                           est_sp)
        est_ep = jnp.where(any_sym, ev_power * kest + est_ep * (1 - kest),
                           est_ep)
        if not params.allow_drift:
            bad = (freqw < P["min_freqw"]) | (freqw > P["max_freqw"])
            freqw = jnp.where(bad, (P["min_freqw"] + P["max_freqw"]) / 2,
                              freqw)
        return (mu, phase, freqw, agc_gain, est_insp, est_sp, est_ep,
                p0r, p0i, p1r, p1i, p2r, p2i, c0r, c0i, c1r, c1i, c2r, c2i)

    st = tuple(st_in_ref[pl.ds(k, 1), :] for k in range(NSTATE))
    st = jax.lax.fori_loop(0, nT, chunk, st)
    for k in range(NSTATE):
        st_out_ref[pl.ds(k, 1), :] = st[k]


def pack_state(state) -> jnp.ndarray:
    """receiver.init_state dict [C,...] -> [NSTATE, C] planes."""
    hp = jnp.asarray(state["hist_p"], jnp.float32)   # [C,3,2]
    hc = jnp.asarray(state["hist_c"], jnp.float32)
    rows = [state[k] for k in ("mu", "phase", "freqw", "agc_gain",
                               "est_insp", "est_sp", "est_ep")]
    rows += [h[:, k, j] for h in (hp, hc) for k in range(3) for j in (0, 1)]
    return jnp.stack([jnp.asarray(r, jnp.float32) for r in rows])


def unpack_state(planes, C=None, meas_count=None):
    """[NSTATE, C] planes -> receiver state dict."""
    p = jnp.asarray(planes)[:, :C]
    C = p.shape[1]
    hist_p = jnp.stack([jnp.stack([p[7 + 2 * k], p[8 + 2 * k]], -1)
                        for k in range(3)], 1)
    hist_c = jnp.stack([jnp.stack([p[13 + 2 * k], p[14 + 2 * k]], -1)
                        for k in range(3)], 1)
    names = ("mu", "phase", "freqw", "agc_gain", "est_insp", "est_sp",
             "est_ep")
    return {k: p[i] for i, k in enumerate(names)} | {
        "hist_p": hist_p, "hist_c": hist_c,
        "meas_count": (meas_count if meas_count is not None
                       else jnp.zeros(C, jnp.int32)),
    }


@partial(jax.jit, static_argnames=("params", "sym_consts", "interpret",
                                   "lane_block"))
def demod_pallas(params: ReceiverParams, sym_consts, st_planes, x,
                 interpret=False, lane_block=LANE_BLOCK):
    """Run the kernel over [C, nsamp+1, 2] float32 IQ.

    sym_consts: static (tuple(re), tuple(im), tuple(phase)) floats —
    constellation points baked into the kernel (see sym_constants).
    st_planes: [NSTATE, C] (pack_state).

    Returns (new_state_planes [NSTATE, C], packed [nsamp, C] i32).
    nsamp must be a multiple of CHUNK.
    """
    C, n1, _ = x.shape
    nsamp = n1 - 1
    nT = nsamp // CHUNK
    assert nT * CHUNK == nsamp and st_planes.shape == (NSTATE, C)
    cpad = -(-C // lane_block) * lane_block
    xt = jnp.moveaxis(x, 0, 1)                      # [nsamp+1, C, 2]
    st = st_planes
    if cpad != C:
        xt = jnp.pad(xt, ((0, 0), (0, cpad - C), (0, 0)))
        st = jnp.pad(st, ((0, 0), (0, cpad - C)))

    kernel = partial(_demod_kernel, params, *sym_consts, nT)
    lanes = lambda rows: pl.BlockSpec((rows, lane_block), lambda i: (0, i))
    st_out, packed = pl.pallas_call(
        kernel,
        grid=(cpad // lane_block,),
        in_specs=[lanes(n1), lanes(n1), lanes(NSTATE)],
        out_specs=[lanes(NSTATE), lanes(nsamp)],
        out_shape=[
            jax.ShapeDtypeStruct((NSTATE, cpad), jnp.float32),
            jax.ShapeDtypeStruct((nsamp, cpad), jnp.int32),
        ],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=max(1, lane_block // 32), num_stages=1),
        interpret=interpret,
        name="demod_recurrence",
    )(xt[:, :, 0], xt[:, :, 1], st)
    return st_out[:, :C], packed[:, :C]


def unpack_outputs(packed, C=None):
    """[nsamp, C] i32 -> (cost i16 [C,nsamp], sym u8, valid bool)."""
    p = np.asarray(packed)[:, :C].T
    cost = (-(p & 0xFFFF)).astype(np.int16)
    sym = ((p >> 16) & 0xFF).astype(np.uint8)
    valid = (p >> 24) & 1
    return cost, sym, valid.astype(bool)


# ---------------------------------------------------------------------------
# Device-side output compaction: the raw [nsamp, C] int32 output is large;
# symbols only need 3 bits (valid<<2 | symbol) for QPSK-class
# constellations, so we bit-pack 8 samples per int32 on device before
# fetching. Costs (for --viterbi) pack 2 per int32.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("nchan", "want_cost"))
def pack_outputs(packed: jnp.ndarray, nchan: int, want_cost: bool = False):
    nsamp = packed.shape[0]
    flat = packed.reshape(nsamp, -1)[:, :nchan]          # [nsamp, C]
    # 8 samples x 4 bits (one nibble each: valid<<2 | symbol) per int32 —
    # byte-aligned for a branch-free host unpack.
    n8 = nsamp // 8
    v3 = ((flat >> 24 & 1) << 2) | ((flat >> 16) & 3)
    v3 = v3.reshape(n8, 8, nchan)
    word = jnp.zeros((n8, nchan), jnp.int32)
    for k in range(8):
        word = word | (v3[:, k] << (4 * k))
    if not want_cost:
        return word, None
    cost = flat & 0xFFFF                                 # -cost, 16 bits
    c2 = cost[: (nsamp // 2) * 2].reshape(nsamp // 2, 2, nchan)
    cword = c2[:, 0] | (c2[:, 1] << 16)
    return word, cword


def unpack_sym3(word: np.ndarray, nsamp: int):
    """[n8, C] i32 (nibble-packed) -> (sym u8 [C, nsamp], valid bool)."""
    w = np.ascontiguousarray(np.asarray(word).astype("<i4"))
    n8, C = w.shape
    b = w.view(np.uint8).reshape(n8, C, 4)   # byte k = samples 2k, 2k+1
    v = np.empty((n8, C, 4, 2), np.uint8)
    v[..., 0] = b & 0xF
    v[..., 1] = b >> 4
    v3 = v.reshape(n8, C, 8).transpose(1, 0, 2).reshape(C, n8 * 8)
    return (v3 & 3), (v3 >> 2).astype(bool)


def unpack_cost(cword: np.ndarray):
    w = np.asarray(cword)
    c = np.empty((w.shape[1], w.shape[0] * 2), np.int16)
    c[:, 0::2] = (-(w & 0xFFFF)).astype(np.int16).T
    c[:, 1::2] = (-((w >> 16) & 0xFFFF)).astype(np.int16).T
    return c
