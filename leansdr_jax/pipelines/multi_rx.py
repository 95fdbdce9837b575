"""Multi-channel DVB-S receiver: many independent carriers demodulated and
deconvolved in one device batch (the 64 x 2 Msps north-star shape,
BASELINE.json).

Chain layout per chunk (one host sync per chunk):

  device: demod (Pallas kernel / XLA scan, channels on lanes)
          -> symbol compaction ring (cumsum+scatter)
          -> all-hypothesis deconvolution (GF(2) convolution,
             sync x alignment election per ~4k-symbol sub-block)
          -> bit-packed byte streams [C, nbytes]
  host:   MPEG framing FSM (vectorized block decode, proto/framing.py)
          -> deinterleave (strided gather per channel)
          -> ONE batched RS(204,188) decode across all channels' packets
          -> vectorized derandomizer

Only decoded bytes cross the host link (~16x less than raw demod output);
fill watermarks/underflow flags ride in the same fetch. On a mesh,
channels shard across devices (parallel/mesh.py); this class is the
single-host building block.
"""

import numpy as np
import jax
import jax.numpy as jnp

from ..dsp import receiver
from .dvbs_rx import RxConfig, TS_SIZE, RS_SIZE, resolve_exact_lut
from ..dsp.cstln import make_dvbs2_constellation
from ..fec import interleave, prbs, rs
from ..fec.deconv_device import DeviceDeconvolver
from ..platform import families
from ..proto.framing import MpegSync
from functools import partial


@partial(jax.jit, static_argnames=("nd",))
def _pack_fetch(nd: int, fill: jnp.ndarray, *flat):
    """Concatenate `nd` decode results + the fill watermark into ONE u8
    array so the host link pays a single round trip per chunk.

    flat: nd triples (bytes [C,NB] u8, errs [C,E] i32, under [C] bool).
    Layout per channel row: nd x [NB bytes | E*4 errs | 1 under] | 4 fill.
    """
    parts = []
    for i in range(nd):
        by, errs, under = flat[3 * i:3 * i + 3]
        parts += [
            by,
            jax.lax.bitcast_convert_type(errs, jnp.uint8
                                         ).reshape(errs.shape[0], -1),
            under.astype(jnp.uint8)[:, None],
        ]
    parts.append(jax.lax.bitcast_convert_type(
        fill[:, None], jnp.uint8).reshape(fill.shape[0], -1))
    return jnp.concatenate(parts, axis=1)


def _wrap_u16(p):
    """Wrap a u16-unit angle (65536 = 2*pi) into [0, 65536)."""
    return p - jnp.floor(p / 65536.0) * 65536.0


_SEG_T = 128    # boundary overlap window (rows, multiple of CHUNK)
_SEG_D = 2      # largest symbol offset between trajectories at a boundary
_SEG_DEBUG = None   # set to a dict (eager mode only) to stash diagnostics


def seg_positions(S: int, nseg: int, T: int = _SEG_T):
    """End-of-chunk stream positions of the S persisted segment states,
    relative to the NEXT chunk's head (all <= 0).  Segment 0's emit
    window is [0, nseg+T); segment s>=1's is [s*nseg-T, (s+1)*nseg)."""
    n = S * nseg
    return [nseg + T - n] + [(j + 1) * nseg - n for j in range(1, S)]


def init_seg_state(use_pallas, dem_state, nchan, S, nseg, T=_SEG_T):
    """Cold-start per-segment persisted state (host side): replicate the
    carried chunk-head state into S lanes positioned at
    seg_positions(S, nseg) with the lock phase advanced by
    freqw x position — so the first segmented chunk's pass-1 seeding is
    exactly a prediction from the chunk head, and every later chunk's is
    a one-chunk advance of each segment's OWN trajectory."""
    C = nchan
    pos = np.repeat(np.asarray(seg_positions(S, nseg, T), np.float32), C)

    def wrap(v):
        return v - np.floor(v / 65536.0) * 65536.0

    if use_pallas:
        rep = np.tile(np.asarray(dem_state), (1, S))    # [NSTATE, S*C]
        adv = wrap(wrap(rep[2] * 128.0) * (pos / 128.0))
        rep[1] = wrap(rep[1] + adv)
        return jnp.asarray(rep)
    rep = {k: np.tile(np.asarray(v), (S,) + (1,) * (v.ndim - 1))
           for k, v in dem_state.items()}
    adv = wrap(wrap(rep["freqw"] * 128.0) * (pos / 128.0))
    rep["phase"] = wrap(rep["phase"] + adv).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in rep.items()}


def _demod_segmented(params, sym_consts, mf_taps, nchan, S, W, want_cost,
                     use_pallas, interpret, tables, dem_state, seg_state,
                     x):
    """Two-pass time-segmented demod with per-segment persistent state
    (docs/PERF.md "Segmented demod"): each channel's chunk is split into
    S time segments demodulated in PARALLEL kernel lanes, filling the
    lane slots a small fleet leaves idle (the per-step cost at fleet
    shapes is issue/latency-bound, so S segments cost ~the wall time of
    one).

    Exactness model: the per-sample PLL/timing recurrence (sdr.h:800-847)
    is strictly sequential, so segment s>0 cannot start from the TRUE
    state.  A multiple-shooting scheme closes the gap in two passes:

      pass 1 (precursor): S-1 short windows of W samples, window j
        ending EXACTLY where segment j+1's emit window starts.  Lane j
        is seeded from segment j's own persisted end-of-previous-chunk
        state (`seg_state`), with only the lock phase advanced by
        freqw x gap — its one deterministic drift.  The outputs are
        discarded; the only product is each lane's converged END state.
      pass 2 (emit): segment 0 continues the carried chunk-head state
        (exact, as in the sequential receiver); segment s>=1 seeds from
        pass-1 lane s-1's end state, which is positioned EXACTLY at its
        window start.  Seed error = pass-1's residual tracking error
        (the PLL had W samples to re-converge from a < pi/4 folded
        phase-prediction error), so emit trajectories are
        near-sequential from their first row — no warmup rows are
        discarded and the whole owned region is converged output.

    Splice handover: the two trajectories at a boundary still carry
    +-1-sample emission jitter (mu hovers at the emit threshold), so a
    blind row-cut occasionally duplicates or drops one symbol — a
    sync-burst per event downstream.  Each boundary is instead cut
    inside a T-row overlap window (outgoing segment's owned tail vs
    incoming segment's prefix rows, both already computed): the two
    emitted symbol SEQUENCES in the window are aligned (symbol offset d
    between them), and the cut is the last row at which the outgoing
    trajectory's emission count and the incoming one's differ by
    exactly d, so the spliced stream neither drops nor repeats a
    symbol.  Blind boundary cut as fallback.

    A segment's PLL can still re-lock a QPSK quadrant away from the
    stream frame (pass-1 phase prediction error folded mod pi/2).  The
    rotation shows up ONLY as a fixed relabeling of that segment's hard
    decisions, estimated per boundary from decision agreement in the
    overlap window and undone by a label permutation; the carried
    chunk-head state is derotated so the next chunk's segment 0
    continues unrotated.  With persistent per-segment states the
    prediction error is one chunk of freqw drift, so in steady state
    the estimated rotation is 0 and both the relabel and the splice
    degenerate to confirmations.

    Opt-in (MultiDvbsReceiver(segments=S)); acquisition transients are
    absorbed by seg_holdoff + the deconvolver's sync election.
    Returns (dem_state, seg_state, sym [n,C], valid, cost).
    """
    from ..dsp import receiver
    from ..dsp.mf_prefilter import mf_prefilter
    C = nchan
    T = _SEG_T
    J = (S - 1) * C                      # precursor lanes
    ntaps1 = (len(mf_taps) - 1) if mf_taps is not None else 0
    ra = params.readahead + ntaps1
    n = x.shape[1] - ra
    nseg = n // S
    if nseg < W + T:
        raise ValueError(
            f"chunk/segments = {nseg} < warmup+overlap {W + T}")
    L2 = nseg + T                        # emit window rows
    # Stream positions: persisted segment j's state sits at pos[j] (<=0,
    # relative to this chunk's head); precursor window j is
    # [b_j, b_j + W) with b_j = (j+1)*nseg - T - W, ending exactly at
    # emit window j+1's start.  Gaps are multiples of 128, so the
    # two-step wrap below is exact in f32.
    pos = seg_positions(S, nseg, T)
    b = [(j + 1) * nseg - T - W for j in range(S - 1)]
    gap = np.array([b[j] - pos[j] for j in range(S - 1)], np.float32)
    gapv = jnp.repeat(jnp.asarray(gap), C)

    xs1 = jnp.stack([x[:, b[j]:b[j] + W + ra] for j in range(S - 1)]
                    ).reshape(J, W + ra, 2)
    offs2 = [0] + [s * nseg - T for s in range(1, S)]
    xs2 = jnp.stack([x[:, o:o + L2 + ra] for o in offs2]
                    ).reshape(S * C, L2 + ra, 2)   # lane l = s*C + c

    if use_pallas:
        from ..dsp import receiver_pallas as rp
        # -- pass 1: precursor windows from persisted per-segment state
        p1 = seg_state[:, :J]
        adv = _wrap_u16(_wrap_u16(p1[2] * 128.0) * (gapv / 128.0))
        p1 = p1.at[1].set(_wrap_u16(p1[1] + adv))
        x1 = (mf_prefilter(mf_taps, p1[2], xs1)
              if mf_taps is not None else xs1)
        st1, _ = rp.demod_pallas(params, sym_consts, p1, x1,
                                 interpret=interpret)
        # -- pass 2: emit windows; lane 0 = carried chunk-head state,
        # lane s>=1 = pass-1 lane s-1's exactly-positioned end state.
        p2 = jnp.concatenate([dem_state, st1], axis=1)
        x2 = (mf_prefilter(mf_taps, p2[2], xs2)
              if mf_taps is not None else xs2)
        seg_out, packed = rp.demod_pallas(params, sym_consts, p2, x2,
                                          interpret=interpret)
        sym, valid, cost = _extract_sym_valid(packed, S * C, want_cost)
    else:
        def lanes(st, lo, hi):
            return {k: v[lo:hi] for k, v in st.items()}

        p1 = lanes(seg_state, 0, J)
        adv = _wrap_u16(_wrap_u16(p1["freqw"] * 128.0) * (gapv / 128.0))
        p1 = dict(p1, phase=_wrap_u16(p1["phase"] + adv))
        x1 = (mf_prefilter(mf_taps, p1["freqw"], xs1)
              if mf_taps is not None else xs1)
        st1, _ = receiver.run_chunks(params, tables, p1, x1)
        p2 = {k: jnp.concatenate([dem_state[k], st1[k]], axis=0)
              for k in dem_state}
        x2 = (mf_prefilter(mf_taps, p2["freqw"], xs2)
              if mf_taps is not None else xs2)
        st2, out = receiver.run_chunks(params, tables, p2, x2)
        sym = out["symbol"].T                     # [L2, S*C]
        valid = out["valid"].T
        cost = out["cost"].T if want_cost else None
        seg_out = st2

    # Local arrays are [L2, S*C].  Per-segment views: segment 0's local
    # rows [0, nseg) are owned ([nseg, L2) is dead padding for window
    # uniformity); segment s>=1's local rows [0, T) are the boundary
    # prefix, [T, L2) owned.  The overlap at boundary s is the global
    # rows [s*nseg-T, s*nseg): lane s-1's owned TAIL (local
    # [nseg-T, nseg) for lane 0, [nseg, L2) otherwise — lane 0 has no
    # prefix, so its local frame is offset by T) vs lane s's prefix.
    def seg_of(a, s):
        return a[:, s * C:(s + 1) * C]

    def owned_rows(s):
        lo = 0 if s == 0 else T
        return lo, lo + nseg

    def tail_rows(s):
        """Local rows of lane s's owned tail (the outgoing overlap)."""
        return (nseg - T, nseg) if s == 0 else (nseg, L2)

    # -- Rotation correction ------------------------------------------------
    # A segment's PLL locks to the quadrant its pass-1 predicted phase
    # lands in; under noise the freqw estimate error x a chunk-scale
    # gap can exceed pi/4, so an incoming trajectory can be locked a
    # QPSK quadrant away from the outgoing one.  Emission timing, costs
    # and the loop dynamics are all rotation-invariant for the
    # symmetric QPSK grid (muerr is built from p.c dot products), so
    # the rotation shows up ONLY as a fixed relabeling of the hard
    # decisions — estimated per boundary from decision agreement in the
    # overlap window (right rotation agrees ~all emissions, wrong ones
    # ~1/4) and undone by a label permutation, with each persisted
    # segment state's phase derotated to match.  perms[r] maps the
    # incoming trajectory's labels into the outgoing frame for a lock
    # offset of r*90 degrees (layout 0:(+,+) 1:(+,-) 2:(-,+) 3:(-,-);
    # +90 deg of lock phase rotates the derotated samples by -90:
    # (I,Q)->(Q,-I)).
    qpsk = params.nsymbols == 4
    dphase = jnp.asarray([0.0, 16384.0, 32768.0, -16384.0], jnp.float32)

    def rot_label(sb, r):
        """perms[r][sb] as branchless bit algebra (labels are b1b0 =
        i_neg,q_neg).  r may be static or a [C] row."""
        s_ = sb.astype(jnp.int32)
        forms = (s_,
                 2 + (s_ >> 1) - 2 * (s_ & 1),      # [2,0,3,1]  +90
                 3 - s_,                            # [3,2,1,0]  180
                 1 - (s_ >> 1) + 2 * (s_ & 1))      # [1,3,0,2]  -90
        if isinstance(r, int):
            return forms[r].astype(jnp.uint8)
        rh = r[None, :]
        out = forms[0]
        for k in (1, 2, 3):
            out = jnp.where(rh == k, forms[k], out)
        return out.astype(jnp.uint8)

    # Handover cuts: window rows w map to global rows s*nseg - T + w.
    # Both trajectories emit about every other row, but either can slip
    # its emission parity (at omega=2 the +-half-sample offsets are
    # symmetric attractors), so rows do not pair up: a row-level anchor
    # (same symbol at rows at most one apart) is fooled by runs of equal
    # symbols and drops or repeats one.  The window's emissions are
    # therefore compacted into sequences; the incoming sequence matches
    # the outgoing one at a symbol offset d (in-index = out-index + d,
    # |d| <= _SEG_D), estimated with the rotation from agreement counts.
    # With ca[w], cb[w] the emission counts of rows < w, cutting at row
    # w (rows < w outgoing, rows >= w incoming) continues the stream
    # exactly iff cb[w] - ca[w] == d; the last such w is taken, where
    # the incoming trajectory has had the longest to settle.  Without
    # evidence (pre-lock garbage) the cut is blind at the boundary.
    D = _SEG_D
    col = jnp.arange(C)[None, :]
    slot_i = jnp.arange(T)[:, None]

    def compact(v, sy, fill):
        """Window rows -> (emitted symbols in order [T, C], unused
        slots = fill; emission counts of rows < w [T+1, C])."""
        cum = jnp.cumsum(v.astype(jnp.int32), axis=0)
        before = jnp.concatenate([jnp.zeros((1, C), jnp.int32), cum])
        slot = jnp.where(v, before[:-1], T)
        seq = jnp.full((T + 1, C), fill, jnp.uint8).at[slot, col].set(sy)
        return seq[:T], before

    def agree(a, b, d):
        """[C] count of slots i with a[i] == b[i + d] (unused slots never
        match: a and b use different fills)."""
        if d >= 0:
            return (a[:T - d] == b[d:]).sum(axis=0)
        return (a[-d:] == b[:T + d]).sum(axis=0)

    sym_corr = [seg_of(sym, 0)]          # corrected [L2, C] slices
    masks = []
    seg_rot = [jnp.zeros((C,), jnp.float32)]   # per-segment frame offset
    for s in range(1, S):
        ta, tb = tail_rows(s - 1)
        qa, ca = compact(seg_of(valid, s - 1)[ta:tb],
                         sym_corr[s - 1][ta:tb], 255)
        vb = seg_of(valid, s)[:T]
        sb_raw = seg_of(sym, s)
        qb, cb = compact(vb, sb_raw[:T], 0)
        used_b = slot_i < cb[T][None, :]
        rots = range(4) if qpsk else range(1)
        cnt = jnp.stack([
            agree(qa, jnp.where(used_b, rot_label(qb, r), 254), d)
            for r in rots for d in range(-D, D + 1)])     # [R*(2D+1), C]
        best = jnp.argmax(cnt, axis=0)
        # Require real evidence; keep labels raw pre-lock.
        ok = cnt.max(axis=0) >= T // 8
        rhat = jnp.where(ok, best // (2 * D + 1), 0)
        dhat = best % (2 * D + 1) - D
        if _SEG_DEBUG is not None:
            _SEG_DEBUG.setdefault("cnt", []).append(cnt)
            _SEG_DEBUG.setdefault("rhat", []).append(rhat)
        if qpsk:
            # rhat maps segment s's raw labels into the BASE frame (the
            # outgoing side is already corrected), so it is also the
            # segment's own lock-phase offset vs the stream.
            sym_corr.append(rot_label(sb_raw, rhat))
            seg_rot.append(dphase[rhat])
        else:
            sym_corr.append(sb_raw)
            seg_rot.append(seg_rot[0])
        w = jnp.arange(T + 1)[:, None]
        last = jnp.max(jnp.where(cb - ca == dhat[None, :], w, -1), axis=0)
        cut = jnp.where(ok & (last >= 0), last, T)
        masks.append(slot_i >= cut[None, :])

    # Derotate every persisted segment state's lock phase into the
    # stream frame (phase is the only frame-bearing state component the
    # next chunk's seeding consumes; for pass-1 seeds the quadrant is
    # re-estimated anyway, but segment S-1's state doubles as the next
    # chunk's EXACT segment-0 seed, which must be unrotated).
    if qpsk:
        rot_all = jnp.concatenate(seg_rot)             # [S*C]
        if use_pallas:
            seg_out = seg_out.at[1].set(
                _wrap_u16(seg_out[1] - rot_all))
        else:
            seg_out = dict(
                seg_out, phase=_wrap_u16(seg_out["phase"] - rot_all))

    # Carried chunk-head state for the next chunk = segment S-1's end
    # state (positioned exactly at the next chunk head).
    if use_pallas:
        dem_state = seg_out[:, (S - 1) * C:]
        seg_state = seg_out
    else:
        dem_state = {k: v[(S - 1) * C:] for k, v in seg_out.items()}
        seg_state = seg_out

    def splice(a, segs=None):
        parts = []
        for s in range(S):
            lo, hi = owned_rows(s)
            parts.append((segs[s] if segs else seg_of(a, s))[lo:hi])
        out = jnp.concatenate(parts, axis=0)
        for s in range(1, S):
            ta, tb = tail_rows(s - 1)
            pa = (segs[s - 1] if segs else seg_of(a, s - 1))[ta:tb]
            pb = (segs[s] if segs else seg_of(a, s))[:T]
            patch = jnp.where(masks[s - 1], pb, pa)
            out = jax.lax.dynamic_update_slice_in_dim(
                out, patch, s * nseg - T, axis=0)
        return out

    sym = splice(sym, sym_corr)
    valid = splice(valid)
    cost = splice(cost) if want_cost else None
    return dem_state, seg_state, sym, valid, cost


@partial(jax.jit, static_argnames=(
    "params", "sym_consts", "mf_taps", "nchan", "want_cost", "use_pallas",
    "interpret", "segments", "seg_warmup"))
def _demod_chunk(params, sym_consts, mf_taps, nchan, want_cost, use_pallas,
                 interpret, tables, dem_state, seg_state, x, segments=1,
                 seg_warmup=2048):
    """The demod program of a chunk: [matched filter] -> demod (Pallas
    kernel or XLA scan, sequential or segmented) -> sym/valid/cost
    [n, C]. Returns (dem_state, seg_state, sym, valid, cost)."""
    from ..dsp import receiver
    from ..dsp.mf_prefilter import mf_prefilter
    if segments > 1:
        return _demod_segmented(
            params, sym_consts, mf_taps, nchan, segments, seg_warmup,
            want_cost, use_pallas, interpret, tables, dem_state,
            seg_state, x)
    if mf_taps is not None:
        freqw = dem_state[2] if use_pallas else dem_state["freqw"]
        x = mf_prefilter(mf_taps, freqw, x)
    if use_pallas:
        from ..dsp import receiver_pallas as rp
        dem_state, packed = rp.demod_pallas(
            params, sym_consts, dem_state, x, interpret=interpret)
        sym, valid, cost = _extract_sym_valid(packed, nchan, want_cost)
    else:
        dem_state, out = receiver.run_chunks(params, tables, dem_state, x)
        sym = out["symbol"].T
        valid = out["valid"].T
        cost = out["cost"].T if want_cost else None
    return dem_state, seg_state, sym, valid, cost


@partial(jax.jit, static_argnames=(
    "kind", "plan", "plan_dec", "maps", "schedule", "acs_interpret"))
def _decode_chunk(kind, plan, plan_dec, maps, schedule, acs_interpret,
                  dstate, sym, valid, cost):
    """The decode program of a chunk: ring append(s) -> `schedule`
    decodes -> the packed fetch buffer. Returns (dstate, packed_out)."""
    from ..fec.deconv_device import deconv_append, deconv_decode
    from ..fec.viterbi_device import (viterbi_decode_kernel,
                                      viterbi_decode_xla)
    n = sym.shape[0]
    step = plan.nsamp
    flat = []
    for i, o in enumerate(range(0, n, step)):
        m = min(step, n - o)
        dstate = deconv_append(plan, dstate, sym[o:o + m], valid[o:o + m],
                               None if cost is None else cost[o:o + m])
        for _ in range(schedule[i]):
            if kind == "viterbi_acs":
                dstate, by, errs, under = viterbi_decode_kernel(
                    plan_dec, dstate, maps, interpret=acs_interpret)
            elif kind == "viterbi_xla":
                dstate, by, errs, under = viterbi_decode_xla(
                    plan_dec, dstate, maps)
            else:
                dstate, by, errs, under = deconv_decode(plan_dec, dstate)
            flat += [by, errs, under]
    packed_out = _pack_fetch(len(flat) // 3, dstate["fill"], *flat)
    return dstate, packed_out


def _fused_chunk(params, sym_consts, mf_taps, nchan, kind, plan, plan_dec,
                 maps, schedule, use_pallas, interpret, acs_interpret,
                 tables, dem_state, seg_state, dstate, x,
                 segments=1, seg_warmup=2048):
    """A whole chunk's device work as two programs, dispatched back to
    back with no host sync: _demod_chunk, then _decode_chunk.

    The decode schedule is host-deterministic (fixed chunk sizes ->
    fixed fill bookkeeping), so it is a static argument, and each
    schedule or TRACK-mode change compiles a new decode program. The
    demod program does not depend on either: kept apart, it compiles
    once per demod shape and configuration (its Triton kernel is most
    of the compile time) instead of once per decode variant.
    """
    want_cost = kind.startswith("viterbi")
    dem_state, seg_state, sym, valid, cost = _demod_chunk(
        params, sym_consts, mf_taps, nchan, want_cost, use_pallas,
        interpret, tables, dem_state, seg_state, x, segments=segments,
        seg_warmup=seg_warmup)
    dstate, packed_out = _decode_chunk(kind, plan, plan_dec, maps,
                                       schedule, acs_interpret, dstate,
                                       sym, valid, cost)
    return dem_state, seg_state, dstate, packed_out


@partial(jax.jit, static_argnames=("nchan", "want_cost"))
def _extract_sym_valid(packed: jnp.ndarray, nchan: int,
                       want_cost: bool = False):
    """Pallas kernel output [nsamp, lanes] i32 -> ([nsamp, C] u8 sym,
    [nsamp, C] bool valid, [nsamp, C] i16 cost or None), fused on device."""
    nsamp = packed.shape[0]
    flat = packed.reshape(nsamp, -1)[:, :nchan]
    sym = ((flat >> 16) & 0xFF).astype(jnp.uint8)
    valid = ((flat >> 24) & 1).astype(bool)
    cost = (-(flat & 0xFFFF)).astype(jnp.int16) if want_cost else None
    return sym, valid, cost


class _ByteChain:
    """Per-channel host byte-domain chain: deconv -> mpeg -> deinterleave
    -> RS -> derandomize (same stages as DvbsReceiver._byte_stages).
    Used by the candidate-scan receiver (pipelines/scan_rx.py), where each
    candidate keeps an independent host FSM chain.

    When `deconv` is None the deconvolution happens centrally in a
    batched path and feed() receives bytes directly."""

    def __init__(self, rate: str, fastlock: bool, batched_deconv=False):
        from .dvbs_rx import _DeconvolSync
        self.deconv = None if batched_deconv else _DeconvolSync(
            rate, fastlock)
        self.mpeg = MpegSync(
            fastlock=fastlock,
            on_next_sync=self.deconv.next_sync if self.deconv else None)
        self.byte_backlog = np.empty(0, np.uint8)
        self.mpegbyte_backlog = np.empty(0, np.uint8)
        self.derand_pos = 0
        self.vbitcount = 0
        self.verrcount = 0

    def feed(self, syms: np.ndarray) -> np.ndarray:
        bytes_out = self.deconv.process(syms) if self.deconv else syms
        if len(bytes_out):
            self.byte_backlog = np.concatenate(
                [self.byte_backlog, bytes_out])
        pkts, consumed = self.mpeg.process(self.byte_backlog)
        self.byte_backlog = self.byte_backlog[consumed:]
        if len(pkts):
            self.mpegbyte_backlog = np.concatenate(
                [self.mpegbyte_backlog, pkts.reshape(-1)])
        rspkts, self.mpegbyte_backlog = interleave.deinterleave(
            self.mpegbyte_backlog)
        if not len(rspkts):
            return np.empty((0, TS_SIZE), np.uint8)
        msgs, failed, bits = rs.decode(rspkts)
        self.vbitcount += rspkts.shape[0] * RS_SIZE * 8
        self.verrcount += int(bits.sum())
        msgs = msgs.copy()
        msgs[failed, 0] ^= prbs.MPEG_SYNC_CORRUPTED
        out, good, self.derand_pos = prbs.derandomize_np(
            msgs, self.derand_pos)
        return out[good]


class _ByteBackend:
    """Host byte-domain stages for one channel fleet, vectorized where the
    data allows and batched across channels at the RS stage."""

    def __init__(self, nchan: int, fastlock: bool, on_next_sync=None):
        self.nchan = nchan
        # Warm the RS LUTs/GF(2) matrices and the correction path so the
        # first streaming chunk doesn't pay their one-time build cost.
        rs.gf2_syndrome_matrix()
        warm = rs.encode(np.zeros((96, 188), np.uint8))
        warm[:, 3] ^= 0x5A
        rs.decode(warm)
        self.mpeg = [
            MpegSync(fastlock=fastlock,
                     on_next_sync=(None if on_next_sync is None
                                   else (lambda c=c: on_next_sync(c))))
            for c in range(nchan)]
        self.byte_backlog = [np.empty(0, np.uint8) for _ in range(nchan)]
        self.mpegbyte_backlog = [np.empty(0, np.uint8)
                                 for _ in range(nchan)]
        self.derand_pos = [0] * nchan
        self.vbitcount = np.zeros(nchan, np.int64)
        self.verrcount = np.zeros(nchan, np.int64)

    def feed(self, bytes_by_chan) -> list:
        """bytes_by_chan: per-channel new byte arrays (possibly empty).
        Returns per-channel TS packet arrays [k, 188]."""
        C = self.nchan
        rspkts = []
        counts = []
        for c in range(C):
            b = bytes_by_chan[c]
            if len(b):
                self.byte_backlog[c] = np.concatenate(
                    [self.byte_backlog[c], b])
            pkts, consumed = self.mpeg[c].process(self.byte_backlog[c])
            self.byte_backlog[c] = self.byte_backlog[c][consumed:]
            if len(pkts):
                self.mpegbyte_backlog[c] = np.concatenate(
                    [self.mpegbyte_backlog[c], pkts.reshape(-1)])
            rp, self.mpegbyte_backlog[c] = interleave.deinterleave(
                self.mpegbyte_backlog[c])
            rspkts.append(rp)
            counts.append(rp.shape[0])
        total = sum(counts)
        outs = [np.empty((0, TS_SIZE), np.uint8)] * C
        if not total:
            return outs
        # One batched RS decode for the whole fleet's packets.
        allp = np.concatenate([r for r in rspkts if len(r)], axis=0)
        msgs, failed, bits = rs.decode(allp)
        msgs = msgs.copy()
        msgs[failed, 0] ^= prbs.MPEG_SYNC_CORRUPTED
        o = 0
        for c in range(C):
            k = counts[c]
            if not k:
                continue
            self.vbitcount[c] += k * RS_SIZE * 8
            self.verrcount[c] += int(bits[o:o + k].sum())
            out, good, self.derand_pos[c] = prbs.derandomize_np(
                msgs[o:o + k], self.derand_pos[c])
            outs[c] = out[good]
            o += k
        return outs

    @property
    def locks(self):
        return [m.synchronized for m in self.mpeg]

    # -- checkpoint/resume (same contract as NativeByteBackend) ----------

    _MPEG_FIELDS = ("polarity", "bitphase", "synchronized",
                    "next_sync_count", "resync_phase", "phase8",
                    "lock_timeleft", "locktime", "locktime_count")

    def save_blob(self) -> bytes:
        import pickle
        return pickle.dumps({
            "mpeg": [{k: getattr(m, k) for k in self._MPEG_FIELDS}
                     for m in self.mpeg],
            "byte_backlog": self.byte_backlog,
            "mpegbyte_backlog": self.mpegbyte_backlog,
            "derand_pos": self.derand_pos,
            "vbitcount": self.vbitcount,
            "verrcount": self.verrcount,
        })

    def restore_blob(self, blob: bytes):
        import pickle
        d = pickle.loads(blob)
        for m, st in zip(self.mpeg, d["mpeg"]):
            for k, v in st.items():
                setattr(m, k, v)
        self.byte_backlog = d["byte_backlog"]
        self.mpegbyte_backlog = d["mpegbyte_backlog"]
        self.derand_pos = d["derand_pos"]
        self.vbitcount = d["vbitcount"]
        self.verrcount = d["verrcount"]


def make_byte_backend(nchan: int, fastlock: bool, on_next_sync=None,
                      native=None):
    """Backend factory: the C++ runtime (leansdr_jax/native) when it
    builds/loads, else the Python fleet backend. `native=False` forces
    Python (also via LEANSDR_NO_NATIVE=1); `native=True` requires C++."""
    if native is None or native:
        try:
            from ..native import NativeByteBackend
            return NativeByteBackend(nchan, fastlock, on_next_sync)
        except Exception as e:
            if native:
                raise
            # "No compiler / opted out" is expected; anything else is a
            # native-layer regression that must not hide behind the slow
            # Python fallback.
            if not (isinstance(e, RuntimeError)
                    and "unavailable" in str(e)):
                import sys
                print(f"leansdr_jax: native byte backend failed "
                      f"({e!r}); using Python fallback", file=sys.stderr)
    return _ByteBackend(nchan, fastlock, on_next_sync)


class MultiDvbsReceiver:
    """N-channel receiver: one batched device demod + device deconv +
    vectorized host byte backend.

    use_pallas / acs_kernel: None follows platform.families(); False
    forces the XLA reference demod scan / Viterbi ACS scan (the plain
    versions the kernels are timed against)."""

    def __init__(self, cfg: RxConfig, nchan: int, use_pallas=None,
                 chunk_samples: int | None = None, native=None,
                 segments: int = 1, seg_warmup: int = 2048,
                 seg_holdoff: int = 8, acs_kernel=None):
        self.cfg = cfg
        self.nchan = nchan
        # Opt-in time-segmented demod (see _demod_segmented): split each
        # chunk into `segments` lane-parallel segments with `seg_warmup`
        # samples of discarded re-convergence warmup per segment.  The
        # first `seg_holdoff` chunks run sequentially: the segmented
        # carried state only adapts over (warmup + chunk/segments)
        # samples per chunk, so engaging segmentation from cold stretches
        # acquisition ~segments-fold; holding off until the loops have
        # locked costs nothing in steady state (both programs stay
        # compiled).
        if segments < 1:
            raise ValueError("segments must be >= 1")
        if seg_warmup % receiver.CHUNK:
            raise ValueError(
                f"seg_warmup must be a multiple of {receiver.CHUNK}")
        if segments > 1 and segments * nchan > 1024:
            raise ValueError(
                f"segments*nchan = {segments * nchan} exceeds the "
                "1024-lane cap of the segmented demod")
        self.segments = segments
        self.seg_warmup = seg_warmup
        self.seg_holdoff = seg_holdoff
        self._chunk_count = 0
        self._seg_state = None     # per-segment persisted demod state
        self._seg_nseg = 0         # segment length it was built for
        cstln = make_dvbs2_constellation(cfg.constellation, cfg.rate)
        self.cstln = cstln
        exact = resolve_exact_lut(cfg.exact_lut)
        sampler = cfg.sampler
        rrc_coeffs = ()
        rrc_steps = 1
        self.mf_taps = None
        if sampler == "rrc":
            if exact:
                from ..dsp import filtergen
                rrc_steps = cfg.rrc_steps or max(1, int(64 * cfg.Fm
                                                        / cfg.Fs))
                Frrc = cfg.Fs * rrc_steps
                transition = (cfg.Fm / 2) * cfg.rolloff
                order = int(cfg.rrc_rej * Frrc / (22 * transition))
                rrc_coeffs = tuple(
                    filtergen.root_raised_cosine(order, cfg.Fm / Frrc,
                                                 cfg.rolloff).tolist())
            else:
                # Fast path: batched matched-filter conv, then the
                # linear-sampler kernel (dsp/mf_prefilter.py).
                from ..dsp import mf_prefilter
                self.mf_taps = mf_prefilter.make_mf_taps(
                    cfg.Fs, cfg.Fm, cfg.rolloff, cfg.rrc_rej)
                sampler = "linear"
        self.params = receiver.ReceiverParams(
            omega=cfg.Fs / cfg.Fm,
            sampler=sampler,
            nsymbols=cstln.nsymbols,
            freq0=cfg.Ftune / cfg.Fs,
            exact_lut=exact,
            rrc_coeffs=rrc_coeffs,
            rrc_steps=rrc_steps,
            pll_adjustment=(1.0 / 6 if cfg.viterbi else 1.0),
        )
        self.tables = receiver.make_tables(cstln)
        self.state = receiver.init_state(self.params, nchan)
        fam = families()
        if use_pallas is None:
            use_pallas = fam.kernels and not self.params.exact_lut
        self.use_pallas = use_pallas and self.params.sampler == "linear"
        if self.use_pallas:
            from ..dsp import receiver_pallas as rp
            self._sym_consts = rp.sym_constants(cstln)
            self._planes = rp.pack_state(self.state)
            self._interpret = fam.interpret
        self.rate = "4/6" if cfg.rate == "2/3" else cfg.rate
        self.omega = cfg.Fs / cfg.Fm

        self.viterbi = bool(cfg.viterbi)
        nominal = chunk_samples or (1 << 16)
        if self.viterbi:
            from ..fec.viterbi_device import MultiViterbiSync
            self.deconv = MultiViterbiSync(
                cstln, self.rate, nchan, nominal, self.omega,
                fastlock=cfg.fastlock, kernel=acs_kernel)
            self.backend = make_byte_backend(nchan, cfg.fastlock,
                                             native=native)
        else:
            self.deconv = DeviceDeconvolver(
                self.rate, nchan, nominal, self.omega,
                fastlock=cfg.fastlock)
            on_next = None if cfg.fastlock else self.deconv.next_sync
            self.backend = make_byte_backend(nchan, cfg.fastlock,
                                             on_next_sync=on_next,
                                             native=native)
        self.sample_backlog = np.empty((nchan, 0, 2), np.float32)
        self._pool = None
        self._fetch_pool = None
        self._backend_pool = None
        self._jobs = None

        # Fleet preprocessing (leandvb.cc:277-399) — batched device FFTs
        # over all channels (dsp/blocks_device.py), host FSMs at block
        # rate only.
        from ..dsp import blocks_device as bd
        self.notch = (bd.BatchedAutoNotch(nchan, cfg.anf)
                      if cfg.anf else None)
        self.cnr_est = (bd.BatchedCnrFft(nchan, cfg.Fm / cfg.Fs)
                        if cfg.cnr else None)
        if self.cnr_est:
            self.cnr_est.decimation = max(int(cfg.Fs), 1)
        self.spectrum = (bd.BatchedSpectrum(nchan)
                         if cfg.want_spectrum else None)
        if self.spectrum:
            self.spectrum.decimation = max(int(cfg.Fs), 1)
        self.cnr = []                  # [C] vectors, ~1 Hz
        self.spectrum_lines = []       # [C, 1024] dB lines

    # -- streaming API ----------------------------------------------------

    def process(self, iq):
        """[C, n, 2] float32 IQ -> list of [k_c, 188] TS packet arrays.

        `iq` may be a device array whose length is readahead + a multiple
        of CHUNK (with float_scale already applied): it is then consumed
        directly with no host round-trip — the fast path for
        device-resident streams. Use dispatch()/collect() for a
        software-pipelined variant that overlaps fetch with compute.
        """
        pend = self.dispatch(iq)
        if pend is None:
            return [np.empty((0, TS_SIZE), np.uint8)] * self.nchan
        return self.collect(pend)

    def dispatch(self, iq):
        """Enqueue device work for one chunk; returns a pending handle
        (device arrays) or None if not enough samples buffered."""
        ra = self.params.readahead
        if self.mf_taps is not None:
            ra += len(self.mf_taps) - 1
        preproc = (self.notch is not None or self.cnr_est is not None
                   or self.spectrum is not None)
        if isinstance(iq, jnp.ndarray) and not isinstance(iq, np.ndarray) \
                and not preproc \
                and self.sample_backlog.shape[1] == 0 \
                and (iq.shape[1] - ra) % (receiver.CHUNK
                                          * self.segments) == 0:
            # Device-resident fast path (only when no host preprocessing
            # stage is configured — it must not silently skip them).
            x = iq
            n = iq.shape[1] - ra
        else:
            iq = np.asarray(iq, np.float32) * np.float32(
                self.cfg.float_scale)
            # Chain order mirrors the single-channel pipeline
            # (leandvb.cc:277-399): notch BEFORE the CNR/spectrum
            # estimators, so a notched birdie does not inflate CNR.
            if self.notch is not None:
                iq = self.notch.process(iq)
            if self.cnr_est or self.spectrum:
                freqw = (self._planes[2] if self.use_pallas
                         else self.state["freqw"])
                taps = np.asarray(freqw) / 65536.0
                if self.cnr_est:
                    self.cnr.extend(self.cnr_est.process(iq, taps))
                if self.spectrum:
                    self.spectrum_lines.extend(self.spectrum.process(iq))
            self.sample_backlog = np.concatenate(
                [self.sample_backlog, iq], axis=1)
            K = (self.sample_backlog.shape[1] - ra) // receiver.CHUNK
            K -= K % self.segments       # nseg must stay CHUNK-aligned
            if K <= 0:
                return None
            n = K * receiver.CHUNK
            x = jnp.asarray(self.sample_backlog[:, :n + ra])
            self.sample_backlog = self.sample_backlog[:, n:]

        args, kw, schedule = self._fused_args(x, n)
        S = kw["segments"]
        plan_dec = args[6]
        dem_state, seg_state, dstate, packed_out = _fused_chunk(*args, **kw)
        self._chunk_count += 1
        if S > 1:
            self._seg_state = seg_state
        if self.use_pallas:
            self._planes = dem_state
        else:
            self.state = dem_state
        self.deconv.state = dstate
        ecols = plan_dec.E + (1 if self.deconv.kind.startswith("viterbi")
                              else 0)
        shapes = [(plan_dec.nbytes, ecols)] * sum(schedule)
        return packed_out, shapes

    def _fused_args(self, x, n):
        """Arguments of _fused_chunk for a chunk of n samples (mf ->
        demod -> ring appends -> decodes -> packed fetch buffer). The decode schedule comes from the same host fill
        bookkeeping decode() uses, which this advances; appends larger
        than the ring's sizing split along time with decodes drained
        between slices. Returns (args, kwargs, schedule)."""
        self.deconv.apply_pending_transition()
        plan_dec = self.deconv.plan_dec
        step = self.deconv.plan.nsamp
        schedule = []
        for o in range(0, n, step):
            m = min(step, n - o)
            self.deconv.note_production(max(0, int(m / self.omega) - 8))
            schedule.append(self.deconv.schedule_decode())
        dem_state = self._planes if self.use_pallas else self.state
        S = (self.segments
             if self._chunk_count >= self.seg_holdoff else 1)
        if S > 1:
            # Per-segment persisted states assume a constant segment
            # length; (re)build them from the carried chunk-head state
            # when cold or when the chunk size changed.
            nseg = n // S
            if self._seg_state is None or self._seg_nseg != nseg:
                self._seg_state = init_seg_state(
                    self.use_pallas, dem_state, self.nchan, S, nseg)
                self._seg_nseg = nseg
            seg_state = self._seg_state
        else:
            seg_state = jnp.zeros((0,), jnp.float32)
        args = (self.params,
                self._sym_consts if self.use_pallas else None,
                self.mf_taps, self.nchan, self.deconv.kind,
                self.deconv.plan, plan_dec, self.deconv.maps,
                tuple(schedule), self.use_pallas,
                self.use_pallas and self._interpret,
                getattr(self.deconv, "interpret", False),
                None if self.use_pallas else self.tables,
                dem_state, seg_state, self.deconv.state, x)
        return args, dict(segments=S, seg_warmup=self.seg_warmup), schedule

    def prefetch(self, pending):
        """Start the device->host transfer of a dispatch()'s packed
        result on a background thread, so the link transfer overlaps the
        host byte backend of the PREVIOUS chunk. Returns a pending handle
        accepted by collect()."""
        if pending is None:
            return None
        packed_out, shapes = pending
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(1)
        return self._pool.submit(np.asarray, packed_out), shapes

    def collect(self, pending) -> list:
        """Fetch one dispatch()'s results (ONE host round trip) and run
        the host byte backend."""
        packed_out, shapes = pending
        if hasattr(packed_out, "result"):
            buf = packed_out.result()                # prefetched
        else:
            buf = np.asarray(packed_out)             # [C, total]
        per_chan = [[] for _ in range(self.nchan)]
        observe = getattr(self.deconv, "observe", None)
        o = 0
        for nb, ne in shapes:
            by = buf[:, o:o + nb]
            o += nb
            errs = np.ascontiguousarray(buf[:, o:o + ne * 4]).view("<i4")
            o += ne * 4
            under = buf[:, o]
            o += 1
            if observe is not None:
                observe(errs, under.astype(bool))
            for c in range(self.nchan):
                if not under[c]:
                    per_chan[c].append(by[c])
        fill = buf[:, o:o + 4].copy().view(np.int32)[:, 0]
        self.deconv.sync_fill(fill)
        bytes_by_chan = [
            np.concatenate(p) if p else np.empty(0, np.uint8)
            for p in per_chan]
        return self.backend.feed(bytes_by_chan)

    # -- software-pipelined streaming --------------------------------------
    #
    # Three overlapped stages, one chunk deep each (P7: the reference's
    # process pipeline, leanmlmrx.cc:54-78, as host threads around one
    # device stream):
    #   main thread:    dispatch (async device enqueue)
    #   fetch thread:   device->host link transfer of the packed bytes
    #   backend thread: MPEG framing / deinterleave / RS / derandomize
    # Safe because dispatch's can_decode() uses the conservative
    # note_production watermark; collect()'s sync_fill only raises it.

    max_inflight = 3     # pipeline depth: bounds queued device buffers

    def submit(self, iq) -> list:
        """Enqueue one chunk; return the TS outputs of any chunks whose
        backend completed (a list of per-channel packet-array lists).
        Blocks only when more than `max_inflight` chunks are in flight
        (backpressure keeps device/link queues shallow)."""
        if self._jobs is None:
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor
            self._fetch_pool = ThreadPoolExecutor(1)
            self._backend_pool = ThreadPoolExecutor(1)
            self._jobs = deque()
        pend = self.dispatch(iq)
        if pend is not None:
            packed_out, shapes = pend
            fut = self._fetch_pool.submit(np.asarray, packed_out)
            self._jobs.append(
                self._backend_pool.submit(self.collect, (fut, shapes)))
        done = []
        while self._jobs and (self._jobs[0].done()
                              or len(self._jobs) > self.max_inflight):
            done.append(self._jobs.popleft().result())
        return done

    def flush(self) -> list:
        """Wait for all in-flight chunks; return their TS outputs."""
        if not self._jobs:
            return []
        done = [j.result() for j in self._jobs]
        self._jobs.clear()
        return done

    # -- checkpoint/resume --------------------------------------------------

    _DECONV_HOST_FIELDS = ("_est_fill", "track", "_want_track", "_stable",
                           "_last_cur", "_entry_d", "track_after")

    def save_state(self) -> bytes:
        """Serialize every mutable piece of the fleet receiver: demod
        state, the symbol ring + trellis/deconv state, the byte-domain
        backend (incl. the native C++ FSMs) and stream backlogs."""
        import pickle
        dev = (np.asarray(self._planes) if self.use_pallas
               else {k: np.asarray(v) for k, v in self.state.items()})
        dstate = {k: np.asarray(v) for k, v in self.deconv.state.items()}
        dhost = {k: getattr(self.deconv, k)
                 for k in self._DECONV_HOST_FIELDS
                 if hasattr(self.deconv, k)}
        seg = self._seg_state
        if seg is not None:
            seg = (np.asarray(seg) if self.use_pallas
                   else {k: np.asarray(v) for k, v in seg.items()})
        return pickle.dumps({
            "use_pallas": self.use_pallas,
            "dev": dev,
            "seg_state": seg,
            "seg_nseg": self._seg_nseg,
            "deconv_state": dstate,
            "deconv_host": dhost,
            "backend": self.backend.save_blob(),
            "backend_native": type(self.backend).__name__,
            "sample_backlog": self.sample_backlog,
            "chunk_count": self._chunk_count,
        })

    def load_state(self, blob: bytes) -> None:
        import pickle
        d = pickle.loads(blob)
        if d["use_pallas"] != self.use_pallas:
            raise ValueError("checkpoint demod path mismatch")
        if self.use_pallas:
            self._planes = jnp.asarray(d["dev"])
        else:
            self.state = {k: jnp.asarray(v) for k, v in d["dev"].items()}
        self.deconv.state = {k: jnp.asarray(v)
                             for k, v in d["deconv_state"].items()}
        for k, v in d["deconv_host"].items():
            setattr(self.deconv, k, v)
        if d["backend_native"] != type(self.backend).__name__:
            raise ValueError(
                f"checkpoint byte-backend mismatch: saved with "
                f"{d['backend_native']}, restoring into "
                f"{type(self.backend).__name__} (set LEANSDR_NO_NATIVE "
                f"or native= to match)")
        self.backend.restore_blob(d["backend"])
        self.sample_backlog = d["sample_backlog"]
        self._chunk_count = d.get("chunk_count", 0)
        seg = d.get("seg_state")
        if seg is not None:
            seg = (jnp.asarray(seg) if self.use_pallas
                   else {k: jnp.asarray(v) for k, v in seg.items()})
        self._seg_state = seg
        self._seg_nseg = d.get("seg_nseg", 0)

    def metrics(self):
        """Per-channel measurement snapshot (one small host fetch —
        call at info rate, ~1 Hz): dict of [C] arrays freq (fraction of
        Fs), ss, mer_db (sdr.h:852-889 estimator state)."""
        if self.use_pallas:
            p = np.asarray(self._planes)
            freqw, est_insp, est_sp, est_ep = p[2], p[4], p[5], p[6]
        else:
            freqw = np.asarray(self.state["freqw"])
            est_insp = np.asarray(self.state["est_insp"])
            est_sp = np.asarray(self.state["est_sp"])
            est_ep = np.asarray(self.state["est_ep"])
        mer = np.where(est_ep > 0,
                       10 * np.log10(np.maximum(est_sp, 1e-30)
                                     / np.maximum(est_ep, 1e-30)), 0.0)
        return {"freq": freqw / 65536.0, "ss": np.sqrt(est_insp),
                "mer_db": mer}

    @property
    def locks(self):
        return self.backend.locks

    @property
    def vbitcount(self):
        return self.backend.vbitcount

    @property
    def verrcount(self):
        return self.backend.verrcount
