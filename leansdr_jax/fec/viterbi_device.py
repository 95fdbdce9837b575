"""Multi-channel soft-decision Viterbi on device, batched over
channels x sync replicas.

Re-designs viterbi_sync (reference dvb.h:1173-1416) for every DVB-S
rate (puncturing expanded into the trellis, nshifts symbol-offset
replicas, dvb.h:1179-1212):

* The ACS runs either in the Pallas kernel (fec/viterbi_acs.py, the GPU
  path) or as the XLA scan of fec/viterbi._viterbi_chunk_device (the
  CPU reference path). Both are bit-exact against the host ViterbiBank;
  platform.families() picks one.

* The reference's resync_period time-multiplexing of the nsyncs
  replicas (dvb.h:1386-1394) becomes hypothesis parallelism: all sync
  replicas advance every block (SURVEY 2.10 P6), and a strictly-greater
  discriminant election runs per P_SUB-block sub-block instead of per
  128-block chunk — same election rule, coarser cadence (documented
  deviation; elections are stable after lock).

* TRACK mode (kernel path): once the fleet's elections are stable only
  each channel's elected replica advances, with a subsampled
  discriminant feeding a host watchdog (MultiViterbiSync.observe).
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .viterbi import make_trellis, make_sync_maps
from .viterbi_acs import LANE_BLOCK, viterbi_acs
from .deconv_device import deconv_append, DELTA_MAX
from ..platform import families

NSYNCS = 4          # nconj x nrot for QPSK-class constellations
P_SUB = 1024        # blocks per election sub-block


@dataclass(frozen=True)
class ViterbiPlan:
    """Static geometry for one (rate, nchan, chunk) configuration."""
    rate: str
    nchan: int
    nsamp: int
    nshifts: int
    E: int                  # sub-blocks per decode()
    cap: int                # symbol ring capacity
    store_costs: bool = True
    # nsyncs=1 is TRACK mode: only each channel's elected sync replica
    # runs (the device analogue of the reference's resync_period
    # gating, dvb.h:1241 — replicas cost lanes here instead of CPU time).
    nsyncs: int = NSYNCS
    nconj: int = 2
    nrot: int = 2

    @property
    def nblocks(self) -> int:
        return self.E * P_SUB

    @property
    def consumed(self) -> int:
        return self.nblocks * self.nshifts

    @property
    def needed(self) -> int:
        return self.consumed + self.nshifts - 1

    @property
    def nbytes(self) -> int:
        bits_in = make_trellis(self.rate).bits_in
        return self.nblocks * bits_in // 8

    @property
    def n_lanes(self) -> int:
        return -(-(self.nchan * self.nsyncs) // LANE_BLOCK) * LANE_BLOCK


def _block_inputs(plan: ViterbiPlan, maps, win_sym, win_cost):
    """Per-replica trellis-block inputs (dvb.h:1353-1363): block b of
    sync s = shift*M + map reads symbols [b*ns + shift, +ns), maps them,
    concatenates label bits and sums costs. Returns (cs [T, C, nsyncs] i32, cost [T, C, nsyncs] i32)."""
    t = make_trellis(plan.rate)
    bps = t.bits_out // plan.nshifts
    C, ns = plan.nchan, plan.nshifts
    T = plan.nblocks
    M = plan.nconj * plan.nrot
    nsym = len(maps[0])
    maps_arr = np.asarray(maps, np.int32)                    # [M, nsym]
    cs_parts, cost_parts = [], []
    msyms = []
    for m in range(M):
        ms = jnp.zeros(win_sym.shape, jnp.int32)
        for v in range(nsym):
            ms = jnp.where(win_sym == v, np.int32(maps_arr[m, v]), ms)
        msyms.append(ms)
    for sh in range(ns):
        for m in range(M):
            cs_b = jnp.zeros((T, C), jnp.int32)
            cost_b = jnp.zeros((T, C), jnp.int32)
            for i in range(ns):
                o = sh + i
                lim = o + (T - 1) * ns + 1
                sl = jax.lax.slice(msyms[m], (o, 0), (lim, C), (ns, 1))
                cl = jax.lax.slice(win_cost, (o, 0), (lim, C), (ns, 1))
                cs_b = (cs_b << bps) | sl
                cost_b = cost_b + cl
            cs_parts.append(cs_b)
            cost_parts.append(cost_b)
    return (jnp.stack(cs_parts, axis=2), jnp.stack(cost_parts, axis=2))


def _block_inputs_tracked(plan: ViterbiPlan, maps, win_sym,
                                    win_cost, tsync):
    """TRACK-mode block inputs: only each channel's ELECTED sync replica
    (tsync = shift*M + map) is materialized — the all-replica
    [T, C, nsyncs] stacks of _block_inputs cost nsyncs x the
    memory traffic to keep 1/nsyncs of the data. Returns
    (cs [T, C] i32, cost [T, C] i32)."""
    t = make_trellis(plan.rate)
    bps = t.bits_out // plan.nshifts
    C, ns = plan.nchan, plan.nshifts
    T = plan.nblocks
    M = plan.nconj * plan.nrot
    nsym = len(maps[0])
    maps_arr = np.asarray(maps, np.int32)
    mc = (tsync % M)[None, :]                                # [1, C]
    sc = (tsync // M)[None, :]
    # Per-channel map application: select the elected map's remap of
    # each hard symbol (M wheres instead of M full remapped copies
    # sliced ns times each).
    msel = jnp.zeros(win_sym.shape, jnp.int32)
    for m in range(M):
        ms = jnp.zeros(win_sym.shape, jnp.int32)
        for v in range(nsym):
            ms = jnp.where(win_sym == v, np.int32(maps_arr[m, v]), ms)
        msel = jnp.where(mc == m, ms, msel)
    cs = jnp.zeros((T, C), jnp.int32)
    cost = jnp.zeros((T, C), jnp.int32)
    for sh in range(ns):
        cs_b = jnp.zeros((T, C), jnp.int32)
        cost_b = jnp.zeros((T, C), jnp.int32)
        for i in range(ns):
            o = sh + i
            lim = o + (T - 1) * ns + 1
            sl = jax.lax.slice(msel, (o, 0), (lim, C), (ns, 1))
            cl = jax.lax.slice(win_cost, (o, 0), (lim, C), (ns, 1))
            cs_b = (cs_b << bps) | sl
            cost_b = cost_b + cl
        sel = sc == sh
        cs = jnp.where(sel, cs_b, cs)
        cost = jnp.where(sel, cost_b, cost)
    return cs, cost


def _emit(plan: ViterbiPlan, state, us, q, track: bool):
    """Election, byte packing and ring advance shared by both ACS paths.

    us/q [T, C, nsyncs] (nsyncs = 1 in TRACK mode, whose q is the 1-in-4
    subsample). Returns (state with buf/cost/fill/current advanced,
    bytes [C, nbytes] u8, discr [C, E+1] i32 with the elected sync in
    the last column)."""
    bits_in = make_trellis(plan.rate).bits_in
    C, E, T = plan.nchan, plan.E, plan.nblocks
    # Per-sub-block discriminant sums; the strictly-greater switch is
    # applied AFTER each sub-block (dvb.h:1380-1412; the discr_delay
    # skip of the first 64/bits_in blocks is applied at sub-block
    # starts).
    dd = 64 // bits_in
    qsum = q.reshape(E, P_SUB, C, plan.nsyncs)[:, dd:].sum(axis=1)
    if track:
        cur_out = state["current"]
        blocks = us.reshape(T, C).T                          # [C, T]
        # Rescale the 1-in-4 subsample to full-sum units so the watchdog
        # threshold (entered from ACQUIRE) still holds.
        dsel = 4 * qsum[:, :, 0].T                           # [C, E]
        elected_col = state["tsync"]
    else:
        def elect(cur, qk):
            best = jnp.argmax(qk, axis=1).astype(jnp.int32)
            bv = jnp.take_along_axis(qk, best[:, None], axis=1)[:, 0]
            cv = jnp.take_along_axis(qk, cur[:, None], axis=1)[:, 0]
            return jnp.where(bv > cv, best, cur), cur        # emit pre-update

        cur_out, elected = jax.lax.scan(elect, state["current"], qsum)
        use = us.reshape(E, P_SUB, C, plan.nsyncs)
        sel = jnp.take_along_axis(
            use, elected[:, None, :, None], axis=3)[:, :, :, 0]
        blocks = sel.reshape(T, C).T                         # [C, T]
        dsel = jnp.take_along_axis(
            qsum, elected[:, :, None], axis=2)[:, :, 0].T    # [C, E]
        elected_col = cur_out
    # Expand bits_in bits per block (MSB first), pack to bytes.
    shifts = jnp.asarray(np.arange(bits_in - 1, -1, -1, dtype=np.int32))
    bits = ((blocks[:, :, None] >> shifts) & 1).reshape(
        C, T * bits_in).astype(jnp.uint8)
    w = jnp.asarray((1 << np.arange(7, -1, -1)).astype(np.int32))
    by = jnp.sum(bits.reshape(C, T * bits_in // 8, 8) * w, axis=2,
                 dtype=jnp.int32).astype(jnp.uint8)
    # The elected sync indices ride in the last discr column so the host
    # observes elections without an extra fetch.
    dsel = jnp.concatenate([dsel, elected_col[:, None]], axis=1)

    Sc = plan.consumed
    buf = jnp.concatenate(
        [state["buf"][Sc:], jnp.zeros((Sc, C), jnp.uint8)], axis=0)
    cbuf = jnp.concatenate(
        [state["cost"][Sc:], jnp.zeros((Sc, C), jnp.int16)], axis=0)
    new = dict(state, buf=buf, cost=cbuf,
               fill=jnp.maximum(state["fill"] - Sc, 0), current=cur_out)
    return new, by, dsel


@partial(jax.jit, static_argnames=("plan", "maps", "interpret"))
def viterbi_decode_kernel(plan: ViterbiPlan, state, maps, interpret=False):
    """Decode plan.nblocks FEC blocks from the ring front on the Pallas
    ACS (fec/viterbi_acs.py), every rate.

    State planes are [n_lanes, 64] i32 in the kernel's storage order
    (lane = c*nsyncs + s). plan.nsyncs == 1 selects TRACK mode: only
    each channel's elected sync replica advances (map + symbol shift
    chosen per channel from state["tsync"]), with the 1-in-4 subsampled
    discriminant.

    Returns (new_state, bytes [C, nbytes] u8, discr [C, E+1] i32,
    underflow [C] bool).
    """
    C, T = plan.nchan, plan.nblocks
    track = plan.nsyncs == 1
    underflow = state["fill"] < plan.needed
    win_sym = state["buf"][:plan.needed].astype(jnp.int32)   # [need, C]
    win_cost = state["cost"][:plan.needed].astype(jnp.int32)
    if track:
        cs, cost = _block_inputs_tracked(plan, maps, win_sym, win_cost,
                                         state["tsync"])
    else:
        cs, cost = _block_inputs(plan, maps, win_sym, win_cost)
    ncols = C * plan.nsyncs
    pad = ((0, 0), (0, plan.n_lanes - ncols))
    cs = jnp.pad(cs.reshape(T, ncols), pad)
    cost = jnp.pad(cost.reshape(T, ncols), pad)
    m, h, lo, us, q = viterbi_acs(
        plan.rate, state["metric"], state["path_hi"], state["path_lo"],
        cs, cost, interpret=interpret, cheap_q=track)
    us = us[:, :ncols].reshape(T, C, plan.nsyncs)
    q = q[:, :ncols].reshape(T, C, plan.nsyncs)
    new, by, dsel = _emit(plan, state, us, q, track)
    return dict(new, metric=m, path_hi=h, path_lo=lo), by, dsel, underflow


@partial(jax.jit, static_argnames=("plan", "maps"))
def viterbi_decode_xla(plan: ViterbiPlan, state, maps):
    """All-rate fleet decode on the XLA-scan ACS over S = C * nsyncs
    replica lanes (fec/viterbi._viterbi_chunk_device, dense trellis
    gathers): the reference path and the baseline the kernel is timed
    against.

    Returns (new_state, bytes [C, nbytes] u8, discr [C, E+1] i32 with
    the elected sync in the last column, underflow [C] bool).
    """
    from .viterbi import _viterbi_chunk_device
    C, T = plan.nchan, plan.nblocks
    S = C * plan.nsyncs
    underflow = state["fill"] < plan.needed
    win_sym = state["buf"][:plan.needed].astype(jnp.int32)   # [need, C]
    win_cost = state["cost"][:plan.needed].astype(jnp.int32)
    cs_all, cost_all = _block_inputs(plan, maps, win_sym, win_cost)
    cst, phi, plo, us, q = _viterbi_chunk_device(
        plan.rate, state["metric"], state["path_hi"], state["path_lo"],
        cs_all.reshape(T, S).T, cost_all.reshape(T, S).T)
    us = us.T.reshape(T, C, plan.nsyncs)
    q = q.T.reshape(T, C, plan.nsyncs)
    new, by, dsel = _emit(plan, state, us, q, track=False)
    return (dict(new, metric=cst, path_hi=phi, path_lo=plo), by, dsel,
            underflow)


@partial(jax.jit, static_argnames=("C", "nsyncs", "n_trk"))
def _to_track(plane, current, C: int, nsyncs: int, n_trk: int):
    """Keep each channel's elected sync replica lane (lane = c*nsyncs+s)."""
    rows = jnp.arange(C, dtype=jnp.int32) * nsyncs + current
    return jnp.zeros((n_trk, plane.shape[1]), plane.dtype).at[:C].set(
        plane[rows])


@partial(jax.jit, static_argnames=("C", "nsyncs", "n_acq"))
def _to_acquire(plane, C: int, nsyncs: int, n_acq: int):
    """Seed all replicas from the tracked lane (they diverge within one
    traceback depth, like the reference's fresh replicas)."""
    return jnp.zeros((n_acq, plane.shape[1]), plane.dtype).at[
        :C * nsyncs].set(jnp.repeat(plane[:C], nsyncs, axis=0))


_PLANES = ("metric", "path_hi", "path_lo")


class MultiViterbiSync:
    """N-channel viterbi_sync: symbol+cost ring -> ACS over all sync
    replicas -> elected bit stream, packed to bytes on device.

    Same streaming interface as DeviceDeconvolver (append / decode /
    fill bookkeeping), so MultiDvbsReceiver uses either interchangeably.
    `fastlock` is accepted for interface parity: replicas are always-on
    (hypothesis parallelism), so both modes use the same election — the
    non-fastlock resync_period gating exists in the reference purely to
    save CPU (dvb.h:1241).

    The ACS is the Pallas kernel where platform.families() says so (the
    GPU), when `kernel=True` asks for it, or when `interpret=True` asks
    for it in the Pallas interpreter (as kernel=True does on the CPU);
    otherwise the XLA-scan reference (viterbi_decode_xla), which has no
    TRACK mode.
    """

    def __init__(self, cstln, rate: str, nchan: int, nsamp: int,
                 omega: float, fastlock: bool = True,
                 interpret: bool = False, kernel: bool | None = None):
        maps, nconj, nrot, nshifts = make_sync_maps(cstln, rate)
        self.maps = tuple(tuple(int(v) for v in row) for row in maps)
        fam = families()
        use = fam.kernels if kernel is None else kernel
        self.xla = not (use or interpret)
        self.interpret = not self.xla and (interpret or fam.interpret)
        prod = int(nsamp / omega)
        E = max(1, prod // (P_SUB * nshifts))
        cap = E * P_SUB * nshifts + prod + nsamp + DELTA_MAX + 8192
        nsyncs = nconj * nrot * nshifts
        self.plan = ViterbiPlan(rate, nchan, nsamp, nshifts, E, cap,
                                nsyncs=nsyncs, nconj=nconj, nrot=nrot)
        self.plan_track = ViterbiPlan(rate, nchan, nsamp, nshifts, E,
                                      cap, nsyncs=1, nconj=nconj,
                                      nrot=nrot)
        C = nchan
        self.state = {
            "buf": jnp.zeros((cap, C), jnp.uint8),
            "cost": jnp.zeros((cap, C), jnp.int16),
            "fill": jnp.zeros(C, jnp.int32),
            "current": jnp.zeros(C, jnp.int32),
            "tsync": jnp.zeros(C, jnp.int32),
        }
        if self.xla:
            S = C * nsyncs
            self.state.update(
                metric=jnp.zeros((S, 64), jnp.int32),
                path_hi=jnp.zeros((S, 64), jnp.uint32),
                path_lo=jnp.zeros((S, 64), jnp.uint32))
        else:
            N = self.plan.n_lanes
            self.state.update({k: jnp.zeros((N, 64), jnp.int32)
                               for k in _PLANES})
        self._est_fill = 0
        # TRACK-mode policy (host side, fed by observe() from the
        # fetched discriminants — one chunk of lag, no extra round
        # trip): enter after `track_after` consecutive decodes with a
        # fleet-wide stable election; leave when any channel's tracked
        # discriminant falls below HALF its entry level (a persistent
        # polarity flip leaves the single-replica discriminant at
        # ~0.35-0.45 of the locked level — measured in
        # tests/test_election_stress.py — so 0.25 would ride through
        # it decoding garbage). Belt-and-braces: every `probe_period`
        # TRACK decodes, re-acquire for one election round — the device
        # analogue of the reference's periodic resync (dvb.h:1386-1394),
        # which compares all replicas no matter what the tracked
        # discriminant says. Steady-state cost: ~3/(probe_period+3)
        # of decodes run all-replica lanes.
        self.track = False
        self.track_after = 2
        self.probe_period = 32
        self._track_decodes = 0
        self._want_track = False
        self._last_cur = None
        self._stable = 0
        self._entry_d = None

    def append(self, sym, valid, cost):
        assert cost is not None, "viterbi needs demod costs"
        self.state = deconv_append(self.plan, self.state, sym, valid,
                                   cost)

    def note_production(self, nsyms_min: int):
        self._est_fill += nsyms_min

    def sync_fill(self, fill: np.ndarray):
        self._est_fill = int(fill.min())

    def can_decode(self) -> bool:
        return self._est_fill >= self.plan.needed

    def apply_pending_transition(self):
        """Apply a pending ACQUIRE<->TRACK switch to the trellis planes
        (requested by observe() between chunks)."""
        if self.xla or self._want_track == self.track:
            return
        C = self.plan.nchan
        st = self.state
        nsyncs = self.plan.nsyncs
        if self._want_track:
            self.state = dict(st, tsync=st["current"], **{
                k: _to_track(st[k], st["current"], C, nsyncs,
                             self.plan_track.n_lanes) for k in _PLANES})
        else:
            self.state = dict(st, current=st["tsync"], **{
                k: _to_acquire(st[k], C, nsyncs, self.plan.n_lanes)
                for k in _PLANES})
        self.track = self._want_track

    def decode(self):
        self.apply_pending_transition()
        plan = self.plan_dec
        if self.xla:
            self.state, by, discr, under = viterbi_decode_xla(
                plan, self.state, self.maps)
        else:
            self.state, by, discr, under = viterbi_decode_kernel(
                plan, self.state, self.maps, interpret=self.interpret)
        self._est_fill -= plan.consumed
        return by, discr, under

    # -- fused-dispatch interface (pipelines/multi_rx._fused_chunk) ------
    @property
    def kind(self):
        return "viterbi_xla" if self.xla else "viterbi_acs"

    @property
    def plan_dec(self):
        return (self.plan if self.xla
                else self.plan_track if self.track else self.plan)

    def schedule_decode(self) -> int:
        """Bookkeeping-only equivalent of `while can_decode(): decode`."""
        k = 0
        while self.can_decode():
            self._est_fill -= self.plan_dec.consumed
            k += 1
        return k

    def observe(self, discr: np.ndarray, under: np.ndarray):
        """Host feedback from a fetched decode: discr [C, E+1] i32 with
        the elected sync index in the last column. Drives the
        ACQUIRE<->TRACK transition (see __init__)."""
        if under.any() or self.xla:     # XLA path has no TRACK mode
            return
        cur = discr[:, -1]
        d = discr[:, :-1].mean(axis=1)
        if self.track or self._want_track:
            self._track_decodes += 1
            collapse = (d < 0.5 * self._entry_d).any()
            probe = self._track_decodes >= self.probe_period
            if collapse or probe:
                self._want_track = False
                self._stable = 0
                self._last_cur = None
                self._track_decodes = 0
        else:
            if self._last_cur is not None and (cur == self._last_cur).all():
                self._stable += 1
            else:
                self._stable = 0
            self._last_cur = cur.copy()
            if self._stable >= self.track_after and (d > 0).all():
                self._want_track = True
                self._entry_d = d.copy()
