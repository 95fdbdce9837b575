"""Viterbi decoding with puncturing expanded into the trellis.

Mirrors trellis/viterbi_dec (reference viterbi.h:43-293) and viterbi_sync
(reference dvb.h:1173-1416): per code rate, a 64-state trellis whose coded
symbols span one full puncturing period (NCS = 2^bits_out), register-
exchange paths packed into 64-bit words, partial branch metrics from the
nearest-minus-second-nearest softsymbol costs, and nconj x nrot x nshift
decoder replicas elected by path-metric discriminant.

The ACS is vectorized over the 64 states and over decoder replicas
(NumPy on host; fec/viterbi_acs.py is the device kernel). Tie-breaking follows the reference exactly: branches are
scanned provided-metric first then all coded symbols ascending, with '<='
so the LAST minimal branch wins (viterbi.h:202-237).
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .convenc import POLYS, FEC_SPECS
from ..dsp.math_utils import parity_u64_np

NSTATES = 64

# bitpath depth per rate (dvb.h:1180-1212): (path bits per block, depth)
PATH_SPEC = {
    "1/2": (1, 32), "2/3": (3, 21), "4/6": (4, 16), "3/4": (3, 21),
    "4/5": (4, 16), "5/6": (5, 12), "7/8": (7, 9),
}


@dataclass
class Trellis:
    rate: str
    bits_in: int
    bits_out: int
    nus: int                  # 2^bits_in uncoded symbols
    ncs: int                  # 2^bits_out coded symbols
    pred: np.ndarray          # [64, NCS] predecessor state or -1
    us: np.ndarray            # [64, NCS] uncoded symbol
    # Dense incoming-branch view (each state has exactly NUS branches):
    in_cs: np.ndarray         # [64, NUS] coded symbol of branch k
    in_pred: np.ndarray       # [64, NUS]
    in_us: np.ndarray         # [64, NUS]


@lru_cache(maxsize=None)
def make_trellis(rate: str) -> Trellis:
    """init_convolutional (viterbi.h:61-92)."""
    bits_in, bits_out = FEC_SPECS[rate]
    polys = POLYS[rate]
    nus, ncs = 1 << bits_in, 1 << bits_out
    pred = np.full((NSTATES, ncs), -1, np.int32)
    usx = np.zeros((NSTATES, ncs), np.int32)
    for s in range(NSTATES):
        for us in range(nus):
            shiftreg = s
            us_rev = 0
            b = 1
            while b < nus:
                if us & b:
                    us_rev |= nus // 2 // b
                b *= 2
            shiftreg |= us_rev * NSTATES
            cs = 0
            for g in polys:
                cs = (cs << 1) | int(parity_u64_np(shiftreg & g))
            shiftreg //= nus
            if pred[shiftreg, cs] != -1:
                raise ValueError("Invalid convolutional code")
            pred[shiftreg, cs] = s
            usx[shiftreg, cs] = us
    # Dense incoming view in ascending-cs order (the reference's rescan
    # order, viterbi.h:224-233).
    in_cs = np.zeros((NSTATES, nus), np.int32)
    in_pred = np.zeros((NSTATES, nus), np.int32)
    in_us = np.zeros((NSTATES, nus), np.int32)
    for s in range(NSTATES):
        k = 0
        for cs in range(ncs):
            if pred[s, cs] >= 0:
                in_cs[s, k] = cs
                in_pred[s, k] = pred[s, cs]
                in_us[s, k] = usx[s, cs]
                k += 1
        assert k == nus
    return Trellis(rate, bits_in, bits_out, nus, ncs, pred, usx,
                   in_cs, in_pred, in_us)


class ViterbiBank:
    """A bank of decoder replicas sharing one trellis (the [nsyncs]
    replicas of viterbi_sync), states vectorized in the last axis."""

    def __init__(self, trellis: Trellis, n: int):
        self.t = trellis
        self.n = n
        self.cost = np.zeros((n, NSTATES), np.int64)
        self.path = np.zeros((n, NSTATES), np.uint64)
        nbits, depth = PATH_SPEC[trellis.rate]
        self.nbits, self.depth = nbits, depth

    def update(self, idx: np.ndarray, cs: np.ndarray, cost: np.ndarray):
        """Partial-metric ACS (viterbi.h:202-260) for replicas `idx`.

        cs, cost: per-replica coded symbol and (negative) metric.
        Returns (us_out [k], quality [k]).
        """
        t = self.t
        prev_cost = self.cost[idx]                     # [k, 64]
        prev_path = self.path[idx]

        # Candidate metrics in the reference's scan order: provided branch
        # first, then all branches (without metric) cs-ascending; '<='
        # means the LAST minimum wins.
        m_other = prev_cost[:, t.in_pred]              # [k, 64, NUS]
        has = t.pred[:, :] >= 0                        # [64, NCS]
        prov_pred = t.pred[np.arange(NSTATES)[None, :], cs[:, None]]  # [k,64]
        prov_valid = prov_pred >= 0
        m_prov = np.where(prov_valid,
                          np.take_along_axis(prev_cost, np.maximum(
                              prov_pred, 0), axis=1) + cost[:, None],
                          np.int64(1) << 60)
        cand = np.concatenate([m_prov[:, :, None], m_other], axis=2)
        # last argmin = reverse argmin
        rev = cand[:, :, ::-1]
        j = rev.shape[2] - 1 - np.argmin(rev, axis=2)  # [k,64]
        best_m = np.take_along_axis(cand, j[:, :, None], axis=2)[:, :, 0]

        prov_us = t.us[np.arange(NSTATES)[None, :], cs[:, None]]
        all_pred = np.concatenate(
            [np.maximum(prov_pred, 0)[:, :, None],
             np.broadcast_to(t.in_pred[None], m_other.shape)], axis=2)
        all_us = np.concatenate(
            [prov_us[:, :, None],
             np.broadcast_to(t.in_us[None], m_other.shape)], axis=2)
        bpred = np.take_along_axis(all_pred, j[:, :, None], axis=2)[:, :, 0]
        bus = np.take_along_axis(all_us, j[:, :, None], axis=2)[:, :, 0]

        new_path = (np.take_along_axis(prev_path, bpred, axis=1)
                    << np.uint64(self.nbits)) | bus.astype(np.uint64)

        # Best / second-best states ('<' scan ascending, viterbi.h:239-244)
        best_state = np.argmin(best_m, axis=1)
        best_tpm = np.min(best_m, axis=1)
        tmp = best_m.copy()
        tmp[np.arange(len(idx)), best_state] = np.int64(1) << 60
        best2_tpm = np.min(tmp, axis=1)

        self.cost[idx] = best_m - best_tpm[:, None]
        self.path[idx] = new_path

        out = (new_path[np.arange(len(idx)), best_state]
               >> np.uint64((self.depth - 1) * self.nbits)) \
            & np.uint64((1 << self.nbits) - 1)
        return out.astype(np.int64), (best2_tpm - best_tpm)


def make_sync_maps(cstln, rate: str):
    """init_map for all (conj, rot) combinations (dvb.h:1336-1351).

    Returns (maps [nmaps, nsymbols], nconj, nrotations, nshifts, order)
    where sync s uses map[(s // nrotations) %% nconj * nrotations + rot].
    """
    bits_per_symbol = cstln.bits_per_symbol
    bits_in, bits_out = FEC_SPECS[rate]
    nconj = 1 if cstln.nsymbols == 2 else 2
    if cstln.nsymbols in (2, 4):
        nrotations = cstln.nrotations // 2
    else:
        nrotations = cstln.nrotations
    nshifts = bits_out // bits_per_symbol
    if nshifts * bits_per_symbol != bits_out:
        raise ValueError("Code rate not suitable for this constellation")
    lut_symbol = cstln.lut_symbol.reshape(256, 256)
    maps = np.zeros((nconj * nrotations, cstln.nsymbols), np.int32)
    for conj in range(nconj):
        for rot in range(nrotations):
            angle = 2 * np.pi * rot / cstln.nrotations
            ca, sa = np.float32(np.cos(angle)), np.float32(np.sin(angle))
            for i in range(cstln.nsymbols):
                I = np.float32(cstln.symbols[i, 0])
                Q = np.float32(cstln.symbols[i, 1])
                if conj:
                    Q = -Q
                RI = int(np.trunc(I * ca - Q * sa)) & 0xFF
                RQ = int(np.trunc(I * sa + Q * ca)) & 0xFF
                maps[conj * nrotations + rot, i] = lut_symbol[RI, RQ]
    return maps, nconj, nrotations, nshifts


class ViterbiSync:
    """viterbi_sync (dvb.h:1173-1416): all-rate soft-decision Viterbi with
    periodic sync election. Consumes (symbol, cost) softsymbol streams."""

    CHUNK = 128

    def __init__(self, cstln, rate: str, fastlock: bool = False):
        self.rate = rate
        self.trellis = make_trellis(rate)
        self.bits_in = self.trellis.bits_in
        self.bps = cstln.bits_per_symbol
        maps, nconj, nrot, nshifts = make_sync_maps(cstln, rate)
        self.maps = maps
        self.nrot, self.nconj, self.nshifts = nrot, nconj, nshifts
        self.nsyncs = nconj * nrot * nshifts
        # sync s: rot = s%nrot, conj = (s//nrot)%nconj, shift = s//nrot//nconj
        self.sync_shift = np.array(
            [s // nrot // nconj for s in range(self.nsyncs)])
        self.sync_map = np.array(
            [(s // nrot) % nconj * nrot + (s % nrot)
             for s in range(self.nsyncs)])
        self.bank = ViterbiBank(self.trellis, self.nsyncs)
        self.current = 0
        self.resync_phase = 0
        self.resync_period = 1 if fastlock else 32
        self.sym_backlog = np.empty(0, np.uint8)
        self.cost_backlog = np.empty(0, np.int16)

    def _block_inputs(self, syms, costs, nblocks):
        """Per sync: coded symbols + costs for `nblocks` FEC blocks.

        Block b of sync s reads symbols [shift_s + b*nshifts, +nshifts),
        maps them, concatenates bits (dvb.h:1353-1363).
        """
        t = self.trellis
        cs = np.zeros((self.nsyncs, nblocks), np.int64)
        cost = np.zeros((self.nsyncs, nblocks), np.int64)
        base = np.arange(nblocks)[None, :] * self.nshifts \
            + self.sync_shift[:, None]                       # [S, B]
        for i in range(self.nshifts):
            sym = syms[base + i]                             # [S, B]
            mapped = self.maps[self.sync_map[:, None], sym]
            cs = (cs << self.bps) | mapped
            cost = cost + costs[base + i]
        return cs, cost

    def process(self, syms: np.ndarray, costs: np.ndarray) -> np.ndarray:
        """Feed softsymbols; returns decoded bytes."""
        self.sym_backlog = np.concatenate([self.sym_backlog, syms])
        self.cost_backlog = np.concatenate([self.cost_backlog, costs])
        out = []
        need = self.nshifts * self.CHUNK + (self.nshifts - 1)
        while len(self.sym_backlog) >= need:
            out.append(self._chunk())
        return (np.concatenate(out) if out
                else np.empty(0, np.uint8))

    def _chunk(self) -> np.ndarray:
        B = self.CHUNK
        discr_delay = 64 // self.bits_in
        syms = self.sym_backlog
        costs = self.cost_backlog.astype(np.int64)
        cs, cost = self._block_inputs(syms, costs, B)

        run_all = self.resync_phase == 0
        active = (np.arange(self.nsyncs) if run_all
                  else np.array([self.current]))
        totaldiscr = np.zeros(self.nsyncs, np.int64)
        out_bits = np.empty((B, self.bits_in), np.uint8)
        for b in range(B):
            us, q = self.bank.update(active, cs[active, b], cost[active, b])
            for k, s in enumerate(active):
                if b >= discr_delay:
                    totaldiscr[s] += q[k]
                if s == self.current:
                    r = int(us[k])
                    for j in range(self.bits_in):
                        out_bits[b, j] = (r >> (self.bits_in - 1 - j)) & 1
        self.sym_backlog = self.sym_backlog[B * self.nshifts:]
        self.cost_backlog = self.cost_backlog[B * self.nshifts:]
        if run_all:
            best = int(np.argmax(totaldiscr))
            # reference: strictly greater switches (dvb.h:1404-1406)
            if totaldiscr[best] > totaldiscr[self.current]:
                self.current = best
        self.resync_phase += 1
        if self.resync_phase >= self.resync_period:
            self.resync_phase = 0
        return np.packbits(out_bits.reshape(-1))


# ---------------------------------------------------------------------------
# Device path: the ACS as a jitted lax.scan over FEC blocks, all decoder
# replicas always-on (SURVEY.md section 2.10 P6: hypothesis parallelism as a
# batch axis replaces the reference's time-multiplexed resync_period — the
# election uses the same discriminant, computed every chunk for every sync).
# ---------------------------------------------------------------------------

import jax
import jax.numpy as jnp
from functools import partial


@partial(jax.jit, static_argnames=("rate",))
def _viterbi_chunk_device(rate, cost_st, path_hi, path_lo, cs, bcost):
    """Run B ACS steps for all S replicas.

    cost_st [S,64] i32, path_hi/lo [S,64] u32, cs/bcost [S,B] i32.
    Returns (new state..., us [S,B] i32, quality [S,B] i32).
    """
    t = make_trellis(rate)
    nbits, depth = PATH_SPEC[rate]
    in_pred = jnp.asarray(t.in_pred)          # [64, NUS]
    in_us = jnp.asarray(t.in_us)
    pred_cs = jnp.asarray(t.pred)             # [64, NCS], -1 invalid
    us_cs = jnp.asarray(t.us)
    BIG = jnp.int32(1 << 30)
    states = jnp.arange(NSTATES)

    def step(carry, inp):
        cost_st, path_hi, path_lo = carry
        cs_b, c_b = inp                        # [S]
        prov_pred = pred_cs[states[None, :], cs_b[:, None]]     # [S,64]
        prov_ok = prov_pred >= 0
        pp = jnp.maximum(prov_pred, 0)
        m_prov = jnp.where(
            prov_ok,
            jnp.take_along_axis(cost_st, pp, axis=1) + c_b[:, None],
            BIG)
        m_other = cost_st[:, in_pred]          # [S,64,NUS]
        cand = jnp.concatenate([m_prov[:, :, None], m_other], axis=2)
        # '<=' in the reference means the LAST minimal branch wins.
        rev = cand[:, :, ::-1]
        j = cand.shape[2] - 1 - jnp.argmin(rev, axis=2)
        best_m = jnp.take_along_axis(cand, j[:, :, None], axis=2)[:, :, 0]

        prov_us = us_cs[states[None, :], cs_b[:, None]]
        all_pred = jnp.concatenate(
            [pp[:, :, None],
             jnp.broadcast_to(in_pred[None], m_other.shape)], axis=2)
        all_us = jnp.concatenate(
            [prov_us[:, :, None],
             jnp.broadcast_to(in_us[None], m_other.shape)], axis=2)
        bpred = jnp.take_along_axis(all_pred, j[:, :, None], axis=2)[:, :, 0]
        bus = jnp.take_along_axis(all_us, j[:, :, None], axis=2)[:, :, 0]

        ph = jnp.take_along_axis(path_hi, bpred, axis=1)
        plo = jnp.take_along_axis(path_lo, bpred, axis=1)
        nb = jnp.uint32(nbits)
        new_hi = (ph << nb) | (plo >> jnp.uint32(32 - nbits))
        new_lo = (plo << nb) | bus.astype(jnp.uint32)

        best_state = jnp.argmin(best_m, axis=1)
        best_tpm = jnp.min(best_m, axis=1)
        masked = best_m.at[jnp.arange(best_m.shape[0]), best_state].set(BIG)
        best2 = jnp.min(masked, axis=1)

        cost_st = best_m - best_tpm[:, None]
        # Read oldest symbol of the best path at the register-exchange
        # depth (bitpath.read, viterbi.h:292).
        sel_hi = new_hi[jnp.arange(new_hi.shape[0]), best_state]
        sel_lo = new_lo[jnp.arange(new_lo.shape[0]), best_state]
        shift = (depth - 1) * nbits
        if shift >= 32:
            us_out = (sel_hi >> jnp.uint32(shift - 32)) \
                & jnp.uint32((1 << nbits) - 1)
        else:
            lo_part = sel_lo >> jnp.uint32(shift)
            hi_part = jnp.uint32(0) if shift == 0 else \
                (sel_hi << jnp.uint32(32 - shift))
            us_out = (lo_part | hi_part) & jnp.uint32((1 << nbits) - 1)
        return ((cost_st, new_hi, new_lo),
                (us_out.astype(jnp.int32), best2 - best_tpm))

    (cost_st, path_hi, path_lo), (us, q) = jax.lax.scan(
        step, (cost_st, path_hi, path_lo),
        (cs.T.astype(jnp.int32), bcost.T.astype(jnp.int32)),
        unroll=4 if cs.shape[1] % 4 == 0 else 1)
    return cost_st, path_hi, path_lo, us.T, q.T


class ViterbiSyncDevice(ViterbiSync):
    """ViterbiSync with the ACS on device and all replicas always-on.

    Behavior-compatible with the reference: same trellis, metrics, paths
    and election discriminant; the only difference is that non-current
    replicas advance every chunk instead of only on resync chunks (which
    the always-on batch makes free) — the elected stream is identical in
    steady state.
    """

    def _chunk(self) -> np.ndarray:
        B = self.CHUNK
        discr_delay = 64 // self.bits_in
        costs = self.cost_backlog.astype(np.int64)
        cs, cost = self._block_inputs(self.sym_backlog, costs, B)

        # (self.bank is unused here: _dev_state supersedes the host bank
        # on the device path.)
        if not hasattr(self, "_dev_state"):
            self._dev_state = (
                jnp.zeros((self.nsyncs, NSTATES), jnp.int32),
                jnp.zeros((self.nsyncs, NSTATES), jnp.uint32),
                jnp.zeros((self.nsyncs, NSTATES), jnp.uint32),
            )
        cst, phi, plo = self._dev_state
        cst, phi, plo, us, q = _viterbi_chunk_device(
            self.rate, cst, phi, plo,
            jnp.asarray(cs), jnp.asarray(cost))
        self._dev_state = (cst, phi, plo)
        us = np.asarray(us)
        q = np.asarray(q)

        totaldiscr = q[:, discr_delay:].sum(axis=1)
        out_bits = np.zeros((B, self.bits_in), np.uint8)
        r = us[self.current]
        for j in range(self.bits_in):
            out_bits[:, j] = (r >> (self.bits_in - 1 - j)) & 1
        self.sym_backlog = self.sym_backlog[B * self.nshifts:]
        self.cost_backlog = self.cost_backlog[B * self.nshifts:]
        if self.resync_phase == 0:
            best = int(np.argmax(totaldiscr))
            if totaldiscr[best] > totaldiscr[self.current]:
                self.current = best
        self.resync_phase += 1
        if self.resync_phase >= self.resync_period:
            self.resync_phase = 0
        return np.packbits(out_bits.reshape(-1))
