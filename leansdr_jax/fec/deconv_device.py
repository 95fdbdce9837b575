"""Device-resident algebraic deconvolution: the full symbol->byte front of
the DVB-S byte domain as one fused XLA computation per chunk.

Re-designs deconvol_sync (reference dvb.h:122-476) for a device:

* The per-bit shift-register XORs become ONE 0/1 convolution: output bit
  (period p, poly b) is the GF(2) inner product of a 64-bit
  window of the IQ bit stream with the deconvolution polynomial, so the
  whole decode is `lax.conv_general_dilated` with stride 2 (one output
  column per SYMBOL offset) and `2*punctperiod` output features (primary +
  alternate polynomials), followed by `& 1`. It runs in float32 at
  HIGHEST precision: the sums are at most 64, so it is exact.

* The reference's sequential resync state machine (rotate sync, slip one
  symbol when BER > 1/3, dvb.h:185-193/424-436) becomes hypothesis
  parallelism: all 4 (rotation, conjugation) sync maps AND all
  `punctweight/2` symbol alignments decode simultaneously — the stride-2
  convolution already produces every alignment — and an argmin election
  per ~4096-symbol sub-block picks the stream to emit, mirroring the
  fastlock election cadence (BUF_SYMBOLS, leandvb.cc:190).  A slip is
  just a different elected alignment; no data-dependent control flow.

* Symbol streams stay on device: demodulator output (valid-masked
  symbols) is compacted into a per-channel ring buffer by a cumsum +
  scatter, and only decoded BYTES cross the host link (~16x smaller than
  the raw demod output).

Streams are [time, channel] so channels ride the vector lanes.
"""

from dataclasses import dataclass
from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .deconv import (TRACEBACK, deconv_spec, sync_maps)

__all__ = ["DeconvPlan", "DeviceDeconvolver"]


@dataclass(frozen=True)
class DeconvPlan:
    """Static geometry for one (rate, nchan, chunk) configuration."""
    rate: str
    nchan: int
    nsamp: int              # demod samples appended per call
    P_sub: int              # periods per election sub-block
    E: int                  # sub-blocks decoded per decode() call
    cap: int                # symbol ring capacity
    fastlock: bool
    store_costs: bool

    @property
    def spec(self):
        return deconv_spec(self.rate)

    @property
    def A(self) -> int:     # symbol-alignment hypotheses per sync
        return self.spec.punctweight // 2

    @property
    def nhyp(self) -> int:
        return 4 * self.A

    @property
    def P_call(self) -> int:
        return self.E * self.P_sub

    @property
    def consumed(self) -> int:          # symbols consumed per decode()
        return self.P_call * self.spec.punctweight // 2

    @property
    def needed(self) -> int:            # symbols required before decode()
        return (self.consumed - self.spec.punctweight // 2
                + (self.A - 1) + TRACEBACK // 2)

    @property
    def nbytes(self) -> int:            # bytes emitted per decode()
        return self.P_call * self.spec.punctperiod // 8

    @property
    def bytes_per_subblock(self) -> int:
        return self.P_sub * self.spec.punctperiod // 8


def make_plan(rate: str, nchan: int, nsamp: int, omega: float,
              fastlock: bool = True, store_costs: bool = False,
              sub_symbols: int = 4096) -> DeconvPlan:
    """Size the decode call to just under the expected symbol production
    (nsamp/omega per call) so the ring stays near its working level; the
    host drains/pauses on the fill watermark it gets back with each call."""
    spec = deconv_spec(rate)
    pw = spec.punctweight
    # periods per sub-block: ~sub_symbols symbols, multiple of 8 so every
    # sub-block is byte-aligned (P_sub * pp % 8 == 0).
    P_sub = max(8, int(sub_symbols * 2 / pw) // 8 * 8)
    prod = int(nsamp / omega)
    E = max(1, prod // (P_sub * pw // 2))
    plan = DeconvPlan(rate, nchan, nsamp, P_sub, E, 0, fastlock,
                      store_costs)
    # Ring must hold the pre-drain high-water mark (needed + one call's
    # production) plus the sort-compaction write window (nsamp + DELTA_MAX
    # rows at fill_min, see deconv_append).
    cap = plan.needed + prod + nsamp + DELTA_MAX + 8192
    return DeconvPlan(rate, nchan, nsamp, P_sub, E, cap, fastlock,
                      store_costs)


@lru_cache(maxsize=None)
def _deconv_kernel(rate: str) -> np.ndarray:
    """[TRACEBACK, 1, 2*pp] 0/1 convolution kernel.

    Output feature o < pp is primary polynomial deconv[pp-1-o] (so output
    columns are already in the reference's emission order, dvb.h:379-382);
    features pp..2pp-1 are the alternates in the same order.  Kernel tap w
    multiplies window bit w = stream bit (2t + w); the window formulation
    reads bit e-1-j for tap j with e = 2t + TRACEBACK, hence
    kernel[w] = poly bit (TRACEBACK-1-w).
    """
    spec = deconv_spec(rate)
    pp = spec.punctperiod
    k = np.zeros((TRACEBACK, 1, 2 * pp), np.int8)
    for o in range(pp):
        for name, off in (("deconv", 0), ("deconv2", pp)):
            poly = getattr(spec, name)[pp - 1 - o]
            for w in range(TRACEBACK):
                k[w, 0, o + off] = (poly >> (TRACEBACK - 1 - w)) & 1
    return k


def _sym_to_iq_bits(sym: jnp.ndarray) -> jnp.ndarray:
    """[S, C] u8 symbols -> [4, 2S, C] u8 IQ bits for the 4 sync maps.

    Table lookups are arithmetic selects (no gathers on the hot path).
    """
    maps = sync_maps()                         # [4, 4] uint8
    outs = []
    for s in range(4):
        iq2 = jnp.zeros(sym.shape, jnp.uint8)
        for v in range(4):
            iq2 = jnp.where(sym == v, np.uint8(maps[s, v]), iq2)
        i_bit = (iq2 >> 1) & 1
        q_bit = iq2 & 1
        bits = jnp.stack([i_bit, q_bit], axis=1)     # [S, 2, C]
        outs.append(bits.reshape(sym.shape[0] * 2, sym.shape[1]))
    return jnp.stack(outs, axis=0)


# Rank-alignment margin for the sort-based compaction: channels whose
# fill watermark lags the fleet minimum by more than DELTA_MAX symbols
# lose rank/key alignment (their oldest unwritten slots fall outside the
# dummy-prefix window). Per-channel fills only diverge through per-chunk
# symbol-count jitter (~±1) because decode() drains a FIXED count, so
# 256 covers any realistic drift between decodes.
DELTA_MAX = 256


@partial(jax.jit, static_argnames=("plan",))
def deconv_append(plan: DeconvPlan, state, sym, valid, cost=None):
    """Compact new demod output into the ring — scatter-free.

    sym/valid: [nsamp, C]; cost (optional): [nsamp, C] i16.

    Compaction is a MONOTONE-ROUTING
    BUTTERFLY: each valid sample's target ring slot relative to the
    fleet-minimum fill is delta_c + csum - 1, so its downward shift
    s_i = (D + i) - target is NON-DECREASING along the stream (csum
    grows by exactly 1 at each valid; the D = DELTA_MAX ring rows at
    fill_min ride along as a zero-shift prefix so laggards' first
    symbols can land above fill_min). A monotone routing needs only
    log4(D+n) compare-free passes — pass k moves every element down by
    base-4 digit k of its remaining shift (LSB first) — instead of the
    ~log^2 compare-exchange passes of a bitonic sort (~17x fewer
    passes at fleet shapes). Digit-LSB-first on monotone shifts is
    collision-free: an element can only be overwritten after it has
    been copied further down (targets are strictly increasing in
    stream order, so in-flight positions never cross, and two movers
    claiming one slot in a pass contradict shift monotonicity — see
    the inline proof sketch). Invalid samples get shift 0 and
    are overwritten in place by whichever valid claims their slot;
    rows past each channel's new fill hold garbage, which is fine
    because readers never look past fill (underflowing decodes are
    dropped by the host).
    """
    n, C = sym.shape
    D = DELTA_MAX
    fill = state["fill"]                                   # [C] i32
    # Drift guard: a channel with no carrier emits symbols at a slightly
    # different rate (M&M random walk), so per-channel fills are an
    # unbounded random walk around the fleet and can exceed the zero-
    # shift prefix window, which would silently misplace the LEADERS'
    # writes. Laggards beyond the window are dragged forward instead:
    # their stream gets a discontinuity (they are producing garbage
    # anyway — framing drops it and re-locks), and every in-window
    # channel stays exact.
    fill = jnp.maximum(fill, jnp.max(fill) - (D - 1))
    fill_min = jnp.min(fill)
    delta = fill - fill_min                                # [C] >= 0
    csum = jnp.cumsum(valid.astype(jnp.int32), axis=0)     # [n, C]
    nvalid = csum[-1]

    # Downward shift of each source row (D prefix rows, then n new):
    # valid row j routes to slot delta_c + csum_j - 1, i.e. moves down
    # by D + j - (delta_c + csum_j - 1) >= D - delta_c >= 1.
    j = jnp.arange(n, dtype=jnp.int32)[:, None]
    s_new = jnp.where(valid, D + j - (delta[None, :] + csum - 1), 0)
    s = jnp.concatenate([jnp.zeros((D, C), jnp.int32), s_new], axis=0)

    old = lax.dynamic_slice(state["buf"], (fill_min, jnp.int32(0)),
                            (D, C))
    if plan.store_costs:
        # Pack (sym, cost) into ONE i32 payload: the butterfly is
        # bandwidth-bound, so one payload plane instead of two cuts a
        # third of the append cost.
        oldc = lax.dynamic_slice(state["cost"], (fill_min, jnp.int32(0)),
                                 (D, C))
        vals = jnp.concatenate([old, sym.astype(jnp.uint8)], axis=0)
        costs = jnp.concatenate([oldc, cost.astype(jnp.int16)], axis=0)
        a = (vals.astype(jnp.int32) << 16) \
            | (costs.astype(jnp.int32) & 0xFFFF)
    else:
        a = jnp.concatenate([old, sym.astype(jnp.uint8)], axis=0)

    # Radix-4 butterfly: pass k consumes base-4 digit k of every
    # element's remaining shift (LSB first), moving it down by
    # {0,1,2,3} * 4^k. Monotone shifts make this collision-free at any
    # radix: two movers claiming one slot in the same pass would need
    # high_Y < high_X (targets increase with position) and
    # high_Y >= high_X (shifts non-decreasing) at once. Radix 4 halves
    # the pass count (and the HBM traffic) of the radix-2 butterfly.
    M = D + n

    def up(x, m):
        m = min(m, M)       # static; all-zeros once past the end
        return jnp.concatenate(
            [x[m:], jnp.zeros((m,) + x.shape[1:], x.dtype)], axis=0)

    for k in range(0, int(M - 1).bit_length(), 2):
        sh = 1 << k
        s1, s2, s3 = up(s, sh), up(s, 2 * sh), up(s, 3 * sh)
        d1 = ((s1 >> k) & 3) == 1
        d2 = ((s2 >> k) & 3) == 2
        d3 = ((s3 >> k) & 3) == 3
        a = jnp.where(d3, up(a, 3 * sh),
                      jnp.where(d2, up(a, 2 * sh),
                                jnp.where(d1, up(a, sh), a)))
        s = jnp.where(d3, s3 - 3 * sh,
                      jnp.where(d2, s2 - 2 * sh,
                                jnp.where(d1, s1 - sh, s)))

    if plan.store_costs:
        sbuf = (a >> 16).astype(jnp.uint8)
        scost = ((a & 0xFFFF) ^ 0x8000).astype(jnp.int32) - 0x8000
        return dict(
            state,
            buf=lax.dynamic_update_slice(state["buf"], sbuf,
                                         (fill_min, jnp.int32(0))),
            cost=lax.dynamic_update_slice(
                state["cost"], scost.astype(jnp.int16),
                (fill_min, jnp.int32(0))),
            fill=jnp.minimum(fill + nvalid, plan.cap - D - n))
    buf = lax.dynamic_update_slice(state["buf"], a,
                                   (fill_min, jnp.int32(0)))
    return dict(state, buf=buf,
                fill=jnp.minimum(fill + nvalid, plan.cap - D - n))


@partial(jax.jit, static_argnames=("plan",))
def deconv_decode(plan: DeconvPlan, state):
    """Decode plan.consumed symbols from the ring front.

    Returns (new_state, bytes [C, nbytes] u8, errs [C, E] i32 for the
    elected hypothesis, underflow [C] bool).
    """
    spec = plan.spec
    pp, pw, A, E, P_sub = (spec.punctperiod, spec.punctweight, plan.A,
                           plan.E, plan.P_sub)
    C = plan.nchan
    P = plan.P_call
    S_need = plan.needed
    S_call = plan.consumed

    underflow = state["fill"] < S_need

    win = state["buf"][:S_need]                      # [S_need, C]
    bits = _sym_to_iq_bits(win)                      # [4, 2*S_need, C]
    lhs = bits.transpose(0, 2, 1).reshape(4 * C, 2 * S_need, 1
                                          ).astype(jnp.float32)
    rhs = jnp.asarray(_deconv_kernel(plan.rate), jnp.float32)
    dn = lax.conv_dimension_numbers(lhs.shape, rhs.shape,
                                    ("NWC", "WIO", "NWC"))
    out = lax.conv_general_dilated(
        lhs, rhs, window_strides=(2,), padding="VALID",
        dimension_numbers=dn,
        precision=lax.Precision.HIGHEST)             # [4C, T, 2pp]
    out = (out.astype(jnp.int32) & 1).astype(jnp.uint8)[:, :P * A]
    out = out.reshape(4, C, E, P_sub, A, 2 * pp)
    dec = out[..., :pp]
    alt = out[..., pp:]
    disagree = dec ^ alt
    errs = jnp.sum(disagree, axis=(3, 5), dtype=jnp.int32)  # [4, C, E, A]

    errs_h = errs.transpose(1, 2, 0, 3).reshape(C, E, 4 * A)
    if plan.fastlock:
        elected = jnp.argmin(errs_h, axis=2)                # [C, E]
        locked = elected[:, -1].astype(jnp.int32)
    else:
        locked = state["locked"]
        elected = jnp.broadcast_to(locked[:, None], (C, E))
    dec_h = dec.transpose(1, 2, 0, 4, 3, 5).reshape(
        C, E, 4 * A, P_sub * pp)
    sel = jnp.take_along_axis(dec_h, elected[:, :, None, None],
                              axis=2)[:, :, 0]             # [C, E, P_sub*pp]
    errs_sel = jnp.take_along_axis(errs_h, elected[:, :, None],
                                   axis=2)[:, :, 0]        # [C, E]
    stream = sel.reshape(C, P * pp // 8, 8)
    weights = jnp.asarray((1 << np.arange(7, -1, -1)).astype(np.uint8))
    by = jnp.sum(stream * weights, axis=2, dtype=jnp.int32
                 ).astype(jnp.uint8)                       # [C, nbytes]

    buf = jnp.concatenate(
        [state["buf"][S_call:], jnp.zeros((S_call, C), jnp.uint8)], axis=0)
    new = dict(state, buf=buf,
               fill=jnp.maximum(state["fill"] - S_call, 0),
               locked=locked)
    if plan.store_costs:
        new["cost"] = jnp.concatenate(
            [state["cost"][S_call:], jnp.zeros((S_call, C), jnp.int16)],
            axis=0)
    return new, by, errs_sel, underflow


class DeviceDeconvolver:
    """Stateful wrapper: symbol compaction ring + all-hypothesis decode.

    Usage per chunk (all device-side, no host sync needed between calls):
        dd.append(sym, valid)              # [nsamp, C] demod output
        while dd.can_decode():             # host-side fill estimate
            bytes_d, errs_d, under_d = dd.decode()
    `bytes_d` etc. are device arrays; fetch them together with the fill
    watermark in one host sync.
    """

    def __init__(self, rate: str, nchan: int, nsamp: int, omega: float,
                 fastlock: bool = True, store_costs: bool = False,
                 sub_symbols: int = 4096):
        self.plan = make_plan(rate, nchan, nsamp, omega, fastlock,
                              store_costs, sub_symbols)
        C = nchan
        self.state = {
            "buf": jnp.zeros((self.plan.cap, C), jnp.uint8),
            "fill": jnp.zeros(C, jnp.int32),
            "locked": jnp.zeros(C, jnp.int32),
        }
        if store_costs:
            self.state["cost"] = jnp.zeros((self.plan.cap, C), jnp.int16)
        # Host-side conservative fill estimate (min over channels); the
        # true fill comes back with each decode fetch.
        self._est_fill = 0

    def append(self, sym, valid, cost=None):
        self.state = deconv_append(self.plan, self.state, sym, valid,
                                   cost)

    def note_production(self, nsyms_min: int):
        """Host bookkeeping: at least `nsyms_min` symbols were produced
        per channel by the last append (conservative lower bound)."""
        self._est_fill += nsyms_min

    def sync_fill(self, fill: np.ndarray):
        """Replace the host estimate with fetched truth (min lane)."""
        self._est_fill = int(fill.min())

    def can_decode(self) -> bool:
        return self._est_fill >= self.plan.needed

    def decode(self):
        self.state, by, errs, under = deconv_decode(self.plan, self.state)
        self._est_fill -= self.plan.consumed
        return by, errs, under

    # -- fused-dispatch interface (pipelines/multi_rx._fused_chunk) ------
    kind = "deconv"
    maps = None

    @property
    def plan_dec(self):
        return self.plan

    def apply_pending_transition(self):
        pass

    def schedule_decode(self) -> int:
        """Bookkeeping-only equivalent of the `while can_decode(): decode`
        loop: returns how many decodes the fused device program must run
        after the current append."""
        k = 0
        while self.can_decode():
            self._est_fill -= self.plan_dec.consumed
            k += 1
        return k

    def next_sync(self, channel: int):
        """Non-fastlock resync feedback from mpeg_sync (dvb.h:185-193):
        rotate the sync map; after all 4, slip one symbol alignment."""
        locked = np.asarray(self.state["locked"]).copy()
        s, a = divmod(int(locked[channel]), self.plan.A)
        s = (s + 1) % 4
        if s == 0:
            a = (a + 1) % self.plan.A
        locked[channel] = s * self.plan.A + a
        self.state = dict(self.state, locked=jnp.asarray(locked))
