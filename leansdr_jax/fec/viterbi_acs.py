"""One Pallas ACS kernel (Triton route) for every DVB-S code rate.

Re-designs viterbi_dec's add-compare-select (reference viterbi.h:202-260,
puncturing expanded into the trellis as in dvb.h:1179-1212) for a GPU:
one program owns a few lanes (a lane is one channel x sync replica)
and runs the whole time loop over trellis blocks, with the 64 states'
metrics and register-exchange paths held as [lanes, 64] tiles.

Geometry (verified at build time for every rate, acs_geometry):

* bits_in = B <= 3 (rates 1/2, 3/4): the K = 2^B predecessors of a new
  state differ only in their low B bits. States are STORED bit-reversed,
  so predecessors differ in their top B position bits: the tile splits
  into K contiguous parts whose column j holds the K predecessors of the
  new states stored at positions K*j + r, r = 0..K-1, and the new tile
  is the K results interleaved. The permutation is a split and an
  interleave, no gather.
* B >= 4 (4/6 as used for 2/3, 5/6, 7/8): the same parts, read back one
  per loop step from the tile staged in memory and broadcast against
  all 64 new states. For B = 7 every state connects to every state
  (two branches per pair) and a part is one predecessor column.

The coded symbol of a branch is linear over GF(2) in (predecessor,
uncoded symbol): cs = A[pred] ^ Cu[us]. A branch's tie-break rank
ncs-1-cs is then one XOR of a per-position row with a per-output
constant (acs_geometry verifies the linearity for every rate).

Tie-breaking matches viterbi_dec exactly: candidate keys pack
(metric << RB) | rank with rank = ncs-1-cs for plain branches and ncs
for the provided-with-metric branch, so one min realizes "provided
first, then branches cs-ascending, last minimum wins" (the keys are
unique per state). The best-state scan packs (metric << 6) | state
('<' ascending, FIRST minimum wins).
"""

from dataclasses import dataclass
from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .viterbi import NSTATES, PATH_SPEC, make_trellis

LANE_BLOCK = 8           # lane padding unit (a multiple of every block)
BIG = 1 << 30


def default_blocks(rate: str) -> tuple[int, int]:
    """(lanes per program, warps) measured fastest on the H100 at the
    64-channel widths (docs/PERF.md): the bank form's step is latency
    bound and likes small programs; the loop form needs 4 warps."""
    return (4, 1) if acs_geometry(rate).B < 4 else (8, 4)


def _rev(x: int, bits: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2)


@dataclass(frozen=True)
class AcsGeometry:
    rate: str
    B: int                 # bits_in
    K: int                 # tile parts (predecessor groups)
    ncs: int               # 2^bits_out
    RB: int                # rank bits in the packed key
    nbits: int             # path bits per block
    depth: int             # traceback depth in blocks
    order: tuple           # storage position -> state
    a_pos: tuple           # per predecessor position: ncs-1 ^ A[pred]
    c_out: tuple           # B<=5: rank XOR per output part r
    us_out: tuple          # B<=5: uncoded symbol per output part r
    c2: tuple              # B=7: [2][64] rank XOR per branch, new state
    u2: tuple              # B=7: [2][64] uncoded symbol likewise

    @property
    def two_words(self) -> bool:
        return self.nbits * self.depth > 32


@lru_cache(maxsize=None)
def acs_geometry(rate: str) -> AcsGeometry:
    t = make_trellis(rate)
    B, ncs = t.bits_in, t.ncs
    nbits, depth = PATH_SPEC[rate]
    RB = int(np.ceil(np.log2(ncs + 1)))
    cs_of = np.full((NSTATES, t.nus), -1, np.int64)     # [pred, us]
    for sp in range(NSTATES):
        for k in range(t.nus):
            cs_of[t.in_pred[sp, k], t.in_us[sp, k]] = t.in_cs[sp, k]
    A, Cu = cs_of[:, 0], cs_of[0, :]
    assert Cu[0] == 0 and (cs_of == A[:, None] ^ Cu[None, :]).all(), rate
    if B <= 5:
        K, G = 1 << B, NSTATES >> B
        order = tuple(_rev(q, 6) for q in range(NSTATES))
        us_out = []
        for r in range(K):
            us_r = {int(u) for j in range(G)
                    for u in t.in_us[order[K * j + r]]}
            assert len(us_r) == 1, rate
            us_out.append(us_r.pop())
            for j in range(G):
                preds = {order[j + G * k] for k in range(K)}
                assert set(t.in_pred[order[K * j + r]]) == preds, rate
        return AcsGeometry(
            rate, B, K, ncs, RB, nbits, depth, order,
            tuple(int((ncs - 1) ^ A[order[q]]) for q in range(NSTATES)),
            tuple(int(Cu[u]) for u in us_out), tuple(us_out), (), ())
    assert B == 7, rate
    # Two branches per (pred, new state); their uncoded symbols depend
    # on the new state alone.
    u2 = np.zeros((2, NSTATES), np.int64)
    for sp in range(NSTATES):
        us = sorted({int(u) for u in t.in_us[sp]})
        assert len(us) == 2, rate
        u2[:, sp] = us
    return AcsGeometry(
        rate, B, NSTATES, ncs, RB, nbits, depth, tuple(range(NSTATES)),
        tuple(int((ncs - 1) ^ a) for a in A), (), (),
        tuple(tuple(int(Cu[u]) for u in row) for row in u2),
        tuple(tuple(int(u) for u in row) for row in u2))


@lru_cache(maxsize=None)
def _tables(rate: str) -> np.ndarray:
    """Kernel constants as one [rows, 64] i32 input: row 0 the state
    stored at each position, 1 a_pos (bank form, B < 4), 2-3 the
    uncoded symbol of branch b into each new state, then the expanded
    form's rank rows: row 4 + k*nb + b = rank of branch b from
    predecessor part k into each new-state position."""
    geo = acs_geometry(rate)
    K = geo.K
    G = NSTATES // K
    q = np.arange(NSTATES)
    r, j = q % K, q // K
    nb = 2 if geo.B == 7 else 1
    tbl = np.zeros((4 + K * nb, NSTATES), np.int32)
    tbl[0] = geo.order
    tbl[1] = geo.a_pos
    if geo.B == 7:
        tbl[2:4] = geo.u2
        for k in range(K):
            for b in range(2):
                tbl[4 + 2 * k + b] = np.asarray(geo.c2[b]) ^ geo.a_pos[k]
    else:
        tbl[2] = np.asarray(geo.us_out)[r]
        for k in range(K):
            tbl[4 + k] = (np.asarray(geo.a_pos)[j + G * k]
                          ^ np.asarray(geo.c_out)[r])
    return tbl


def _interleave(parts):
    """out[:, K*j + r] = parts[r][:, j] for K (power of 2) parts."""
    if len(parts) == 1:
        return parts[0]
    x = _interleave(parts[0::2])
    y = _interleave(parts[1::2])
    n = x.shape[1]
    return jnp.concatenate([x[:, :, None], y[:, :, None]],
                           axis=2).reshape(x.shape[0], 2 * n)


def _acs_kernel(geo: AcsGeometry, cheap_q: bool, T: int, lanes: int,
                interpret: bool, tbl_ref, cs_ref, cost_ref,
                m_in_ref, h_in_ref, l_in_ref,
                m_out_ref, h_out_ref, l_out_ref, us_ref, q_ref):
    """One program = `lanes` lanes over all T trellis blocks."""
    K, ncs, RB, nbits = geo.K, geo.ncs, geo.RB, geo.nbits
    i32 = jnp.int32
    sh = (geo.depth - 1) * nbits
    bits_mask = (1 << nbits) - 1
    # A block-wide barrier orders the loop form's staging stores and
    # loads (threads read columns other threads wrote). The interpreter
    # runs a program as one sequential computation and needs none.
    barrier = (lambda: None) if interpret else pl_triton.debug_barrier
    orig = tbl_ref[pl.ds(0, 1), :]                      # [1, 64]
    if geo.B < 4:
        a_parts = jnp.split(tbl_ref[pl.ds(1, 1), :], K, axis=1)

    def shift_in(h, lo, us):
        if geo.two_words:
            h = (h << nbits) | ((lo >> (32 - nbits)) & bits_mask)
        return h, (lo << nbits) | us

    def acs_banks(M, H, L, rcs, c_b):
        """B < 4: K predecessor parts -> K interleaved output parts."""
        mp = jnp.split(M, K, axis=1)
        hp = jnp.split(H, K, axis=1)
        lp = jnp.split(L, K, axis=1)
        base = [(mp[k] << RB) | a_parts[k] for k in range(K)]
        prov = [((mp[k] + c_b) << RB) | ncs for k in range(K)]
        om, oh, ol = [], [], []
        for r in range(K):
            c, want = geo.c_out[r], rcs ^ geo.c_out[r]
            rk = rh = rl = None
            for k in range(K):
                key = jnp.minimum(base[k] ^ c,
                                  jnp.where(a_parts[k] == want, prov[k],
                                            BIG))
                if rk is None:
                    rk, rh, rl = key, hp[k], lp[k]
                else:
                    take = key < rk
                    rk = jnp.where(take, key, rk)
                    rh = jnp.where(take, hp[k], rh)
                    rl = jnp.where(take, lp[k], rl)
            h, lo = shift_in(rh, rl, geo.us_out[r])
            om.append(rk >> RB)
            oh.append(h)
            ol.append(lo)
        return _interleave(om), _interleave(oh), _interleave(ol)

    def acs_loop(M, H, L, rcs, c_b):
        """B >= 4: the tile is staged through the output buffers and the
        K predecessor parts are read back one per loop step, each
        broadcast against all 64 new states (one branch per pair, two
        for B = 7). A loop, not an unrolled sweep: unrolled, the 7/8
        trellis takes minutes to compile."""
        G = NSTATES // K
        nb = 2 if geo.B == 7 else 1
        u = [tbl_ref[pl.ds(2 + b, 1), :] for b in range(nb)]
        barrier()                       # the previous block's reads
        m_out_ref[...] = M
        h_out_ref[...] = H
        l_out_ref[...] = L
        barrier()

        def expand(ref, k):     # column K*j + r <- part k column j
            p = ref[:, pl.ds(k * G, G)]
            if G == 1:
                return p
            return jnp.broadcast_to(p[:, :, None], (lanes, G, K)
                                    ).reshape(lanes, NSTATES)

        def parts(i, carry):
            # PARTS parts per step, all loads issued before the first
            # compare so their latency overlaps.
            rk, rh, rl, ru = carry
            ks = [i * PARTS + d for d in range(PARTS)]
            loads = [(expand(m_out_ref, k), expand(h_out_ref, k),
                      expand(l_out_ref, k),
                      [tbl_ref[pl.ds(4 + k * nb + b, 1), :]
                       for b in range(nb)]) for k in ks]
            for me, he, le, ranks in loads:
                base = me << RB
                prov = ((me + c_b) << RB) | ncs
                for b, rank in enumerate(ranks):
                    key = jnp.minimum(base | rank,
                                      jnp.where(rank == rcs, prov, BIG))
                    take = key < rk
                    rk = jnp.where(take, key, rk)
                    rh = jnp.where(take, he, rh)
                    rl = jnp.where(take, le, rl)
                    if nb == 2:
                        ru = jnp.where(take, u[b], ru)
            return rk, rh, rl, ru

        PARTS = min(8, K)
        zero = jnp.zeros((lanes, NSTATES), i32)
        rk, rh, rl, ru = jax.lax.fori_loop(
            0, K // PARTS, parts, (zero + BIG, zero, zero, zero + u[0]))
        h, lo = shift_in(rh, rl, ru)
        return rk >> RB, h, lo

    def block(t, cs_row, cost_row, carry, want_q):
        M, H, L = carry
        cs_b = cs_row.reshape(lanes, 1)
        c_b = cost_row.reshape(lanes, 1)
        rcs = (ncs - 1) - cs_b
        acs = acs_loop if geo.B >= 4 else acs_banks
        M, H, L = acs(M, H, L, rcs, c_b)
        # Best / second-best state, traceback read, normalization.
        key = (M << 6) | orig
        bk = jnp.min(key, axis=1, keepdims=True)        # [lanes, 1]
        bm = bk >> 6
        best = key == bk
        if geo.two_words:
            usp = (H >> (sh - 32)) & bits_mask
        else:
            usp = (L >> sh) & bits_mask
        us = jnp.max(jnp.where(best, usp, 0), axis=1, keepdims=True)
        us_ref[pl.ds(t, 1), :] = us.reshape(1, lanes)
        if want_q:
            second = jnp.min(jnp.where(best, BIG, key), axis=1,
                             keepdims=True) >> 6
            q = second - bm
        else:
            q = jnp.zeros_like(bm)
        q_ref[pl.ds(t, 1), :] = q.reshape(1, lanes)
        return M - bm, H, L

    def body(i, c):
        # Four blocks per step, their inputs loaded up front. In TRACK
        # mode (cheap_q) the re-acquire watchdog needs only a sample of
        # the discriminant, so q runs on block 4i alone.
        ts = [4 * i + d for d in range(4)]
        rows = [(cs_ref[pl.ds(t, 1), :], cost_ref[pl.ds(t, 1), :])
                for t in ts]
        for d, (t, (cs_row, cost_row)) in enumerate(zip(ts, rows)):
            c = block(t, cs_row, cost_row, c, d == 0 or not cheap_q)
        return c

    carry = jax.lax.fori_loop(
        0, T // 4, body, (m_in_ref[...], h_in_ref[...], l_in_ref[...]))
    M, H, L = carry
    if geo.B >= 4:
        barrier()
    m_out_ref[...] = M
    h_out_ref[...] = H
    l_out_ref[...] = L


@partial(jax.jit, static_argnames=("rate", "interpret", "cheap_q",
                                   "lane_block", "num_warps"))
def viterbi_acs(rate: str, metric, path_hi, path_lo, cs, cost,
                interpret=False, cheap_q=False, lane_block=None,
                num_warps=None):
    """Run the ACS over T trellis blocks for N lanes.

    metric/path_hi/path_lo [N, 64] i32 in storage order (acs_geometry
    .order; path_hi is unused and passes through for rate 1/2); cs/cost
    [T, N] i32 (cs = the full bits_out-bit block symbol, cost = the
    summed softsymbol costs, <= 0). N must be a multiple of the lane
    block (default_blocks unless given) and T of 4. Returns (metric,
    path_hi, path_lo, us [T, N] i32, q [T, N] i32 best2-best
    discriminant). With cheap_q, q is computed
    for block indices 4i only (zeros elsewhere).
    """
    geo = acs_geometry(rate)
    lb, nw = default_blocks(rate)
    lane_block = lane_block or lb
    num_warps = num_warps or nw
    T, N = cs.shape
    assert T % 4 == 0 and N % lane_block == 0, (T, N)
    kernel = partial(_acs_kernel, geo, cheap_q, T, lane_block, interpret)
    st = pl.BlockSpec((lane_block, NSTATES), lambda i: (i, 0))
    blk = pl.BlockSpec((T, lane_block), lambda i: (0, i))
    tbl = _tables(rate)
    tb = pl.BlockSpec(tbl.shape, lambda i: (0, 0))
    i32 = jnp.int32
    return pl.pallas_call(
        kernel,
        grid=(N // lane_block,),
        in_specs=[tb, blk, blk, st, st, st],
        out_specs=[st, st, st, blk, blk],
        out_shape=[jax.ShapeDtypeStruct((N, NSTATES), i32)] * 3
        + [jax.ShapeDtypeStruct((T, N), i32)] * 2,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        interpret=interpret,
        name="viterbi_acs",
    )(jnp.asarray(tbl), cs, cost, metric, path_hi, path_lo)
