"""Device Viterbi (fec/viterbi_device.py) vs the host reference
implementation (fec/viterbi.py), interpret mode on CPU."""

import numpy as np
import jax.numpy as jnp
import pytest

from leansdr_jax.dsp.cstln import Predef, make_dvbs2_constellation
from leansdr_jax.fec import viterbi as vit
from leansdr_jax.fec.viterbi_acs import acs_geometry, viterbi_acs
from leansdr_jax.fec.viterbi_device import (
    P_SUB, MultiViterbiSync, _block_inputs, _block_inputs_tracked)


def _check_acs_vs_bank(rate, T, N, seed, m0=None):
    """viterbi_acs (interpret) == ViterbiBank.update bit-for-bit:
    decoded symbols and discriminants every block, then metrics and the
    register-exchange paths (stored under acs_geometry.order). Coarse
    costs make metric ties frequent."""
    geo = acs_geometry(rate)
    t = vit.make_trellis(rate)
    rng = np.random.default_rng(seed)
    cs = rng.integers(0, t.ncs, (T, N)).astype(np.int32)
    cost = -(rng.integers(0, 4, (T, N)) * 3).astype(np.int32)
    bank = vit.ViterbiBank(t, N)
    order = np.asarray(geo.order)
    z = jnp.zeros((N, 64), jnp.int32)
    if m0 is not None:
        bank.cost[:] = m0
        m_in = jnp.asarray(m0[:, order].astype(np.int32))
    else:
        m_in = z
    m, h, lo, us, q = viterbi_acs(rate, m_in, z, z, jnp.asarray(cs),
                                  jnp.asarray(cost), interpret=True)
    us, q = np.asarray(us), np.asarray(q)
    idx = np.arange(N)
    for tt in range(T):
        bus, bq = bank.update(idx, cs[tt].astype(np.int64),
                              cost[tt].astype(np.int64))
        assert np.array_equal(us[tt], bus), f"us mismatch at block {tt}"
        assert np.array_equal(q[tt], bq), f"q mismatch at block {tt}"
    assert np.array_equal(np.asarray(m),
                          bank.cost[:, order].astype(np.int32))
    lo64 = np.asarray(lo).astype(np.uint32).astype(np.uint64)
    if geo.two_words:
        p64 = (np.asarray(h).astype(np.uint32).astype(np.uint64) << 32) \
            | lo64
    else:
        p64 = lo64
    nbits, depth = vit.PATH_SPEC[rate]
    pmask = np.uint64((1 << min(63, nbits * depth)) - 1)
    assert np.array_equal(p64 & pmask, bank.path[:, order] & pmask)


@pytest.mark.parametrize("rate", ["1/2", "4/6", "3/4", "5/6", "7/8"])
def test_acs_kernel_matches_host_bank(rate):
    """The one ACS kernel, every rate's trellis geometry (2/3 runs as
    4/6 on QPSK): bank form for bits_in < 4, expanded form above."""
    _check_acs_vs_bank(rate, T=256, N=16, seed=7)


def test_multi_viterbi_matches_host_sync():
    """MultiViterbiSync byte stream == host ViterbiSync(fastlock) on the
    same softsymbol stream, for every channel (steady state; the device
    election cadence is per P_SUB blocks vs 128, so use a clean stream
    where elections agree)."""
    rate = "1/2"
    cstln = make_dvbs2_constellation(Predef.QPSK, rate)
    C = 3
    nsamp = 2 * P_SUB + 64
    rng = np.random.default_rng(3)

    # Clean coded stream: encode random bytes, map to symbols, with a
    # per-channel sync transform so different replicas win.
    from leansdr_jax.fec import convenc
    syms = np.zeros((nsamp, C), np.uint8)
    costs = np.full((nsamp, C), -40, np.int16)
    rots = [0, 1, 3]
    maps = vit.make_sync_maps(cstln, rate)[0]
    for c in range(C):
        data = rng.integers(0, 256, nsamp // 8, dtype=np.uint8)
        cs, _ = convenc.encode(data, rate, 2)   # [nsamp] coded symbols
        inv = np.argsort(maps[rots[c]])
        syms[:, c] = inv[cs]
    valid = np.ones((nsamp, C), bool)

    mv = MultiViterbiSync(cstln, rate, C, nsamp, 1.0, interpret=True)
    mv.append(jnp.asarray(syms), jnp.asarray(valid),
              jnp.asarray(costs))
    mv.note_production(nsamp)
    assert mv.can_decode()
    by, discr, under = mv.decode()
    by = np.asarray(by)
    assert not np.asarray(under).any()

    for c in range(C):
        host = vit.ViterbiSync(cstln, rate, fastlock=True)
        ref = host.process(syms[:, c], costs[:, c].astype(np.int64))
        n = mv.plan.nbytes
        # Same stream modulo the device's coarser election cadence:
        # compare the steady-state tail.
        tail = min(len(ref), n) // 2
        assert tail > 100
        assert np.array_equal(by[c, n - tail:n], ref[-tail:]), \
            f"channel {c}"


@pytest.mark.parametrize("rate", ["3/4", "2/3", "5/6"])
def test_multi_viterbi_all_rates_matches_host(rate):
    """On the CPU the fleet decoder defaults to the all-rate XLA-scan ACS
    (viterbi_decode_xla): byte stream == host ViterbiSync per channel,
    with per-channel sync rotations so different replicas win."""
    cstln = make_dvbs2_constellation(Predef.QPSK, rate)
    from leansdr_jax.fec import convenc
    r = "4/6" if rate == "2/3" else rate
    C = 2
    ns = vit.make_sync_maps(cstln, r)[3]
    nsamp = 2 * P_SUB * ns + 64 * ns   # E=2: tail is post-election
    rng = np.random.default_rng(11)
    syms = np.zeros((nsamp, C), np.uint8)
    costs = np.full((nsamp, C), -40, np.int16)
    maps = vit.make_sync_maps(cstln, r)[0]
    bits_in = vit.make_trellis(r).bits_in
    nbits = nsamp // ns * bits_in // 8 * 8
    for c, rot in enumerate([0, 2]):
        data = rng.integers(0, 256, nbits // 8, dtype=np.uint8)
        cs, _ = convenc.encode(data, r, 2)
        inv = np.argsort(maps[rot])
        syms[:len(cs), c] = inv[cs]
    valid = np.ones((nsamp, C), bool)

    mv = MultiViterbiSync(cstln, r, C, nsamp, 1.0)
    assert mv.xla and mv.kind == "viterbi_xla"
    mv.append(jnp.asarray(syms), jnp.asarray(valid), jnp.asarray(costs))
    mv.note_production(nsamp)
    assert mv.can_decode()
    by, discr, under = mv.decode()
    by = np.asarray(by)
    assert not np.asarray(under).any()

    for c in range(C):
        host = vit.ViterbiSync(cstln, r, fastlock=True)
        ref = host.process(syms[:, c], costs[:, c].astype(np.int64))
        n = mv.plan.nbytes
        tail = min(len(ref), n) // 2
        assert tail > 40, (tail, len(ref), n)
        assert np.array_equal(by[c, n - tail:n], ref[-tail:]), \
            f"channel {c}"


def test_track_mode_policy_transitions():
    """ACQUIRE->TRACK after a stable election; TRACK->ACQUIRE when the
    tracked discriminant collapses (the device analogue of
    resync_period, dvb.h:1241)."""
    import numpy as np
    from leansdr_jax.dsp.cstln import Predef, make_dvbs2_constellation
    from leansdr_jax.fec.viterbi_device import MultiViterbiSync

    cstln = make_dvbs2_constellation(Predef.QPSK, "1/2")
    # TRACK mode belongs to the kernel path (interpret mode here).
    v = MultiViterbiSync(cstln, "1/2", 2, 1 << 14, 2.0, interpret=True)
    C, E = 2, v.plan.E
    good = np.concatenate(
        [np.full((C, E), 900, np.int32), np.zeros((C, 1), np.int32)],
        axis=1)
    under = np.zeros(C, bool)
    assert not v._want_track
    v.observe(good, under)
    v.observe(good, under)
    assert not v._want_track          # needs track_after STABLE repeats
    v.observe(good, under)
    assert v._want_track              # stable election -> track
    bad = good.copy()
    bad[0, :E] = 10                   # collapse channel 0's discriminant
    v.observe(bad, under)
    assert not v._want_track          # watchdog -> acquire


@pytest.mark.parametrize("rate", ["3/4", "7/8", "5/6"])
def test_banked_acs_matches_host_bank(rate):
    """Several programs (24 lanes over 3 lane blocks) entering from
    non-zero trellis metrics == ViterbiBank bit-for-bit."""
    m0 = np.random.default_rng(3).integers(0, 40, (24, 64))
    _check_acs_vs_bank(rate, T=128, N=24, seed=11, m0=m0)


def test_banked_acs_rowsplit_matches_host_bank():
    """Rate 7/8 (all-pred trellis) at a 64-lane fleet width ==
    ViterbiBank bit-for-bit, coarse costs forcing ties."""
    _check_acs_vs_bank("7/8", T=64, N=64, seed=13)


def test_rowsplit_track_decode_matches_bank():
    """TRACK-mode fleet decode through the kernel (7/8 at 40 channels)
    == the host ViterbiBank driven on the tracked block inputs."""
    rate, C = "7/8", 40
    cstln = make_dvbs2_constellation(Predef.QPSK, rate)
    t = vit.make_trellis(rate)
    nsamp = 1 << 14
    rng = np.random.default_rng(17)
    b = MultiViterbiSync(cstln, rate, C, nsamp, 2.0, interpret=True)
    b._want_track = True
    b.apply_pending_transition()
    assert b.track and b.plan_dec.nsyncs == 1
    plan = b.plan_dec
    n = plan.needed
    sym = rng.integers(0, 4, (n, C)).astype(np.uint8)
    cost = -(rng.integers(0, 4, (n, C)) * 3).astype(np.int16)
    b.append(jnp.asarray(sym), jnp.asarray(np.ones((n, C), bool)),
             jnp.asarray(cost))
    by, dsel, under = b.decode()
    assert not np.asarray(under).any()

    cs, co = _block_inputs_tracked(
        plan, b.maps, jnp.asarray(sym.astype(np.int32)),
        jnp.asarray(cost.astype(np.int32)),
        jnp.zeros(C, jnp.int32))
    cs, co = np.asarray(cs), np.asarray(co)
    bank = vit.ViterbiBank(t, C)
    idx = np.arange(C)
    uss = np.stack([bank.update(idx, cs[tt].astype(np.int64),
                                co[tt].astype(np.int64))[0]
                    for tt in range(plan.nblocks)])      # [T, C]
    bits_in = t.bits_in
    shifts = np.arange(bits_in - 1, -1, -1)
    bits = ((uss.T[:, :, None] >> shifts) & 1).reshape(
        C, plan.nblocks * bits_in)
    w = 1 << np.arange(7, -1, -1)
    exp = (bits.reshape(C, -1, 8) * w).sum(axis=2).astype(np.uint8)
    assert np.array_equal(np.asarray(by), exp)


@pytest.mark.parametrize("rate,C", [("3/4", 3), ("7/8", 3)])
def test_banked_fleet_decode_matches_xla(rate, C):
    """viterbi_decode_kernel == viterbi_decode_xla (both exact vs the
    host bank) through the full fleet decode wrapper — bytes,
    discriminants and elections — plus a TRACK-mode transition."""
    cstln = make_dvbs2_constellation(Predef.QPSK, rate)
    nsamp = 1 << 14
    rng = np.random.default_rng(5)
    a = MultiViterbiSync(cstln, rate, C, nsamp, 2.0)
    b = MultiViterbiSync(cstln, rate, C, nsamp, 2.0, interpret=True)
    for it in range(3):
        n = a.plan.consumed + (a.plan.nshifts if it == 0 else 0)
        sym = rng.integers(0, 4, (n, C)).astype(np.uint8)
        val = np.ones((n, C), bool)
        cost = -(rng.integers(0, 4, (n, C)) * 3).astype(np.int16)
        for x in (a, b):
            x.append(jnp.asarray(sym), jnp.asarray(val),
                     jnp.asarray(cost))
        by_a, d_a, u_a = a.decode()
        by_b, d_b, u_b = b.decode()
        assert np.array_equal(np.asarray(u_a), np.asarray(u_b))
        assert np.array_equal(np.asarray(by_a), np.asarray(by_b))
        assert np.array_equal(np.asarray(d_a), np.asarray(d_b))
    b._want_track = True
    b.apply_pending_transition()
    assert b.track and b.plan_dec.nsyncs == 1
    n = b.plan_track.consumed
    sym = rng.integers(0, 4, (n, C)).astype(np.uint8)
    cost = -(rng.integers(0, 4, (n, C)) * 3).astype(np.int16)
    b.append(jnp.asarray(sym), jnp.asarray(np.ones((n, C), bool)),
             jnp.asarray(cost))
    by_t, d_t, u_t = b.decode()
    assert by_t.shape == (C, b.plan_track.nbytes)
    assert not np.asarray(u_t).any()


@pytest.mark.parametrize("rate", ["3/4", "7/8"])
def test_tracked_block_inputs_match_gather(rate):
    """TRACK-mode elected-only block inputs (_block_inputs_tracked) ==
    the all-replica stack gathered at tsync, for every possible
    per-channel election."""
    from leansdr_jax.fec.viterbi_device import ViterbiPlan
    from leansdr_jax.fec.viterbi import make_trellis
    t = make_trellis(rate)
    ns = t.bits_out // 2
    M = 4
    C = M * ns                       # one channel per possible election
    plan = ViterbiPlan(rate, C, P_SUB * ns, ns, 1, 4 * P_SUB * ns)
    full = ViterbiPlan(rate, C, plan.nsamp, ns, 1, plan.cap,
                       nsyncs=M * ns)
    track = ViterbiPlan(rate, C, plan.nsamp, ns, 1, plan.cap, nsyncs=1)
    cstln = make_dvbs2_constellation(Predef.QPSK, rate)
    maps, _, _, _ = vit.make_sync_maps(cstln, rate)
    maps = tuple(tuple(int(v) for v in row) for row in maps)
    rng = np.random.default_rng(11)
    win_sym = jnp.asarray(
        rng.integers(0, 4, (plan.needed, C), dtype=np.int64), jnp.int32)
    win_cost = jnp.asarray(
        -rng.integers(0, 50, (plan.needed, C), dtype=np.int64),
        jnp.int32)
    tsync = jnp.arange(C, dtype=jnp.int32)
    cs_a, cost_a = _block_inputs(full, maps, win_sym, win_cost)
    ref_cs = np.take_along_axis(np.asarray(cs_a),
                                np.arange(C)[None, :, None], axis=2)[..., 0]
    ref_cost = np.take_along_axis(np.asarray(cost_a),
                                  np.arange(C)[None, :, None],
                                  axis=2)[..., 0]
    cs, cost = _block_inputs_tracked(track, maps, win_sym,
                                               win_cost, tsync)
    assert np.array_equal(np.asarray(cs), ref_cs)
    assert np.array_equal(np.asarray(cost), ref_cost)


def test_banked_fleet_e2e_decodes_ts():
    """Real DVB-S 3/4 stimulus through MultiDvbsReceiver with the ACS
    kernel (interpret): payload-verified TS out."""
    from leansdr_jax.pipelines import tsgen, dvbs_tx
    from leansdr_jax.pipelines.dvbs_rx import RxConfig
    from leansdr_jax.pipelines.multi_rx import MultiDvbsReceiver

    C, CH = 2, 1 << 15
    pkts = [tsgen.generate(60, start=777 * c) for c in range(C)]
    iqs = [dvbs_tx.modulate(p, dvbs_tx.TxConfig(rate="3/4", interp=2))
           for p in pkts]
    rx = MultiDvbsReceiver(
        RxConfig(Fs=4e6, Fm=2e6, rate="3/4", fastlock=True,
                 float_scale=75.0, exact_lut=False, viterbi=True),
        C, chunk_samples=CH)
    # Swap in the kernel path (CPU default is XLA; interpret kernel).
    rx.deconv = type(rx.deconv)(rx.cstln, "3/4", C, CH, 2.0,
                                interpret=True)
    assert rx.deconv.kind == "viterbi_acs"
    ra = rx.params.readahead + (len(rx.mf_taps) - 1
                                if rx.mf_taps is not None else 0)
    n = (min(len(q) for q in iqs) - ra) // CH * CH
    x = np.stack([q[:n + ra] for q in iqs]) * np.float32(75.0)
    decoded = verified = 0
    for o in range(0, n, CH):
        for c, ts in enumerate(rx.process(
                jnp.asarray(x[:, o:o + CH + ra]))):
            decoded += len(ts)
            verified += sum(1 for p in ts
                            if (pkts[c] == p).all(axis=1).any())
    assert decoded >= C * 8, decoded
    assert verified >= decoded * 2 // 3, (decoded, verified)
