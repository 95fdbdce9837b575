"""Election-cadence stress: force election CHANGES at adversarial
positions and bound the divergence between the device decoders (per
P_SUB-block elections, 1-in-4 TRACK discriminant subsample) and the host
reference implementations (per 128-block elections mirroring
dvb.h:1380-1412) — VERDICT r2 item 4.

The device approximations are cadence-only: they may delay a RE-election
by a bounded number of blocks, never change the decoded bits of a stable
election. These tests fail if that stops being true — if P_SUB cadence
or the TRACK discriminant subsample ever changes decoded output beyond
the documented transient window, or if the TRACK watchdog misses a
collapse that lands between its subsampled discriminant points.
"""

import numpy as np
import jax.numpy as jnp

from leansdr_jax.dsp.cstln import Predef, make_dvbs2_constellation
from leansdr_jax.fec import convenc, deconv
from leansdr_jax.fec import viterbi as vit
from leansdr_jax.fec.viterbi_device import P_SUB, MultiViterbiSync

# Documented transient bound, in BYTES, for a rate-1/2 polarity flip
# within one decode call: the device re-elects at the next P_SUB
# boundary (<= 1024 blocks = 128 bytes late), the host at the next
# 128-block chunk; add traceback depth (32 blocks) and byte packing
# slack. Divergence beyond this window is a real behavioral difference,
# not cadence.
FLIP_WINDOW_BYTES = (2 * P_SUB + 2 * 128 + 64) // 8


def _coded_stream(rng, nsamp, rot, maps, rate="1/2"):
    """Clean coded symbol stream that makes sync replica `rot` win."""
    data = rng.integers(0, 256, nsamp // 8, dtype=np.uint8)
    cs, _ = convenc.encode(data, rate, 2)
    inv = np.argsort(maps[rot])
    return inv[cs].astype(np.uint8)


def _flip(syms, maps, r0, r1, flip_at):
    """Phase slip: the tail of an r0-rotated stream seen through r1."""
    out = syms.copy()
    canonical = maps[r0][syms[flip_at:]]
    out[flip_at:] = np.argsort(maps[r1])[canonical]
    return out


def test_polarity_flip_reelection_bounded_transient():
    """A persistent 90-degree rotation injected mid-stream, deliberately
    NOT at a P_SUB boundary: device and host must both re-elect, and
    their byte streams must be IDENTICAL outside the documented flip
    window (before it by stability, after it by re-election)."""
    rate = "1/2"
    cstln = make_dvbs2_constellation(Predef.QPSK, rate)
    maps = vit.make_sync_maps(cstln, rate)[0]
    rng = np.random.default_rng(23)
    C = 2
    nsamp = 8 * P_SUB + 64
    flip_at = 2 * P_SUB + 517          # mid sub-block, mid byte

    syms = np.zeros((nsamp, C), np.uint8)
    for c, (r0, r1) in enumerate([(0, 1), (2, 3)]):
        s = _coded_stream(rng, nsamp, r0, maps)
        syms[:, c] = _flip(s, maps, r0, r1, flip_at)
    costs = np.full((nsamp, C), -40, np.int16)
    valid = np.ones((nsamp, C), bool)

    mv = MultiViterbiSync(cstln, rate, C, nsamp, 1.0, interpret=True)
    mv.append(jnp.asarray(syms), jnp.asarray(valid), jnp.asarray(costs))
    mv.note_production(nsamp)
    assert mv.can_decode()
    by, discr, under = mv.decode()
    by = np.asarray(by)
    assert not np.asarray(under).any()

    n = mv.plan.nbytes
    for c in range(C):
        host = vit.ViterbiSync(cstln, rate, fastlock=True)
        ref = host.process(syms[:, c], costs[:, c].astype(np.int64))
        m = min(n, len(ref))
        dev = by[c, n - m:n]
        hst = ref[-m:]
        # Flip position in tail-aligned byte coordinates.
        fb = flip_at // 8 - (n - m)
        diff = np.where(dev != hst)[0]
        # The INITIAL election is subject to the same cadence bound:
        # the device first elects at the first P_SUB boundary (byte
        # 128), the host at its first 128-block chunk (byte 16).
        head = P_SUB // 8 + 32
        out_of_window = diff[(diff >= head)
                             & ((diff < fb - 8)
                                | (diff > fb + FLIP_WINDOW_BYTES))]
        assert len(out_of_window) == 0, \
            (c, fb, diff.min(), diff.max(), FLIP_WINDOW_BYTES)
        # Both actually recovered: a real, exactly-equal common tail.
        tail = m - fb - FLIP_WINDOW_BYTES - 8
        assert tail > 100, tail
        assert np.array_equal(dev[-tail:], hst[-tail:]), c
        # And a real pre-flip steady region was equal too (the election
        # cadence must not perturb a stable stream).
        pre = dev[fb - 120:fb - 8]
        assert np.array_equal(pre, hst[fb - 120:fb - 8]), c


def test_track_watchdog_catches_offgrid_collapse():
    """ACQUIRE -> TRACK -> polarity flip at a block index that is NOT a
    multiple of 4 (the TRACK discriminant subsample stride): the
    watchdog must still see the collapse, force re-acquire, and the
    post-re-election stream must equal the host decoder's. Also pins
    that TRACK-mode decoding (cheap_q) emits the same bytes as the
    host on the stable pre-flip region."""
    rate = "1/2"
    cstln = make_dvbs2_constellation(Predef.QPSK, rate)
    maps = vit.make_sync_maps(cstln, rate)[0]
    rng = np.random.default_rng(29)
    C = 2
    nsamp = P_SUB + 64                  # one sub-block per decode
    mv = MultiViterbiSync(cstln, rate, C, nsamp, 1.0, interpret=True)
    step = mv.plan.consumed             # = P_SUB

    ndec = 10
    total = step * ndec + 64
    flip_at = step * 5 + 4 * 129 + 3    # != 0 mod 4, mid sub-block
    syms = np.zeros((total, C), np.uint8)
    rots, new_rots = [0, 3], [1, 2]
    for c in range(C):
        s = _coded_stream(rng, total, rots[c], maps)
        syms[:, c] = _flip(s, maps, rots[c], new_rots[c], flip_at)
    costs = np.full((total, C), -40, np.int16)

    host_bytes = []
    for c in range(C):
        h = vit.ViterbiSync(cstln, rate, fastlock=True)
        host_bytes.append(h.process(syms[:, c],
                                    costs[:, c].astype(np.int64)))

    fed = 0
    outs = []
    was_track_during = []
    went_track = went_back = False
    for it in range(ndec):
        n = step + (64 if it == 0 else 0)
        mv.append(jnp.asarray(syms[fed:fed + n]),
                  jnp.asarray(np.ones((n, C), bool)),
                  jnp.asarray(costs[fed:fed + n]))
        fed += n
        mv.note_production(n)
        assert mv.can_decode()
        by, discr, under = mv.decode()
        outs.append(np.asarray(by)[:, :mv.plan_dec.nbytes])
        was_track_during.append(mv.track)
        mv.observe(np.asarray(discr), np.asarray(under))
        if mv.track or mv._want_track:
            went_track = True
        if went_track and not (mv.track or mv._want_track):
            went_back = True
    assert went_track, "never entered TRACK on a clean stable stream"
    assert went_back, "TRACK watchdog missed the off-grid collapse"
    assert any(was_track_during[:6]), "flip did not land in TRACK mode"

    dev = np.concatenate(outs, axis=1)
    nb = dev.shape[1]
    fb = flip_at // 8
    # Documented re-acquire transient: up to 2 decodes of watchdog
    # latency (the collapse splits a sub-block, halving one decode's
    # mean discriminant) + 1 decode to re-elect + traceback.
    REACQ_WINDOW = (3 * P_SUB + 128 + 64) // 8
    for c in range(C):
        hst = host_bytes[c]
        m = min(nb, len(hst))
        d = dev[c, nb - m:]
        h = hst[len(hst) - m:]
        fbt = fb - (nb - m)
        diff = np.where(d != h)[0]
        head = P_SUB // 8 + 32          # initial-election transient
        oow = diff[(diff >= head)
                   & ((diff < fbt - 8) | (diff > fbt + REACQ_WINDOW))]
        assert len(oow) == 0, (c, fbt, diff[:4], diff[-4:], REACQ_WINDOW)
        tail = m - fbt - REACQ_WINDOW - 8
        assert tail > 100, tail
        assert np.array_equal(d[-tail:], h[-tail:]), c
        # TRACK-mode (cheap_q) bytes on the stable region == host.
        pre = slice(fbt - 250, fbt - 8)
        assert np.array_equal(d[pre], h[pre]), c


def test_track_probe_is_transparent_on_stable_stream():
    """The periodic TRACK->ACQUIRE probe (the resync analogue) must be
    INVISIBLE in the decoded bytes on a stable stream: same output as
    the host decoder through multiple probe round trips."""
    rate = "1/2"
    cstln = make_dvbs2_constellation(Predef.QPSK, rate)
    maps = vit.make_sync_maps(cstln, rate)[0]
    rng = np.random.default_rng(41)
    C = 2
    nsamp = P_SUB + 64
    mv = MultiViterbiSync(cstln, rate, C, nsamp, 1.0, interpret=True)
    mv.probe_period = 3                 # force frequent probes
    step = mv.plan.consumed

    ndec = 12
    total = step * ndec + 64
    syms = np.zeros((total, C), np.uint8)
    for c, rot in enumerate([1, 2]):
        syms[:, c] = _coded_stream(rng, total, rot, maps)
    costs = np.full((total, C), -40, np.int16)

    fed = 0
    outs = []
    n_probes = 0
    was_track = False
    for it in range(ndec):
        n = step + (64 if it == 0 else 0)
        mv.append(jnp.asarray(syms[fed:fed + n]),
                  jnp.asarray(np.ones((n, C), bool)),
                  jnp.asarray(costs[fed:fed + n]))
        fed += n
        mv.note_production(n)
        by, discr, under = mv.decode()
        outs.append(np.asarray(by)[:, :mv.plan_dec.nbytes])
        prev_want = mv._want_track
        mv.observe(np.asarray(discr), np.asarray(under))
        if prev_want and not mv._want_track:
            n_probes += 1
        was_track = was_track or mv.track
    assert was_track
    assert n_probes >= 2, n_probes     # the probe cycle really ran
    dev = np.concatenate(outs, axis=1)
    head = P_SUB // 8 + 32
    for c in range(C):
        h = vit.ViterbiSync(cstln, rate, fastlock=True)
        hst = h.process(syms[:, c], costs[:, c].astype(np.int64))
        m = min(dev.shape[1], len(hst))
        d = dev[c, dev.shape[1] - m:]
        r = hst[len(hst) - m:]
        diff = np.where(d != r)[0]
        assert (diff < head).all() if len(diff) else True, \
            (c, diff[:5], diff[-5:])


def test_deconv_election_flip_bounded_transient():
    """The device deconvolver's per-sub-block argmin election under a
    mid-stream phase slip: byte streams equal the host
    BatchedDeconvolSync outside the documented window (device elects per
    P_sub periods vs the host's per ~4096-symbol block)."""
    from leansdr_jax.fec.deconv import BatchedDeconvolSync
    from leansdr_jax.fec.deconv_device import DeviceDeconvolver

    rate = "1/2"
    maps = deconv.sync_maps()

    def rotate_to(syms, h):
        inv = np.zeros(4, np.uint8)
        for s_rx in range(4):
            inv[maps[h, s_rx]] = s_rx
        return inv[maps[0, syms]]

    rng = np.random.default_rng(31)
    C = 2
    nsamp = (1 << 15) + 4096        # + traceback/alignment margin
    flip_at = (1 << 14) + 1237

    syms = np.zeros((nsamp, C), np.uint8)
    for c, (h0, h1) in enumerate([(0, 1), (0, 3)]):
        data = rng.integers(0, 256, nsamp // 8, dtype=np.uint8)
        cs, _ = convenc.encode(data, rate, 2)
        s = np.concatenate([rotate_to(cs[:flip_at], h0),
                            rotate_to(cs[flip_at:], h1)])
        syms[:, c] = s

    # Deliberately MISALIGN the election cadences: device sub-blocks of
    # 2048 symbols vs the host's 4096-symbol blocks, so the flip lands
    # at different distances from each decoder's next election boundary.
    dd = DeviceDeconvolver(rate, C, 1 << 15, omega=1.0,
                           sub_symbols=2048)
    dd.append(jnp.asarray(syms), jnp.asarray(np.ones((nsamp, C), bool)))
    dd.note_production(nsamp)
    outs = []
    while dd.can_decode():
        by, _, under = dd.decode()
        assert not np.asarray(under).any()
        outs.append(np.asarray(by))
    dev = np.concatenate(outs, axis=1)

    host = BatchedDeconvolSync(rate, C)
    hb = host.process([syms[:, c] for c in range(C)])

    # Both decoders elect RETROACTIVELY for the whole block containing
    # the flip, so the transient extends BACKWARD to the coarser
    # cadence's block start and forward to its block end.
    back = host.consumed_symbols // 8 + 8
    fwd = (dd.plan.bytes_per_subblock
           + host.consumed_symbols // 8 + 64)
    for c in range(C):
        ref = hb[c]
        m = min(dev.shape[1], len(ref))
        d = dev[c, dev.shape[1] - m:]
        h = ref[len(ref) - m:]
        fb = flip_at // 8 - (len(ref) - m)
        diff = np.where(d != h)[0]
        oow = diff[(diff < fb - back) | (diff > fb + fwd)]
        assert len(oow) == 0, (c, fb, diff[:5], diff[-5:], back, fwd)
        tail = m - fb - fwd - 8
        assert tail > 200, tail
        assert np.array_equal(d[-tail:], h[-tail:]), c
        pre = slice(max(0, fb - back - 250), fb - back)
        assert np.array_equal(d[pre], h[pre]), c
