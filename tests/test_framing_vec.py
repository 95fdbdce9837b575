"""Vectorized framing/derandomizer FSMs vs sequential reference semantics.

The sequential models below transcribe the FSM rules from the reference
(mpeg_sync decode loop dvb.h:842-874, derandomizer dvb.h:1130-1157); the
production code implements them as whole-block vector ops.  Random streams
with adversarial sync-byte corruption exercise lock losses, carried-in
timeouts and resync phases.
"""

import numpy as np
import pytest

from leansdr_jax.proto.framing import (MpegSync, RS_SIZE, MPEG_SYNC,
                                       MPEG_SYNC_INV, bitshift_stream)
from leansdr_jax.fec import prbs


def seq_run_decoding(sync: MpegSync, data: np.ndarray):
    """Literal transcription of the per-packet decode loop."""
    out = []
    consumed = 0
    while len(data) - consumed >= RS_SIZE + 1:
        seg = data[consumed:consumed + RS_SIZE + 1]
        pkt = bitshift_stream(seg, sync.bitphase) ^ sync.polarity
        consumed += RS_SIZE
        out.append(pkt)
        sync.locktime += 1
        sync.locktime_count += 1
        expected = MPEG_SYNC if sync.phase8 else MPEG_SYNC_INV
        if pkt[0] == expected:
            sync.lock_timeleft = sync.lock_timeout
        sync.phase8 = (sync.phase8 + 1) & 7
        sync.lock_timeleft -= 1
        if not sync.lock_timeleft:
            sync.synchronized = False
            sync.next_sync_count = 0
            sync.lock_events.append(0)
            break
    pkts = np.stack(out) if out else np.empty((0, RS_SIZE), np.uint8)
    return pkts, consumed


def _mk_sync(rng, timeleft):
    s = MpegSync()
    s.synchronized = True
    s.bitphase = int(rng.integers(0, 8))
    s.polarity = int(rng.choice([0, 0xFF]))
    s.phase8 = int(rng.integers(0, 8))
    s.lock_timeleft = timeleft
    s.locktime = int(rng.integers(0, 100))
    return s


@pytest.mark.parametrize("seed", range(8))
def test_run_decoding_matches_sequential(seed):
    rng = np.random.default_rng(seed)
    for trial in range(12):
        npkts = int(rng.integers(1, 30))
        data = rng.integers(0, 256, npkts * RS_SIZE + 7, dtype=np.uint8)
        t0 = int(rng.integers(1, 5))
        a = _mk_sync(rng, t0)
        b = _mk_sync(np.random.default_rng(seed * 100 + trial), t0)
        # same initial state for both
        for k in ("bitphase", "polarity", "phase8", "locktime"):
            setattr(b, k, getattr(a, k))
        # Bias some streams toward valid sync bytes so both branches run.
        if trial % 2:
            shifted = bitshift_stream(data, a.bitphase)
            for i in range(npkts):
                if rng.random() < 0.7:
                    want = (MPEG_SYNC if (a.phase8 + i) & 7
                            else MPEG_SYNC_INV) ^ a.polarity
                    # plant the byte so the shifted stream shows `want`
                    w = (data[i * RS_SIZE].astype(np.uint16) << 8) \
                        | data[i * RS_SIZE + 1]
                    w &= ~(0xFF << a.bitphase) & 0xFFFF
                    w |= np.uint16(want) << a.bitphase
                    data[i * RS_SIZE] = w >> 8
                    data[i * RS_SIZE + 1] = w & 0xFF
        pk_a, c_a = a._run_decoding(data)
        pk_b, c_b = seq_run_decoding(b, data)
        assert c_a == c_b
        np.testing.assert_array_equal(pk_a, pk_b)
        for k in ("synchronized", "phase8", "lock_timeleft", "locktime",
                  "next_sync_count"):
            assert getattr(a, k) == getattr(b, k), k
        assert a.locktime_count == b.locktime_count
        assert list(a.lock_events) == list(b.lock_events)


def seq_derandomize(packets, pos):
    pat = prbs.prbs_pattern().reshape(8, 188)
    out = np.empty_like(packets)
    good = np.zeros(packets.shape[0], dtype=bool)
    for i, pkt in enumerate(packets):
        if pkt[0] in (prbs.MPEG_SYNC_INV,
                      prbs.MPEG_SYNC_INV ^ prbs.MPEG_SYNC_CORRUPTED):
            pos = 0
        out[i] = pkt ^ pat[pos]
        pos = (pos + 1) % 8
        if out[i, 0] == prbs.MPEG_SYNC:
            good[i] = True
        else:
            out[i, 1] |= 0x80
    return out, good, pos


@pytest.mark.parametrize("seed", range(6))
def test_derandomize_matches_sequential(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n = int(rng.integers(1, 40))
        pkts = rng.integers(0, 256, (n, 188), dtype=np.uint8)
        # sprinkle realistic sync bytes
        sel = rng.random(n) < 0.6
        pkts[sel, 0] = rng.choice(
            [prbs.MPEG_SYNC_INV, prbs.MPEG_SYNC_INV ^ 0x55,
             prbs.MPEG_SYNC, 0x12], size=int(sel.sum()))
        pos0 = int(rng.integers(0, 8))
        o1, g1, p1 = prbs.derandomize_np(pkts.copy(), pos0)
        o2, g2, p2 = seq_derandomize(pkts.copy(), pos0)
        np.testing.assert_array_equal(o1, o2)
        np.testing.assert_array_equal(g1, g2)
        assert p1 == p2
