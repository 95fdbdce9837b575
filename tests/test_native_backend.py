"""Parity tests: the C++ byte backend (leansdr_jax/native) vs the Python
fleet backend (pipelines/multi_rx._ByteBackend) on identical streams.

The Python path is the behavioral reference (itself golden-tested against
the upstream binaries), so these tests pin the native runtime to it
byte-for-byte across framing lock/unlock, polarity inversion, bit-phase
shifts, RS correction/failure and derandomizer resync.
"""

import numpy as np
import pytest

from leansdr_jax.pipelines import tsgen
from leansdr_jax.fec import rs, interleave, prbs
from leansdr_jax.pipelines.multi_rx import _ByteBackend

native = pytest.importorskip("leansdr_jax.native")
if native.get_lib() is None:
    import shutil
    if shutil.which("g++"):
        # A compiler exists, so an unavailable backend means the build
        # BROKE — surface it instead of silently skipping.
        raise AssertionError(
            "native byte backend failed to build with g++ present:\n"
            + str(native.build_lib(verbose=True)))
    pytest.skip("native backend unavailable (no compiler)",
                allow_module_level=True)


def make_stream(npkt, seed, nerr=0, prefix=0, invert=False, bitshift=0,
                burst=None):
    """TS -> randomize -> RS encode -> interleave byte stream, impaired."""
    rng = np.random.default_rng(seed)
    ts = tsgen.generate(npkt)
    rnd, _ = prbs.randomize(ts, 0)
    enc = rs.encode(rnd)
    il, _ = interleave.interleave(enc)
    b = il.astype(np.uint8).copy()
    if nerr:
        pos = rng.integers(0, len(b), nerr)
        b[pos] ^= rng.integers(1, 256, nerr).astype(np.uint8)
    if burst is not None:  # (offset, length): wipe a span (unlock test)
        o, ln = burst
        b[o:o + ln] = rng.integers(0, 256, ln).astype(np.uint8)
    if prefix:
        b = np.concatenate(
            [rng.integers(0, 256, prefix).astype(np.uint8), b])
    if invert:
        b = b ^ np.uint8(0xFF)
    if bitshift:
        w = (b[:-1].astype(np.uint16) << 8) | b[1:]
        b = ((w >> (8 - bitshift)) & 0xFF).astype(np.uint8)
    return b


def run_parity(streams, fastlock, chunk=4096, with_next_sync=False):
    C = len(streams)
    fires_py = np.zeros(C, np.int64)
    fires_nat = np.zeros(C, np.int64)

    def cb_py(c):
        fires_py[c] += 1

    def cb_nat(c):
        fires_nat[c] += 1

    py = _ByteBackend(C, fastlock,
                      on_next_sync=cb_py if with_next_sync else None)
    nat = native.NativeByteBackend(
        C, fastlock, on_next_sync=cb_nat if with_next_sync else None)
    total = np.zeros(C, np.int64)
    maxlen = max(len(s) for s in streams)
    for o in range(0, maxlen, chunk):
        part = [s[o:o + chunk] for s in streams]
        a = py.feed(part)
        b = nat.feed(part)
        for c in range(C):
            assert a[c].shape == b[c].shape, (c, o)
            assert (a[c] == b[c]).all(), (c, o)
            total[c] += len(a[c])
    assert py.locks == nat.locks
    assert (py.vbitcount == nat.vbitcount).all()
    assert (py.verrcount == nat.verrcount).all()
    if with_next_sync:
        assert (fires_py == fires_nat).all()
    return total, nat


def test_parity_fastlock_impaired():
    streams = [
        # 600 packets (~122 KB) crosses the ByteFifo compaction
        # threshold (byte_backend.cc head > 65536), exercising it.
        make_stream(600, 1),                          # clean, aligned
        make_stream(300, 2, nerr=40, prefix=777),     # errors + search
        make_stream(300, 3, invert=True, bitshift=3),  # polarity + shift
        make_stream(300, 4, nerr=25, prefix=391, invert=True, bitshift=6),
    ]
    total, nat = run_parity(streams, fastlock=True)
    assert (total > 250).all()
    assert (nat.verrcount[[1, 3]] > 0).all()


def test_parity_unlock_relock():
    # A long noise burst mid-stream forces unlock + re-acquisition.
    streams = [
        make_stream(400, 5, burst=(30000, 5000)),
        make_stream(400, 6, burst=(40000, 12000), bitshift=1),
    ]
    total, _ = run_parity(streams, fastlock=True, chunk=3000)
    assert (total > 250).all()


def test_parity_nonfastlock_next_sync():
    # Non-fastlock searching over garbage fires the deconvolver resync
    # callback (3 full bitphase sweeps); parity includes fire counts.
    rng = np.random.default_rng(7)
    garbage = rng.integers(0, 256, 60000).astype(np.uint8)
    good = make_stream(200, 8)
    streams = [np.concatenate([garbage, good]),
               make_stream(200, 9, prefix=123)]
    total, _ = run_parity(streams, fastlock=False, chunk=2048,
                          with_next_sync=True)
    assert (total > 100).all()


def test_parity_rs_failures():
    # Dense errors: some packets exceed t=8 and must fail identically
    # (sync ^ 0x55 marking, derand resync behavior, drops).
    streams = [make_stream(250, 10, nerr=600),
               make_stream(250, 11, nerr=900)]
    total, nat = run_parity(streams, fastlock=True)
    # with these error densities some packets must still decode
    assert (total > 50).all()
    assert (nat.verrcount > 500).all()


def test_rs_packet_parity_random():
    # Direct RS decode parity on random error patterns (0..12 byte errs).
    rng = np.random.default_rng(12)
    msgs = rng.integers(0, 256, (64, 188)).astype(np.uint8)
    enc = rs.encode(msgs)
    pkts = enc.copy()
    for i in range(64):
        ne = int(rng.integers(0, 13))
        pos = rng.choice(204, ne, replace=False)
        pkts[i, pos] ^= rng.integers(1, 256, ne).astype(np.uint8)
    out_py, failed_py, bits_py = rs.decode(pkts)

    # Run through the native backend via a raw single-channel context is
    # indirect; instead reuse the library's RS through a framing-free
    # equivalence: packets with <=8 errors must decode to msgs.
    fixable = np.array([(pkts[i] != enc[i]).sum() <= 8 for i in range(64)])
    assert (~failed_py[fixable]).all()
    assert (out_py[fixable] == msgs[fixable]).all()


@pytest.mark.parametrize("seed", [21, 22])
def test_parity_random_chunk_boundaries(seed):
    """Chunk boundaries are where FSM carry-over bugs hide: the same
    impaired streams split at random points must decode identically."""
    rng = np.random.default_rng(seed)
    streams = [
        make_stream(250, seed * 10 + 1, nerr=30, prefix=511),
        make_stream(250, seed * 10 + 2, invert=True, bitshift=5,
                    burst=(20000, 3000)),
    ]
    C = len(streams)
    py = _ByteBackend(C, True)
    nat = native.NativeByteBackend(C, True)
    maxlen = max(len(s) for s in streams)
    o = 0
    while o < maxlen:
        n = int(rng.integers(1, 6000))
        part = [s[o:o + n] for s in streams]
        a = py.feed(part)
        b = nat.feed(part)
        for c in range(C):
            assert (a[c] == b[c]).all(), (c, o, n)
        o += n
    assert py.locks == nat.locks
    assert (py.verrcount == nat.verrcount).all()
