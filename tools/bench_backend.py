#!/usr/bin/env python
"""Byte-domain backend microbenchmark: native C++ vs vectorized Python.

Host-only (no device needed): feeds identical impaired DVB-S byte streams
(randomize -> RS encode -> interleave, with byte errors) through both
backends at the fleet shape and reports ms/chunk and the speedup.

Usage: python tools/bench_backend.py [nchan] [npackets_per_chan]
Prints one JSON line.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main():
    nchan = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    npkt = int(sys.argv[2]) if len(sys.argv) > 2 else 500

    from leansdr_jax.pipelines import tsgen
    from leansdr_jax.fec import rs, interleave, prbs
    from leansdr_jax.pipelines.multi_rx import _ByteBackend

    rng = np.random.default_rng(0)
    streams = []
    for c in range(nchan):
        ts = tsgen.generate(npkt, start=97 * c)
        rnd, _ = prbs.randomize(ts, 0)
        il, _ = interleave.interleave(rs.encode(rnd))
        b = il.astype(np.uint8).copy()
        pos = rng.integers(0, len(b), 30)          # keep RS busy
        b[pos] ^= rng.integers(1, 256, 30).astype(np.uint8)
        streams.append(b)
    CHUNK = 16384   # bytes/chan/chunk ~ one 2^18-sample chunk at r1/2
    maxlen = max(len(s) for s in streams)
    nchunks = (maxlen + CHUNK - 1) // CHUNK

    def run(be):
        t0 = time.perf_counter()
        total = 0
        for o in range(0, maxlen, CHUNK):
            outs = be.feed([s[o:o + CHUNK] for s in streams])
            total += sum(len(x) for x in outs)
        return time.perf_counter() - t0, total

    res = {"nchan": nchan, "chunks": nchunks}
    try:
        from leansdr_jax.native import NativeByteBackend
        tn, pn = run(NativeByteBackend(nchan, True))
        res["native_ms_per_chunk"] = round(tn / nchunks * 1e3, 2)
        res["packets"] = pn
    except Exception as e:
        res["native_error"] = repr(e)
        tn = None
    tp, pp = run(_ByteBackend(nchan, True))
    res["python_ms_per_chunk"] = round(tp / nchunks * 1e3, 2)
    if tn is not None:
        assert pn == pp, (pn, pp)
        res["speedup"] = round(tp / tn, 1)
    # implied backend-stage throughput at the fleet shape (r1/2, 2 sps:
    # 1 byte of deconv output per 16 input samples)
    if tn:
        res["native_msps_equivalent"] = round(
            nchan * maxlen * 16 / tn / 1e6, 1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
