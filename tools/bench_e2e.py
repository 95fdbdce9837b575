#!/usr/bin/env python
"""End-to-end multi-channel RX throughput (the north-star shape:
64 x 2.4 Msps DVB-S QPSK channels, BASELINE.json).

Measures the FULL receive chain — device demodulation + device
deconvolution (symbol compaction ring, GF(2) convolution, hypothesis
election) + vectorized host byte stages (framing, deinterleave, batched
RS, derandomizer) — and reports aggregate Msamples/s and the realtime
factor versus 64 channels at 2.4 Msps input.

Software-pipelined: chunk k+1's device work is dispatched before chunk
k's bytes are fetched, so the host link transfer and the host byte
backend overlap device compute.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main():
    import jax
    from leansdr_jax.util.jax_cache import setup_cache
    setup_cache(REPO)

    from leansdr_jax.pipelines import tsgen, dvbs_tx
    from leansdr_jax.pipelines.dvbs_rx import RxConfig
    from leansdr_jax.pipelines.multi_rx import MultiDvbsReceiver

    import jax.numpy as jnp
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    nchan = int(args[0]) if len(args) > 0 else 64
    CH = 1 << int(args[1]) if len(args) > 1 else (1 << 18)
    nchunks = int(args[2]) if len(args) > 2 else 20
    viterbi = "--viterbi" in sys.argv
    rate = "1/2"
    for a in sys.argv[1:]:
        if a.startswith("--cr="):
            rate = a.split("=", 1)[1]
    if "--no-native" in sys.argv:
        import os
        os.environ["LEANSDR_NO_NATIVE"] = "1"
    # Stimulus synthesized ON DEVICE (pipelines/dvbs_tx_device.py): the
    # bench input never crosses the host link — on real hardware ingest
    # is double-buffered host->device DMA.
    # Sized to cover the whole measurement window so no mid-run wrap
    # (a wrap breaks carrier phase -> re-lock transient -> host framing
    # search, which is not part of the steady-state chain under test).
    # The stimulus stays SINGLE-channel on device (a 64-channel copy of
    # a multi-minute window would exceed HBM); each chunk is broadcast
    # to the fleet on device as part of the timed ingest.
    num, den = (int(v) for v in rate.split("/"))
    spp = 1632 * den // num          # samples per RS packet (QPSK, 2 sps)
    npkt = ((nchunks + 2) * CH) // spp + 16   # +interleaver holdback
    pkts = tsgen.generate(npkt)
    from leansdr_jax.pipelines.dvbs_tx_device import device_stimulus
    y = device_stimulus(pkts, rate=rate)
    n = (y.shape[0] - 1) // CH * CH
    bcast = jax.jit(lambda v: jnp.broadcast_to(v[None], (nchan,) + v.shape)
                    + 0.0)

    rx = MultiDvbsReceiver(
        RxConfig(Fs=4e6, Fm=2e6, rate=rate, fastlock=True,
                 float_scale=75.0, exact_lut=False, viterbi=viterbi),
        nchan, chunk_samples=CH)
    rx.process(bcast(y[:CH + 1]))    # warm up compile + prime the ring

    # submit() is asynchronous (fetch + byte backend run on worker
    # threads), so the meaningful per-chunk time is the COMPLETION
    # cadence: timestamp each chunk as its byte backend finishes.
    done_ts = []
    orig_collect = rx.collect

    def timed_collect(pend):
        r = orig_collect(pend)
        done_ts.append(time.perf_counter())
        return r

    rx.collect = timed_collect

    starts = list(range(CH, n - CH, CH))
    t0 = time.perf_counter()
    decoded = 0
    for k in range(nchunks):
        s = starts[k % len(starts)]
        ta = time.perf_counter()
        for outs in rx.submit(bcast(y[s:s + CH + 1])):
            decoded += sum(len(o) for o in outs)
        tc = time.perf_counter()
        if tc - ta > 0.05:
            print(f"chunk {k}: submit blocked {tc - ta:.3f}s",
                  file=sys.stderr)
    for outs in rx.flush():
        decoded += sum(len(o) for o in outs)
    dt = time.perf_counter() - t0
    total = nchan * nchunks * CH
    msps = total / dt / 1e6
    # Steady state: median completion-to-completion gap over the second
    # half (robust to one-off stalls and warm-up compiles).
    gaps = sorted(np.diff(done_ts[len(done_ts) // 2:]))
    med = float(gaps[len(gaps) // 2]) if gaps else float("nan")
    steady = nchan * CH / med / 1e6 if gaps else 0.0
    print("completion gaps (s): " +
          " ".join(f"{g:.3f}" for g in np.diff(done_ts)), file=sys.stderr)
    print(json.dumps({
        "metric": "e2e_rx_throughput",
        "nchan": nchan,
        "chunk": CH,
        "viterbi": viterbi,
        "rate": rate,
        "value": round(msps, 1),
        "unit": "Msamples/s aggregate (full chain to TS)",
        "realtime_factor_vs_64x2.4Msps": round(msps / (64 * 2.4), 2),
        "steady_msps": round(steady, 1),
        "steady_realtime_factor": round(steady / (64 * 2.4), 2),
        "decoded_packets": decoded,
        "locks": sum(rx.locks),
    }))


if __name__ == "__main__":
    main()
