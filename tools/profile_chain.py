#!/usr/bin/env python
"""Stage-level profile of the 64-channel full receive chain.

Breaks the per-chunk device time of `MultiDvbsReceiver.dispatch` into
its stages — RRC matched-filter prefilter, demod kernel, sym/valid
extraction, ring append, decode — plus the host side of `collect`
(link fetch, byte backend), using the marginal time of chained reps
with one scalar digest fetch at the end. The demod and ACS paths are
the ones platform.families() picks for the backend.

Usage: python tools/profile_chain.py [nchan] [log2_chunk] [--viterbi]
Prints one JSON line with per-stage seconds per chunk and the implied
aggregate Msps of each stage in isolation.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _marginal(fn, reps=4, tries=2):
    """Best-of marginal seconds per call: (T(reps) - T(1)) / (reps-1)."""
    def run(r):
        best = 1e9
        for _ in range(tries):
            t0 = time.perf_counter()
            fn(r)
            best = min(best, time.perf_counter() - t0)
        return best
    run(1)
    return max((run(reps) - run(1)) / (reps - 1), 1e-9)


def _note(res, k, v):
    res[k] = v
    print(f"# {k} = {v}", flush=True)


def main():
    import jax
    from leansdr_jax.util.jax_cache import setup_cache
    setup_cache(REPO)
    import jax.numpy as jnp
    from leansdr_jax.pipelines import tsgen
    from leansdr_jax.pipelines.dvbs_rx import RxConfig
    from leansdr_jax.pipelines.multi_rx import MultiDvbsReceiver

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    nchan = int(args[0]) if args else 64
    CH = 1 << (int(args[1]) if len(args) > 1 else 18)
    viterbi = "--viterbi" in sys.argv
    segments = (int(sys.argv[sys.argv.index("--segments") + 1])
                if "--segments" in sys.argv else 1)
    rate = (sys.argv[sys.argv.index("--rate") + 1]
            if "--rate" in sys.argv else "1/2")

    print("# tx synth", flush=True)
    num, den = (int(v) for v in rate.split("/"))
    spp = 1632 * den // num
    pkts = tsgen.generate(5 * CH // spp + 12)
    from leansdr_jax.pipelines.dvbs_tx_device import device_stimulus
    y = device_stimulus(pkts, rate=rate)

    rx = MultiDvbsReceiver(
        RxConfig(Fs=4e6, Fm=2e6, rate=rate, fastlock=True,
                 float_scale=75.0, exact_lut=False, viterbi=viterbi,
                 sampler="rrc"),
        nchan, chunk_samples=CH, segments=segments, seg_holdoff=0)
    ra = rx.params.readahead + (len(rx.mf_taps) - 1
                                if rx.mf_taps is not None else 0)
    bcast = jax.jit(lambda v: jnp.broadcast_to(
        v[None], (nchan,) + v.shape) + 0.0)
    wins = [bcast(y[s:s + CH + ra]) for s in range(0, 4 * CH, CH)]
    digest = jax.jit(lambda a: jnp.sum(a.astype(jnp.int32)))

    for k in range(4):
        t0 = time.perf_counter()
        rx.process(wins[k % 4])
        print(f"# warmup {k}: {time.perf_counter()-t0:.1f}s", flush=True)
    print("# warmup done", flush=True)

    res = {"nchan": nchan, "chunk": CH, "viterbi": viterbi,
           "segments": segments, "rate": rate}

    # -- full dispatch (all device stages) ------------------------------
    def full(r):
        ds = []
        for k in range(r):
            pend = rx.dispatch(wins[k % 4])
            if pend is not None:
                ds.append(digest(pend[0]))
        assert np.isfinite(sum(float(np.asarray(d)) for d in ds))
    _note(res, "dispatch_s", _marginal(full))

    # -- segmented demod (two-pass engine: mf + both demod passes +
    # rotation/splice + extraction, VERDICT r4 item 5) -------------------
    if segments > 1 and rx.use_pallas:
        from functools import partial
        import jax as _jax
        from leansdr_jax.pipelines.multi_rx import _demod_segmented

        @partial(_jax.jit, static_argnames=())
        def segdem(st, seg_st, x):
            st, seg_st, sym, valid, cost = _demod_segmented(
                rx.params, rx._sym_consts, rx.mf_taps, nchan, segments,
                rx.seg_warmup, viterbi, True, rx._interpret, None,
                st, seg_st, x)
            return st, seg_st, sym[0, 0].astype(jnp.int32)

        def sd(r):
            st, seg_st = rx._planes, rx._seg_state
            d = None
            for k in range(r):
                st, seg_st, d = segdem(st, seg_st, wins[k % 4])
            assert np.isfinite(float(np.asarray(d)))
        _note(res, "segdem_s", _marginal(sd))
        res["ring_decode_s"] = max(
            0.0, res["dispatch_s"] - res["segdem_s"])
        budget = nchan * CH
        for k in ("dispatch_s", "segdem_s", "ring_decode_s"):
            res[k + "_msps"] = round(budget / res[k] / 1e6, 1) \
                if res[k] else None
            res[k] = round(res[k], 4)
        # host side still measured below
        pend = rx.dispatch(wins[0])
        np.asarray(pend[0])
        t0 = time.perf_counter()
        buf = np.asarray(pend[0])
        res["fetch_s"] = round(time.perf_counter() - t0, 4)
        res["fetch_bytes"] = int(buf.nbytes)
        t0 = time.perf_counter()
        rx.collect((buf, pend[1]))
        res["backend_s"] = round(time.perf_counter() - t0, 4)
        print(json.dumps(res))
        return

    # -- mf prefilter ----------------------------------------------------
    if rx.mf_taps is not None:
        from leansdr_jax.dsp.mf_prefilter import mf_prefilter
        freqw = rx._planes[2] if rx.use_pallas else rx.state["freqw"]

        def mf(r):
            acc = None
            for k in range(r):
                ybuf = mf_prefilter(rx.mf_taps, freqw, wins[k % 4])
                acc = ybuf
            assert np.isfinite(float(np.asarray(acc[0, 0, 0])))
        _note(res, "mf_s", _marginal(mf))
    else:
        res["mf_s"] = 0.0

    # -- demod kernel (chained state) ------------------------------------
    if rx.use_pallas:
        from leansdr_jax.dsp import receiver_pallas as rp
        from leansdr_jax.dsp.mf_prefilter import mf_prefilter
        if rx.mf_taps is not None:
            xs = [mf_prefilter(rx.mf_taps, freqw, w) for w in wins]
        else:
            xs = wins
        for x in xs:
            x.block_until_ready()

        def dem(r):
            st = rx._planes
            packed = None
            for k in range(r):
                st, packed = rp.demod_pallas(rx.params, rx._sym_consts,
                                             st, xs[k % 4])
            assert np.isfinite(float(np.asarray(st[0]).sum()))
        _note(res, "demod_s", _marginal(dem))

        # extraction (sym/valid/cost unpack + compaction inputs)
        from leansdr_jax.pipelines.multi_rx import _extract_sym_valid
        st2, packed = rp.demod_pallas(rx.params, rx._sym_consts,
                                      rx._planes, xs[0])
        packed.block_until_ready()

        def ext(r):
            out = None
            for _ in range(r):
                out = _extract_sym_valid(packed, nchan, viterbi)
            assert np.isfinite(float(np.asarray(out[0][0, 0])))
        _note(res, "extract_s", _marginal(ext))

        # ring append + decode = the dispatch residual (independent
        # noisy marginals: clamp at 0 rather than report negative time)
        res["ring_decode_s"] = max(
            0.0, res["dispatch_s"] - res["mf_s"] - res["demod_s"]
            - res["extract_s"])

    # -- collect: link fetch + host byte backend -------------------------
    pend = rx.dispatch(wins[0])
    np.asarray(pend[0])          # force device compute to finish
    t0 = time.perf_counter()
    buf = np.asarray(pend[0])    # second fetch = pure link transfer
    res["fetch_s"] = time.perf_counter() - t0
    res["fetch_bytes"] = int(buf.nbytes)

    # collect() on a prefetched ndarray = host backend only:
    t0 = time.perf_counter()
    rx.collect((buf, pend[1]))
    res["backend_s"] = time.perf_counter() - t0

    budget = nchan * CH
    for k in ("dispatch_s", "mf_s", "demod_s", "extract_s",
              "ring_decode_s", "fetch_s", "backend_s"):
        if res.get(k):
            res[k + "_msps"] = round(budget / res[k] / 1e6, 1)
            res[k] = round(res[k], 4)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
