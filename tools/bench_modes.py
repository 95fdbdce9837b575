#!/usr/bin/env python
"""Mode-space perf matrix: throughput records for the receiver modes
beyond QPSK-1/2 (VERDICT r2 item 10) — the --hs integer fast-QPSK path
(reference sdr.h:946-1189) and the 8PSK demodulator (cstln_receiver with
the PSK8 LUT, sdr.h:305-311 predefs).

Prints one JSON line per mode with Msamples/s/chip at a fleet shape,
using the marginal time of chained calls (fixed per-call overheads
cancel).
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _marginal(call, state, reps=4):
    """Best-of-3 marginal time of `reps` chained calls minus one."""
    def run(k):
        best = 1e9
        for _ in range(3):
            st = state
            t0 = time.perf_counter()
            for _ in range(k):
                st, out = call(st)
            leaf = next(iter(st.values())) if isinstance(st, dict) else st
            float(np.asarray(leaf).sum())
            best = min(best, time.perf_counter() - t0)
        return best
    run(1)
    return max((run(reps) - run(1)) / (reps - 1), 1e-9)


def bench_hs(nchan=64, nsamp=None):
    """--hs: integer fast-QPSK (u8 LUT PLL + integer M&M), batched."""
    import jax.numpy as jnp
    from leansdr_jax.dsp import receiver_hs as hs

    nsamp = nsamp or 256 * hs.CHUNK
    params = hs.HsParams(omega=2.0)
    tables = hs.hs_tables()
    state = hs.init_state(params, nchan)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, 256, (nchan, nsamp + 1, 2),
                                 dtype=np.uint8))

    def call(st):
        st, out = hs.run_chunks_hs(params, tables, st, x)
        return st, out

    st, _ = call(state)
    marg = _marginal(call, state)
    return nchan * nsamp / marg / 1e6


def bench_8psk(nchan=64, nsamp=None):
    """8PSK demod (PSK8 predef through the generic cstln receiver)."""
    import jax.numpy as jnp
    from leansdr_jax.dsp import receiver
    from leansdr_jax.dsp.cstln import Predef, make_dvbs2_constellation

    nsamp = nsamp or 256 * receiver.CHUNK
    cstln = make_dvbs2_constellation(Predef.PSK8, "2/3")
    params = receiver.ReceiverParams(omega=2.0, sampler="linear",
                                     nsymbols=cstln.nsymbols,
                                     exact_lut=False)
    tables = receiver.make_tables(cstln)
    state = receiver.init_state(params, nchan)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(
        scale=75.0, size=(nchan, nsamp + 1, 2)).astype(np.float32))

    def call(st):
        st, out = receiver.run_chunks(params, tables, st, x)
        return st, out

    st, _ = call(state)
    marg = _marginal(call, state)
    return nchan * nsamp / marg / 1e6


def _bench_pallas(predef, cr, nsym, nchan=64, nsamp=None):
    """Non-QPSK constellations through the demod kernel (the
    generic nsym-way argmin branch, receiver_pallas.py; parity vs the
    scan path pinned in tests/test_receiver_pallas.py)."""
    import jax.numpy as jnp
    from leansdr_jax.dsp import receiver, receiver_pallas as rp
    from leansdr_jax.dsp.cstln import make_dvbs2_constellation

    nsamp = nsamp or 256 * receiver.CHUNK
    cstln = make_dvbs2_constellation(predef, cr)
    params = receiver.ReceiverParams(omega=2.0, sampler="linear",
                                     nsymbols=nsym, exact_lut=False)
    sc = rp.sym_constants(cstln)
    state = rp.pack_state(receiver.init_state(params, nchan))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(
        scale=75.0, size=(nchan, nsamp + 1, 2)).astype(np.float32))

    def call(st):
        return rp.demod_pallas(params, sc, st, x)

    st, _ = call(state)
    float(np.asarray(st).sum())
    marg = _marginal(call, state)
    return nchan * nsamp / marg / 1e6


def bench_8psk_pallas(nchan=64):
    from leansdr_jax.dsp.cstln import Predef
    return _bench_pallas(Predef.PSK8, "2/3", 8, nchan)


def bench_16apsk_pallas(nchan=64):
    from leansdr_jax.dsp.cstln import Predef
    return _bench_pallas(Predef.APSK16, "3/4", 16, nchan)


def main():
    import jax
    from leansdr_jax.util.jax_cache import setup_cache
    setup_cache(REPO)
    for name, fn, baseline in (
            # Reference --hs mode: "2.4 Msamples/s on one core" class
            # (README.md:40-44); 8PSK has no single-number reference
            # baseline — recorded for mode-space coverage.
            ("hs_int_qpsk", bench_hs, 2.4),
            ("demod_8psk", bench_8psk, 2.4),
            ("demod_8psk_pallas", bench_8psk_pallas, 2.4),
            ("demod_16apsk_pallas", bench_16apsk_pallas, 2.4)):
        try:
            v = fn()
            print(json.dumps({
                "metric": f"{name}_throughput_per_chip",
                "nchan": 64,
                "value": round(v, 1),
                "unit": "Msamples/s/chip",
                "vs_baseline": round(v / baseline, 1),
            }))
        except Exception as e:
            print(json.dumps({"metric": name, "error": repr(e)[:300]}))


if __name__ == "__main__":
    main()
