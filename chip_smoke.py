#!/usr/bin/env python3
"""Smoke test of the DVB-S receive chain on one GPU.

    python3 chip_smoke.py [--phases kernels,chain,cli]

Phases (all by default), each stopping the script with a non-zero exit
at its first failure:

  kernels  the demod kernel vs receiver.run_chunks(exact_lut=False) at
           64 lanes x 2^18 samples and 1024 lanes x 2^15 samples (the
           64-channel and 128-channel x 8-segment shapes); the Viterbi
           ACS kernel vs the host ViterbiBank for rates 1/2, 3/4, 7/8
           at 64-channel widths (bit-exact); fft_planes vs numpy.
  chain    MultiDvbsReceiver — Fs 4e6, Fm 2e6, QPSK, sampler rrc,
           viterbi, fastlock, chunk 2^18 — at 64 channels rate 1/2
           segments 1 and 8, rates 3/4 and 7/8 at segments 8, and 128
           channels rate 1/2 segments 8, on a seeded clean stimulus
           (tsgen + device modulation). After lock every channel's TS
           must be the transmitted packets in order, none lost.
  cli      leandvb --viterbi and leandvbfleet through their main(), in
           this process (one process holds the card).

It exits non-zero, printing no result, when JAX finds no GPU. The last
line of a passing run is one JSON object naming the device.
"""

import argparse
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CH = 1 << 18
SEED = 1


def die(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        die(msg)


def log(*a):
    print(*a, flush=True)


# -- stimulus ---------------------------------------------------------------

def _packets(n, start=0):
    from leansdr_jax.pipelines import tsgen
    return tsgen.generate(n, start=start)


def _lane_windows(y, nlanes, length, start, stride=10007):
    """[nlanes, length, 2] device windows of the [m, 2] stream y: lane c
    starts at sample start + c*stride, so every lane sees other data."""
    import jax
    import jax.numpy as jnp
    offs = start + stride * jnp.arange(nlanes)
    return jax.vmap(lambda o: jax.lax.dynamic_slice_in_dim(
        y, o, length, axis=0))(offs)


def _index_of(pkts):
    return {p.tobytes(): i for i, p in enumerate(pkts)}


MAX_PRELOCK = 16     # packets a receiver may emit before it locks


def _check_stream(decoded, index, what):
    """After lock (the first decoded packet that was sent) the decoded
    TS must be the sent stream in order: no packet lost, repeated or
    corrupted. Returns the number of packets decoded after lock."""
    ids = [index.get(p.tobytes()) for p in decoded]
    lock = next((j for j, i in enumerate(ids) if i is not None), len(ids))
    check(lock <= MAX_PRELOCK, f"{what}: {lock} packets before lock")
    run = ids[lock:]
    for j in range(1, len(run)):
        check(run[j] is not None and run[j] == run[j - 1] + 1,
              f"{what}: packet {lock + j} after lock is not the next sent "
              f"packet (sent indices around it: {run[max(0, j - 3):j + 4]})")
    return len(run)


# -- phase: kernels -----------------------------------------------------------

# Demod kernel vs XLA scan tolerance. Both compute the same gather-free
# decisions in float32, but the kernel's sin/cos/sqrt come from the GPU
# math library through Triton and the scan's from XLA, and the two
# programs contract and order float operations differently; results may
# differ by an ulp. At omega = 2 the timing loop sits between two
# symmetric emission parities, so an ulp can move an emission by one
# sample (the valid masks then differ on stretches, printed but not
# bounded) without changing the symbols. What is bounded: per lane, the
# emitted symbol sequences over the second half of the chunk (after
# acquisition) agree on at least this fraction, and both paths decode
# the same TS.
DEMOD_AGREEMENT_MIN = 0.99


def _demod_vs_scan(nlanes, nsamp):
    import numpy as np
    from leansdr_jax.dsp import receiver, receiver_pallas as rp
    from leansdr_jax.dsp.cstln import Predef, make_dvbs2_constellation
    from leansdr_jax.pipelines.dvbs_tx_device import device_stimulus
    from leansdr_jax.pipelines.multi_rx import _ByteChain

    cstln = make_dvbs2_constellation(Predef.QPSK, "1/2")
    params = receiver.ReceiverParams(omega=2.0, sampler="linear",
                                     nsymbols=4, exact_lut=False)
    need = nsamp + 1 + 10007 * nlanes
    pkts = _packets(need // 3264 + 16, start=SEED * 1000)
    y = device_stimulus(pkts, "1/2")
    x = _lane_windows(y, nlanes, nsamp + 1, 0)
    st0 = receiver.init_state(params, nlanes)
    t0 = time.perf_counter()
    st_k, packed = rp.demod_pallas(params, rp.sym_constants(cstln),
                                   rp.pack_state(st0), x)
    cost_k, sym_k, val_k = rp.unpack_outputs(packed)
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    st_s, out = receiver.run_chunks(params, receiver.make_tables(cstln),
                                    st0, x)
    sym_s = np.asarray(out["symbol"])
    val_s = np.asarray(out["valid"])
    t_s = time.perf_counter() - t0
    check(np.isfinite(np.asarray(st_k)).all(), "demod kernel state")
    h = nsamp // 2
    vagree = (val_k[:, h:] == val_s[:, h:]).mean(axis=1)
    sagree = np.empty(nlanes)
    for c in range(nlanes):
        a = sym_k[c, h:][val_k[c, h:]]
        b = sym_s[c, h:][val_s[c, h:]]
        m = min(len(a), len(b))
        sagree[c] = (a[:m] == b[:m]).mean() if m else 0.0
    log(f"demod {nlanes} lanes x {nsamp} samples: valid agreement "
        f"min {vagree.min():.6f} mean {vagree.mean():.6f} (unbounded); "
        f"emitted-"
        f"symbol agreement min {sagree.min():.6f} mean "
        f"{sagree.mean():.6f} (bound {DEMOD_AGREEMENT_MIN}); first "
        f"call incl. compile: kernel {t_k:.2f} s, scan {t_s:.2f} s")
    check(sagree.min() >= DEMOD_AGREEMENT_MIN,
          f"demod symbol agreement {sagree.min()} < bound")
    if nsamp >= CH:
        # The same TS from both symbol streams (host byte chain).
        index = _index_of(pkts)
        for c in range(4):
            ts = []
            for sym, val in ((sym_k, val_k), (sym_s, val_s)):
                ts.append(_ByteChain("1/2", fastlock=True).feed(
                    sym[c][val[c]]))
            check(len(ts[0]) >= 20, f"demod lane {c}: {len(ts[0])} TS")
            check(np.array_equal(ts[0], ts[1]),
                  f"demod lane {c}: kernel and scan decode different TS")
            _check_stream(ts[0], index, f"demod lane {c}")
        log(f"demod lanes 0-3: kernel and scan decode the same TS "
            f"({len(ts[0])} packets on lane 3)")


def _acs_vs_bank(rate, nchan=64, T=1024):
    import numpy as np
    import jax.numpy as jnp
    from leansdr_jax.fec import viterbi as vit
    from leansdr_jax.fec.viterbi_acs import acs_geometry, viterbi_acs
    from leansdr_jax.dsp.cstln import Predef, make_dvbs2_constellation

    cstln = make_dvbs2_constellation(Predef.QPSK, rate)
    nsyncs = np.prod(vit.make_sync_maps(cstln, rate)[1:4])
    N = int(nchan * nsyncs)
    t = vit.make_trellis(rate)
    geo = acs_geometry(rate)
    rng = np.random.default_rng(SEED)
    cs = rng.integers(0, t.ncs, (T, N)).astype(np.int32)
    cost = -(rng.integers(0, 4, (T, N)) * 3).astype(np.int32)
    z = jnp.zeros((N, 64), jnp.int32)
    t0 = time.perf_counter()
    m, h, lo, us, q = viterbi_acs(rate, z, z, z, jnp.asarray(cs),
                                  jnp.asarray(cost))
    us, q = np.asarray(us), np.asarray(q)
    dt = time.perf_counter() - t0
    sel = np.arange(0, N, max(1, N // 64))      # lanes are independent
    bank = vit.ViterbiBank(t, len(sel))
    idx = np.arange(len(sel))
    for k in range(T):
        bus, bq = bank.update(idx, cs[k, sel].astype(np.int64),
                              cost[k, sel].astype(np.int64))
        check(np.array_equal(us[k, sel], bus) and
              np.array_equal(q[k, sel], bq),
              f"ACS {rate}: block {k} differs from ViterbiBank")
    order = np.asarray(geo.order)
    check(np.array_equal(np.asarray(m)[sel],
                         bank.cost[:, order].astype(np.int32)),
          f"ACS {rate}: metrics differ from ViterbiBank")
    lo64 = np.asarray(lo)[sel].astype(np.uint32).astype(np.uint64)
    p64 = ((np.asarray(h)[sel].astype(np.uint32).astype(np.uint64) << 32)
           | lo64) if geo.two_words else lo64
    nbits, depth = vit.PATH_SPEC[rate]
    pm = np.uint64((1 << min(63, nbits * depth)) - 1)
    check(np.array_equal(p64 & pm, bank.path[:, order] & pm),
          f"ACS {rate}: paths differ from ViterbiBank")
    log(f"ACS {rate}: {N} lanes x {T} blocks bit-exact vs ViterbiBank "
        f"on {len(sel)} lanes (first call incl. compile {dt:.2f} s)")


def _fft_vs_numpy():
    import numpy as np
    import jax.numpy as jnp
    from leansdr_jax.dsp.fft import fft_planes
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(64, 4096)) + 1j * rng.normal(size=(64, 4096))
    yr, yi = fft_planes(jnp.asarray(x.real, jnp.float32),
                        jnp.asarray(x.imag, jnp.float32), 4096)
    ref = np.fft.fft(x, axis=-1)
    err = np.abs(np.asarray(yr) + 1j * np.asarray(yi) - ref).max() \
        / np.abs(ref).max()
    log(f"fft_planes 64 x 4096 (complex64) vs numpy float64: relative "
        f"error {err:.2e} (bound 1e-5)")
    check(err <= 1e-5, f"fft_planes relative error {err}")


def phase_kernels():
    _demod_vs_scan(64, CH)
    _demod_vs_scan(1024, CH // 8)
    for rate in ("1/2", "3/4", "7/8"):
        _acs_vs_bank(rate)
    _fft_vs_numpy()


# -- phase: chain -------------------------------------------------------------

CHAIN_CONFIGS = (("1/2", 64, 1), ("1/2", 64, 8), ("3/4", 64, 8),
                 ("7/8", 64, 8), ("1/2", 128, 8))
CHAIN_CHUNKS = 5
SEG_HOLDOFF = 2          # the first 2 chunks run sequentially


def _rx_config(rate):
    from leansdr_jax.pipelines.dvbs_rx import RxConfig
    return RxConfig(Fs=4e6, Fm=2e6, rate=rate, fastlock=True,
                    float_scale=75.0, exact_lut=False, viterbi=True,
                    sampler="rrc")


def _readahead(rx):
    return rx.params.readahead + (len(rx.mf_taps) - 1
                                  if rx.mf_taps is not None else 0)


def _print_memory_analysis():
    """compiled.memory_analysis() of the chunk's two programs at the
    64-channel rate-1/2 shape."""
    import jax
    import jax.numpy as jnp
    from leansdr_jax.pipelines.multi_rx import (MultiDvbsReceiver,
                                                _decode_chunk, _demod_chunk)
    rx = MultiDvbsReceiver(_rx_config("1/2"), 64, chunk_samples=CH)
    x = jnp.zeros((64, CH + _readahead(rx), 2), jnp.float32)
    args, kw, _ = rx._fused_args(x, CH)
    (params, sc, taps, nchan, kind, plan, plan_dec, maps, schedule,
     use_pallas, interp, acs_interp, tables, dem, seg, dstate, x) = args
    dargs = (params, sc, taps, nchan, True, use_pallas, interp, tables,
             dem, seg, x)
    demod = _demod_chunk.lower(*dargs, **kw).compile()
    log(f"demod program (64 ch) memory_analysis: "
        f"{demod.memory_analysis()}")
    _, _, sym, valid, cost = jax.eval_shape(
        lambda *a: _demod_chunk(*dargs[:7], *a, **kw), *dargs[7:])
    decode = _decode_chunk.lower(kind, plan, plan_dec, maps, schedule,
                                 acs_interp, dstate, sym, valid,
                                 cost).compile()
    log(f"decode program (64 ch, rate 1/2) memory_analysis: "
        f"{decode.memory_analysis()}")


def _chain(rate, nchan, segments):
    import numpy as np
    from leansdr_jax.pipelines.dvbs_tx_device import device_stimulus
    from leansdr_jax.pipelines.multi_rx import MultiDvbsReceiver

    rx = MultiDvbsReceiver(_rx_config(rate), nchan, chunk_samples=CH,
                           segments=segments, seg_holdoff=SEG_HOLDOFF)
    check(rx.use_pallas and rx.deconv.kind == "viterbi_acs",
          f"chain {rate}: kernel path not selected")
    ra = _readahead(rx)
    num, den = (int(v) for v in rate.split("/"))
    spp = 1632 * den // num                      # samples per RS packet
    need = CHAIN_CHUNKS * CH + ra + 10007 * nchan
    pkts = _packets(need // spp + 16, start=SEED * 7000)
    y = device_stimulus(pkts, rate)
    index = _index_of(pkts)
    outs = [[] for _ in range(nchan)]
    t0 = time.perf_counter()
    for k in range(CHAIN_CHUNKS):
        x = _lane_windows(y, nchan, CH + ra, k * CH)
        for c, ts in enumerate(rx.process(x)):
            if len(ts):
                outs[c].append(ts)
    dt = time.perf_counter() - t0
    counts = []
    for c in range(nchan):
        dec = np.concatenate(outs[c]) if outs[c] else np.empty((0, 188))
        counts.append(_check_stream(dec, index, f"chain {rate} "
                                    f"{nchan}ch S={segments} ch{c}"))
    counts = np.asarray(counts)
    # Lock takes part of the first chunk and the decoder's ring runs
    # about one chunk behind the demod; every later chunk delivers its
    # packets, so demand most of CHAIN_CHUNKS-2 chunks.
    floor = int(0.8 * (CHAIN_CHUNKS - 2) * CH / spp)
    log(f"chain rate {rate} {nchan} ch segments {segments}: "
        f"{CHAIN_CHUNKS} chunks of {CH} samples, decoded TS per channel "
        f"min {counts.min()} mean {counts.mean():.1f} (floor {floor}), "
        f"every channel in sent order after lock; byte backend "
        f"{type(rx.backend).__name__}; wall {dt:.2f} s incl. compile")
    check(counts.min() >= floor, f"chain {rate} {nchan}ch S={segments}: "
          f"a channel decoded only {counts.min()} packets")


def phase_chain():
    _print_memory_analysis()
    for cfg in CHAIN_CONFIGS:
        _chain(*cfg)


# -- phase: cli ---------------------------------------------------------------

def _run_main(main, argv, stdin_bytes):
    """Run an app's main() in this process on in-memory stdin/stdout."""
    out = io.BytesIO()
    saved = sys.stdin, sys.stdout
    sys.stdin = io.TextIOWrapper(io.BytesIO(stdin_bytes))
    sys.stdout = io.TextIOWrapper(out, write_through=True)
    try:
        rc = main(argv)
        sys.stdout.flush()
        data = out.getvalue()
    finally:
        sys.stdin, sys.stdout = saved
    check(rc == 0, f"{main.__module__}.main returned {rc}")
    return data


def phase_cli():
    import numpy as np
    from leansdr_jax.apps import leandvb, leandvbfleet
    from leansdr_jax.pipelines import dvbs_tx

    pkts = _packets(160, start=SEED * 3000)
    iq = dvbs_tx.modulate(pkts, dvbs_tx.TxConfig(rate="1/2", interp=2))
    common = ["--f32", "--float-scale", "75", "-f", "4e6", "--sr", "2e6",
              "--cr", "1/2", "--fastlock", "--viterbi"]
    t0 = time.perf_counter()
    ts = np.frombuffer(_run_main(leandvb.main, common,
                                 iq.astype(np.float32).tobytes()),
                       np.uint8).reshape(-1, 188)
    n = _check_stream(ts, _index_of(pkts), "leandvb --viterbi")
    log(f"leandvb --viterbi: {n} TS packets of {len(pkts)} sent, in "
        f"sent order ({time.perf_counter() - t0:.2f} s)")
    check(n >= 100, f"leandvb --viterbi decoded {n} packets")

    C = 3
    streams = [_packets(200, start=SEED * 5000 + 1000 * c)
               for c in range(C)]
    iqs = [dvbs_tx.modulate(p, dvbs_tx.TxConfig(rate="1/2", interp=2))
           for p in streams]
    m = min(map(len, iqs))
    frames = np.stack([q[:m] for q in iqs], axis=1).astype(np.float32)
    t0 = time.perf_counter()
    mux = _run_main(leandvbfleet.main,
                    ["--nchan", str(C)] + common + ["--chunk", "65536"],
                    frames.tobytes())
    per = [[] for _ in range(C)]
    o = 0
    while o < len(mux):
        c, k = np.frombuffer(mux[o:o + 8], "<u4")
        o += 8
        per[c].append(np.frombuffer(mux[o:o + 188 * k], np.uint8
                                    ).reshape(-1, 188))
        o += 188 * k
    for c in range(C):
        dec = np.concatenate(per[c]) if per[c] else np.empty((0, 188))
        n = _check_stream(dec, _index_of(streams[c]),
                            f"leandvbfleet ch{c}")
        check(n >= 80, f"leandvbfleet ch{c} decoded {n} packets")
    log(f"leandvbfleet --nchan {C} --viterbi: every channel TS is "
        f"its sent stream in order ({time.perf_counter() - t0:.2f} s)")


# -----------------------------------------------------------------------------

PHASES = {"kernels": phase_kernels, "chain": phase_chain, "cli": phase_cli}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,chain,cli",
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    check(all(p in PHASES for p in phases), f"unknown phase in {phases}")
    check((ROOT / "leansdr_jax").is_dir(),
          f"no leansdr_jax package next to {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))

    from leansdr_jax.util.card import require_gpu
    try:
        card = require_gpu()
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        die(str(e))
    import jax
    log(f"gpu: {card['gpu']}")
    log(f"jax {jax.__version__}, device_kind {card['kind']}, "
        f"{card['count']} device(s)")
    from leansdr_jax.util.jax_cache import cache_dir, setup_cache
    setup_cache()
    log(f"compile cache: {cache_dir()}")
    for p in phases:
        t0 = time.perf_counter()
        PHASES[p]()
        log(f"phase {p}: ok ({time.perf_counter() - t0:.1f} s)")
    print(json.dumps({"ok": True, "device": {
        k: card[k] for k in ("platform", "kind", "count")}}), flush=True)


if __name__ == "__main__":
    main()
