#!/usr/bin/env python
"""Hand-written kernels vs the plain versions XLA compiles, on the card.

  demod    dsp/receiver_pallas.demod_pallas vs receiver.run_chunks
           (exact_lut=False) at 64 lanes x 2^18 samples (64 channels,
           one chunk) and 1024 lanes x 2^15 samples (128 channels x 8
           segments).
  acs      fec/viterbi_acs.viterbi_acs vs fec/viterbi._viterbi_chunk_
           device (the XLA scan behind viterbi_decode_xla) at 64
           channels x all sync replicas, rates 1/2, 3/4, 7/8; seconds
           per trellis block and per 2^18-sample chunk.
  chain    MultiDvbsReceiver, 64 channels rate 1/2 segments 1 (chunk
           2^18), with each of the four demod x ACS choices of kernel or
           plain version.
  fir/fft  the RRC banded-matmul FIR (dsp/fir_mxu.py) and 4096-point
           fft_planes, as fractions of the card's HBM peak.

Every line is one JSON object naming the card and its power limit.
Times are wall time around calls that end in block_until_ready, after
a warm-up call (compile excluded); the median of the timed calls.

  tune     lane-block / warp-count sweep of both kernels.

Usage: python tools/bench_kernels.py [demod,acs,chain,fir,fft,tune]
"""

import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CH = 1 << 18
CARD = None          # require_gpu() of the card measured
HBM_PEAK = None      # its HBM bytes/s (util/card.py)


def emit(rec):
    print(json.dumps({"gpu": CARD["gpu"], "kind": CARD["kind"], **rec}),
          flush=True)


def timed(fn, reps=5):
    """Median seconds per call of fn() (which blocks), after a warm-up."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _demod_inputs(nlanes, nsamp):
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    # A noisy QPSK-like stream at the AGC set point: the recurrence's
    # cost does not depend on the data.
    sym = rng.integers(0, 2, (nlanes, nsamp // 2 + 1, 2)) * 2 - 1
    x = np.repeat(sym, 2, axis=1)[:, :nsamp + 1] * 53.0
    x = x + rng.normal(scale=5.0, size=x.shape)
    return jnp.asarray(x.astype(np.float32))


def bench_demod():
    import jax
    from leansdr_jax.dsp import receiver, receiver_pallas as rp
    from leansdr_jax.dsp.cstln import Predef, make_dvbs2_constellation

    cstln = make_dvbs2_constellation(Predef.QPSK, "1/2")
    params = receiver.ReceiverParams(omega=2.0, sampler="linear",
                                     nsymbols=4, exact_lut=False)
    sc = rp.sym_constants(cstln)
    tables = receiver.make_tables(cstln)
    for nlanes, nsamp in ((64, CH), (1024, CH // 8)):
        x = _demod_inputs(nlanes, nsamp)
        st = receiver.init_state(params, nlanes)
        planes = rp.pack_state(st)
        t_k = timed(lambda: jax.block_until_ready(
            rp.demod_pallas(params, sc, planes, x)))
        t_x = timed(lambda: jax.block_until_ready(
            receiver.run_chunks(params, tables, st, x)), reps=3)
        emit({"kernel": "demod", "lanes": nlanes, "samples": nsamp,
              "kernel_s": t_k, "plain_s": t_x,
              "kernel_msps": nlanes * nsamp / t_k / 1e6,
              "plain_msps": nlanes * nsamp / t_x / 1e6})


def bench_acs():
    import jax
    import jax.numpy as jnp
    from leansdr_jax.dsp.cstln import Predef, make_dvbs2_constellation
    from leansdr_jax.fec import viterbi as vit
    from leansdr_jax.fec.viterbi_acs import viterbi_acs

    C, T = 64, 8192
    for rate in ("1/2", "3/4", "7/8"):
        cstln = make_dvbs2_constellation(Predef.QPSK, rate)
        _, nconj, nrot, nshifts = vit.make_sync_maps(cstln, rate)
        t = vit.make_trellis(rate)
        rng = np.random.default_rng(1)
        blocks_per_chunk = CH // 2 // nshifts
        for track in (False, True):
            N = C if track else C * nconj * nrot * nshifts
            cs = jnp.asarray(rng.integers(0, t.ncs, (T, N)), jnp.int32)
            cost = jnp.asarray(-rng.integers(0, 300, (T, N)), jnp.int32)
            z = jnp.zeros((N, 64), jnp.int32)
            t_k = timed(lambda: jax.block_until_ready(viterbi_acs(
                rate, z, z, z, cs, cost, cheap_q=track)))
            rec = {"kernel": "viterbi_acs", "rate": rate, "lanes": N,
                   "mode": "track" if track else "acquire", "blocks": T,
                   "kernel_s": t_k,
                   "kernel_ms_per_chunk": t_k / T * blocks_per_chunk * 1e3}
            if not track:
                # The XLA scan has no TRACK mode.
                zu = jnp.zeros((N, 64), jnp.uint32)
                t_x = timed(lambda: jax.block_until_ready(
                    vit._viterbi_chunk_device(rate, z, zu, zu, cs.T,
                                              cost.T)), reps=3)
                rec.update(plain_s=t_x, plain_ms_per_chunk=(
                    t_x / T * blocks_per_chunk * 1e3))
            emit(rec)


def bench_chain(nchunks=3):
    import jax
    from leansdr_jax.pipelines import tsgen
    from leansdr_jax.pipelines.dvbs_rx import RxConfig
    from leansdr_jax.pipelines.dvbs_tx_device import device_stimulus
    from leansdr_jax.pipelines.multi_rx import MultiDvbsReceiver

    C = 64
    warm = 4                  # compile, lock, TRACK mode (as bench.py)
    y = device_stimulus(tsgen.generate((nchunks + warm + 1) * CH // 3264
                                       + 40))
    for demod_k, acs_k in ((True, True), (True, False), (False, True),
                           (False, False)):
        rx = MultiDvbsReceiver(
            RxConfig(Fs=4e6, Fm=2e6, rate="1/2", fastlock=True,
                     float_scale=75.0, exact_lut=False, viterbi=True,
                     sampler="rrc"), C, chunk_samples=CH,
            use_pallas=demod_k, acs_kernel=acs_k)
        ra = rx.params.readahead + len(rx.mf_taps) - 1
        wins = [jax.numpy.broadcast_to(y[k * CH:k * CH + CH + ra][None],
                                       (C, CH + ra, 2)) + 0.0
                for k in range(nchunks + warm)]
        for w in wins[:warm]:
            rx.process(w)
        npk, ts = 0, []
        for w in wins[warm:]:
            t0 = time.perf_counter()
            npk += sum(len(o) for o in rx.process(w))
            ts.append(time.perf_counter() - t0)
        # Median: a decode-schedule or TRACK change in a timed chunk
        # compiles a new decode program.
        dt = statistics.median(ts)
        emit({"chain": "64ch rate 1/2 segments 1",
              "demod": "kernel" if demod_k else "plain",
              "acs": "kernel" if acs_k else "plain",
              "s_per_chunk": dt, "msps": C * CH / dt / 1e6,
              "ts_packets": npk})


def bench_fir():
    import jax
    import jax.numpy as jnp
    from leansdr_jax.dsp import filtergen
    from leansdr_jax.dsp.fir_mxu import fir_mxu

    # 64-channel RRC matched filter, the chain's preprocessing shape.
    C, n = 64, CH
    taps = tuple(float(v) for v in
                 filtergen.root_raised_cosine(64, 0.25, 0.35))
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(C * 2, n)).astype(np.float32))
    f = jax.jit(lambda a: fir_mxu(a, taps, precision="highest"))
    dt = timed(lambda: jax.block_until_ready(f(x)))
    moved = 2 * C * 2 * n * 4
    emit({"kernel": "rrc_fir_mxu", "s": dt, "gbps": moved / dt / 1e9,
          "hbm_fraction": moved / dt / HBM_PEAK})


def bench_fft():
    import jax
    import jax.numpy as jnp
    from leansdr_jax.dsp.fft import fft_planes

    B, N = 1024, 4096
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(2, B, N)).astype(np.float32))
    f = jax.jit(lambda a: fft_planes(a[0], a[1], N))
    dt = timed(lambda: jax.block_until_ready(f(x)))
    moved = 2 * B * N * 8
    emit({"kernel": "fft4096", "s": dt, "gbps": moved / dt / 1e9,
          "hbm_fraction": moved / dt / HBM_PEAK})


def bench_tune():
    """Lane-block and warp-count sweep of both kernels (kernel time at
    the chain widths; the same inputs as bench_demod / bench_acs)."""
    import jax
    import jax.numpy as jnp
    from leansdr_jax.dsp import receiver, receiver_pallas as rp
    from leansdr_jax.dsp.cstln import Predef, make_dvbs2_constellation
    from leansdr_jax.fec import viterbi as vit
    from leansdr_jax.fec.viterbi_acs import viterbi_acs

    cstln = make_dvbs2_constellation(Predef.QPSK, "1/2")
    params = receiver.ReceiverParams(omega=2.0, sampler="linear",
                                     nsymbols=4, exact_lut=False)
    sc = rp.sym_constants(cstln)
    for nlanes, nsamp in ((64, CH), (1024, CH // 8)):
        x = _demod_inputs(nlanes, nsamp)
        planes = rp.pack_state(receiver.init_state(params, nlanes))
        for lb in (16, 32, 64):
            t = timed(lambda: jax.block_until_ready(rp.demod_pallas(
                params, sc, planes, x, lane_block=lb)), reps=3)
            emit({"tune": "demod", "lanes": nlanes, "lane_block": lb,
                  "s": t})
    T = 8192
    for rate in ("1/2", "3/4", "7/8"):
        cstln = make_dvbs2_constellation(Predef.QPSK, rate)
        _, nconj, nrot, nshifts = vit.make_sync_maps(cstln, rate)
        t = vit.make_trellis(rate)
        rng = np.random.default_rng(1)
        for track in (False, True):
            N = 64 if track else 64 * nconj * nrot * nshifts
            cs = jnp.asarray(rng.integers(0, t.ncs, (T, N)), jnp.int32)
            cost = jnp.asarray(-rng.integers(0, 300, (T, N)), jnp.int32)
            z = jnp.zeros((N, 64), jnp.int32)
            for lb, nw in ((4, 1), (4, 2), (8, 2), (8, 4), (16, 4),
                           (32, 8)):
                dt = timed(lambda: jax.block_until_ready(viterbi_acs(
                    rate, z, z, z, cs, cost, cheap_q=track,
                    lane_block=lb, num_warps=nw)), reps=3)
                emit({"tune": "acs", "rate": rate, "lanes": N,
                      "mode": "track" if track else "acquire",
                      "lane_block": lb, "num_warps": nw,
                      "us_per_block": dt / T * 1e6})


BENCHES = {"demod": bench_demod, "acs": bench_acs, "chain": bench_chain,
           "fir": bench_fir, "fft": bench_fft, "tune": bench_tune}


def main():
    global CARD, HBM_PEAK
    from leansdr_jax.util.card import peaks, require_gpu
    from leansdr_jax.util.jax_cache import setup_cache
    CARD = require_gpu()
    HBM_PEAK = peaks(CARD["kind"])["hbm_bytes_per_s"]
    setup_cache()
    which = sys.argv[1].split(",") if len(sys.argv) > 1 else list(BENCHES)
    for b in which:
        BENCHES[b]()


if __name__ == "__main__":
    main()
