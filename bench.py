"""Chain benchmark on one GPU.

Cells (the fleet shapes: Fs 4e6, Fm 2e6, QPSK, RRC matched filter,
soft-decision Viterbi with sync-hypothesis replicas, fastlock, chunk
2^18 samples per channel):

  chain12_64ch_s1   64 channels, rate 1/2, sequential demod
  chain12_64ch_s8   64 channels, rate 1/2, 8 time segments
  chain34_64ch_s8   64 channels, rate 3/4, 8 time segments
  chain78_64ch_s8   64 channels, rate 7/8, 8 time segments
  fleet128_s8       128 channels, rate 1/2, 8 segments (1024 lanes)
  demod_peak        the demod kernel alone at 1024 lanes x 2^15
  rrc_fir, fft4096  HBM fractions (tools/bench_kernels.py)

Per chain cell, after warm-up chunks (compile, lock, TRACK mode):
  device_msps   channels x samples / wall time of one chunk's fused
                device program (dispatch .. block_until_ready)
  e2e_msps      the same through process(): device program, fetch and
                the host byte backend
  realtime_x    e2e_msps over the fleet's input rate (nchan x 4 Msps)

Every line is one JSON object naming the card and its power limit; the
last line sums up. Any failure ends the run with a non-zero exit.
"""

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

CH = 1 << 18
FS = 4e6
CELLS = (("chain12_64ch_s1", "1/2", 64, 1),
         ("chain12_64ch_s8", "1/2", 64, 8),
         ("chain34_64ch_s8", "3/4", 64, 8),
         ("chain78_64ch_s8", "7/8", 64, 8),
         ("fleet128_s8", "1/2", 128, 8))
WARM, TIMED = 4, 3


def chain_cell(rate, nchan, segments):
    import jax
    import jax.numpy as jnp
    from leansdr_jax.pipelines import tsgen
    from leansdr_jax.pipelines.dvbs_rx import RxConfig
    from leansdr_jax.pipelines.dvbs_tx_device import device_stimulus
    from leansdr_jax.pipelines.multi_rx import MultiDvbsReceiver

    num, den = (int(v) for v in rate.split("/"))
    spp = 1632 * den // num            # samples per RS packet
    nwin = WARM + 2 * TIMED
    y = device_stimulus(tsgen.generate((nwin + 1) * CH // spp + 40),
                        rate=rate)
    rx = MultiDvbsReceiver(
        RxConfig(Fs=FS, Fm=2e6, rate=rate, fastlock=True, float_scale=75.0,
                 exact_lut=False, viterbi=True, sampler="rrc"),
        nchan, chunk_samples=CH, segments=segments, seg_holdoff=2)
    assert rx.use_pallas and rx.deconv.kind == "viterbi_acs"
    ra = rx.params.readahead + len(rx.mf_taps) - 1
    wins = [jnp.broadcast_to(y[k * CH:k * CH + CH + ra][None],
                             (nchan, CH + ra, 2)) + 0.0
            for k in range(nwin)]
    npk = 0
    for w in wins[:WARM]:
        npk = sum(len(o) for o in rx.process(w))
    assert npk > 0, "no TS after the warm-up chunks"
    dev = []
    for w in wins[WARM:WARM + TIMED]:
        t0 = time.perf_counter()
        pend = rx.dispatch(w)
        jax.block_until_ready(pend[0])
        dev.append(time.perf_counter() - t0)
        rx.collect(pend)
    e2e = []
    for w in wins[WARM + TIMED:]:
        t0 = time.perf_counter()
        rx.process(w)
        e2e.append(time.perf_counter() - t0)
    d, e = statistics.median(dev), statistics.median(e2e)
    return {"device_msps": nchan * CH / d / 1e6,
            "e2e_msps": nchan * CH / e / 1e6,
            "realtime_x": nchan * CH / e / (nchan * FS),
            "device_s_per_chunk": d, "e2e_s_per_chunk": e,
            "track": bool(rx.deconv.track)}


def demod_peak():
    import jax
    import bench_kernels as bk
    from leansdr_jax.dsp import receiver, receiver_pallas as rp
    from leansdr_jax.dsp.cstln import Predef, make_dvbs2_constellation

    nlanes, nsamp = 1024, CH // 8
    params = receiver.ReceiverParams(omega=2.0, sampler="linear",
                                     nsymbols=4, exact_lut=False)
    sc = rp.sym_constants(make_dvbs2_constellation(Predef.QPSK, "1/2"))
    x = bk._demod_inputs(nlanes, nsamp)
    planes = rp.pack_state(receiver.init_state(params, nlanes))
    t = bk.timed(lambda: jax.block_until_ready(
        rp.demod_pallas(params, sc, planes, x)))
    return {"msps": nlanes * nsamp / t / 1e6, "s": t}


def main():
    from leansdr_jax.util.card import peaks, require_gpu
    from leansdr_jax.util.jax_cache import setup_cache
    import bench_kernels as bk

    card = require_gpu()
    hbm = peaks(card["kind"])["hbm_bytes_per_s"]
    setup_cache()
    bk.CARD, bk.HBM_PEAK = card, hbm
    head = {"gpu": card["gpu"], "kind": card["kind"]}

    out = {}
    for name, rate, nchan, seg in CELLS:
        r = chain_cell(rate, nchan, seg)
        out[name] = r
        print(json.dumps({**head, "cell": name, **r}), flush=True)
    out["demod_peak"] = demod_peak()
    print(json.dumps({**head, "cell": "demod_peak", **out["demod_peak"]}),
          flush=True)
    bk.bench_fir()
    bk.bench_fft()
    print(json.dumps({
        **head, "metric": "rx_chain_e2e_msps",
        **{k: round(v["e2e_msps"], 1) for k, v in out.items()
           if "e2e_msps" in v},
        "demod_peak_msps": round(out["demod_peak"]["msps"], 1)}),
        flush=True)


if __name__ == "__main__":
    main()
