#!/usr/bin/env python
"""VBER-vs-SNR sensitivity harness (the leandvb_bench.sh equivalent,
reference test/leandvb_bench.sh:18-134).

Runs tsgen -> tx(--agc) -> chansim(awgn, deterministic) -> RX in-process
for a series of (sampling ratio, SNR) points, parses lock/VBER like the
shell harness (success = LOCKTIME >= 1000 packets), and appends rows
  commit platform sampling_ratio RXSNR CNR SS MER VBERMIN VBERMAX
to leandvb_bench_results.txt. The DVB-S acceptance bound is VBER 2e-4 at
Eb/N0 4.5 dB (leandvb_bench.gnuplot:20-21).

Usage: python tools/bench_vber.py [series ...] [--ref] [--npackets N]
  --ref runs the reference leandvb binary instead of our receiver
  (requires .ref_build).
"""

import argparse
import os
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# The reference's series grid (test/leandvb_bench.sh:119-134).
SERIES = {
    "1.2sps-hs": ("6/5", [20, 18, 16, 14, 12, 11, 10], {"hs": True}),
    "2.4sps-hs": ("12/5", [20, 18, 16, 14, 12, 10], {"hs": True}),
    "4.2sps-hs": ("21/5", [20, 18, 16, 14, 12, 10], {"hs": True}),
    "1.2sps": ("6/5", [22, 21, 20, 19, 18, 17, 16, 15], {}),
    "4sps-viterbi-rrc": ("4", [6.5, 6.0, 5.5, 5.0, 4.5],
                         {"viterbi": True, "sampler": "rrc"}),
    "4.2sps": ("21/5", [20, 19, 18, 17, 16, 15, 14], {}),
    "8.2sps": ("41/5", [21, 20, 19, 18], {}),
    "4.2sps-rrc": ("21/5", [16, 15, 14, 13, 12, 11, 10],
                   {"sampler": "rrc"}),
    "1.2sps-viterbi": ("6/5", [12, 11, 10.5, 10, 9.5, 9, 8.5],
                       {"viterbi": True}),
    "1.2sps-viterbi-rrc": ("6/5", [10, 9, 8.5, 8, 7, 6, 5, 4],
                           {"viterbi": True, "sampler": "rrc"}),
    "2.4sps-viterbi-rrc": ("12/5", [8, 7, 6, 5.8, 5.6, 5.4, 5.2, 5.0,
                                    4.8],
                           {"viterbi": True, "sampler": "rrc"}),
    "4.2sps-viterbi-rrc": ("21/5", [6, 5, 4.8, 4.6, 4.5, 4.4, 4.3, 4.2,
                                    4.0, 3.8],
                           {"viterbi": True, "sampler": "rrc"}),
    "8sps-viterbi-rrc": ("8", [6, 5, 4.8, 4.6, 4.5, 4.4, 4.3, 4.2,
                               4.0, 3.8],
                         {"viterbi": True, "sampler": "rrc"}),
    "32sps-viterbi-rrc": ("32", [6, 5, 4.8, 4.6, 4.5, 4.4, 4.3, 4.2,
                                 4.0, 3.8],
                          {"viterbi": True, "sampler": "rrc"}),
    "satmodem4200-60sps": ("60", [6, 5.2, 5, 4.8, 4.6, 4.4, 4.2, 4.0,
                                  3.8],
                           {"viterbi": True, "sampler": "rrc"}),
}


def run_point(ratio: str, snrtarget: float, opts: dict,
              npackets=3000, minpackets=1000, use_ref=False, seed=None):
    from leansdr_jax.pipelines import tsgen, dvbs_tx, chansim
    from leansdr_jax.pipelines.dvbs_rx import DvbsReceiver, RxConfig
    from leansdr_jax.util.iofmt import write_iq, read_iq

    symbrate = 1e6
    r = Fraction(ratio)
    samprate = symbrate * r.numerator / r.denominator
    hs = opts.get("hs", False)
    if hs:
        # u8/--hs mode: gain set so the u8 modulation amplitude matches
        # cstln_amp=75 (leandvb_bench.sh:27-31): sigpow 37.5 dB, noise
        # floor moves instead.
        sigpow = 37.5
        noisepow = sigpow - snrtarget
        float_scale = 0.0
    else:
        sigpow = snrtarget          # dB; fixed noise floor at 0 dB
        noisepow = 0.0
        float_scale = 10 * np.sqrt(float(r))

    pkts = tsgen.generate(npackets)
    txcfg = dvbs_tx.TxConfig(
        amp=dvbs_tx.power_to_amp(sigpow), agc=True,
        interp=r.numerator, decim=r.denominator)
    iq = dvbs_tx.modulate(pkts, txcfg)
    ch = chansim.ChansimConfig(
        awgn=float(np.exp(np.log(10) * noisepow / 20)),
        deterministic=True, seed=seed)
    iq = chansim.simulate(iq, ch)
    if hs:
        # u8 on the wire (leanchansim --ou8): quantize and re-center.
        iq = read_iq(write_iq(iq, "u8"), "u8")

    if use_ref:
        return _run_ref_point(iq, samprate, symbrate, float_scale, opts,
                              minpackets)

    cfg = RxConfig(Fs=samprate, Fm=symbrate, rate="1/2",
                   float_scale=(1.0 if hs else float_scale), anf=0,
                   cnr=(not hs) and samprate > 3 * symbrate,
                   fastlock=False, **opts)
    rx = DvbsReceiver(cfg)
    CH = 1 << 17
    vber_samples = []
    locktime_max = 0
    for i in range(0, len(iq), CH):
        rx.process(iq[i:i + CH])
        locktime_max = max(locktime_max, rx.locktime)
        if rx.vbitcount >= 50000:
            vber_samples.append(rx.vber)
        if rx.locktime >= minpackets:
            break
    if rx.locktime < minpackets:
        return {"locktime_max": locktime_max} if locktime_max else None
    vber_samples = vber_samples or [rx.vber]
    return {
        "cnr": rx.meas["cnr"][-1] if rx.meas["cnr"] else 0.0,
        "ss": rx.meas["ss"][-1] if rx.meas["ss"] else 0.0,
        "mer": rx.meas["mer"][-1] if rx.meas["mer"] else 0.0,
        "vbermin": min(vber_samples),
        "vbermax": max(vber_samples),
        "locktime_max": locktime_max,
    }


def run_qef_point(ratio: str, snrtarget: float, opts: dict,
                  npackets=20000, use_ref=False, seed=None):
    """QEF-bound measurement (VERDICT r4 item 3): process the WHOLE
    capture (no early stop) and report the cumulative VBER =
    total corrected+uncorrected bits / total bits through the Viterbi
    output — enough statistics at npackets>=20k (3e7 bits) to resolve
    the DVB-S QEF criterion VBER <= 2e-4 with thousands of error
    events (leandvb_bench.gnuplot:20-21,40).  `segments` in opts routes
    the segmented receiver (threshold parity check)."""
    from leansdr_jax.pipelines import tsgen, dvbs_tx, chansim
    from leansdr_jax.pipelines.dvbs_rx import DvbsReceiver, RxConfig
    from leansdr_jax.util.iofmt import write_iq

    symbrate = 1e6
    r = Fraction(ratio)
    samprate = symbrate * r.numerator / r.denominator
    sigpow = snrtarget
    float_scale = 10 * np.sqrt(float(r))
    pkts = tsgen.generate(npackets)
    txcfg = dvbs_tx.TxConfig(
        amp=dvbs_tx.power_to_amp(sigpow), agc=True,
        interp=r.numerator, decim=r.denominator)
    iq = dvbs_tx.modulate(pkts, txcfg)
    ch = chansim.ChansimConfig(awgn=1.0, deterministic=True, seed=seed)
    iq = chansim.simulate(iq, ch)

    if use_ref:
        ref = Path(__file__).resolve().parent.parent \
            / ".ref_build/src/apps"
        flags = []
        if opts.get("viterbi"):
            flags.append("--viterbi")
        if opts.get("sampler"):
            flags += ["--sampler", opts["sampler"]]
        cmd = [str(ref / "leandvb"), "--f32", "--float-scale",
               str(float_scale), "-f", str(samprate), "--sr",
               str(symbrate), "--anf", "0", "--fd-info", "2"] + flags
        p = subprocess.run(cmd, input=write_iq(iq, "f32"),
                           capture_output=True)
        vbers, locktime = [], 0
        for line in p.stderr.decode(errors="replace").splitlines():
            parts = line.split()
            if len(parts) != 2:
                continue
            if parts[0] == "VBER":
                vbers.append(float(parts[1]))
            elif parts[0] == "LOCKTIME":
                locktime = max(locktime, int(parts[1]))
        # The reference's VBER stream is equal-size windows (>=50k bits,
        # generic.h:272-305): the unweighted mean over windows IS the
        # cumulative rate over the measured span.
        return {"locked": locktime >= 1000, "locktime": locktime,
                "vber": float(np.mean(vbers)) if vbers else None,
                "nwindows": len(vbers),
                "ts_packets": len(p.stdout) // 188}

    rxopts = dict(opts)
    segments = rxopts.pop("segments", 1)
    cfg = RxConfig(Fs=samprate, Fm=symbrate, rate="1/2",
                   float_scale=float_scale, anf=0, cnr=False,
                   fastlock=False, segments=segments, **rxopts)
    rx = DvbsReceiver(cfg)
    CH = 1 << 17
    locktime = 0
    npk = 0
    for i in range(0, len(iq), CH):
        npk += len(rx.process(iq[i:i + CH]))
        locktime = max(locktime, rx.locktime)
    return {"locked": locktime >= 1000, "locktime": locktime,
            "vber": (rx.verrcount / rx.vbitcount
                     if rx.vbitcount else None),
            "nbits": int(rx.vbitcount), "ts_packets": npk}


def _run_ref_point(iq, samprate, symbrate, float_scale, opts, minpackets):
    from leansdr_jax.util.iofmt import write_iq
    ref = Path(__file__).resolve().parent.parent / ".ref_build/src/apps"
    flags = []
    if opts.get("viterbi"):
        flags.append("--viterbi")
    if opts.get("sampler"):
        flags += ["--sampler", opts["sampler"]]
    hs = opts.get("hs", False)
    if hs:
        flags += ["--u8", "--hs"]
    cmd = [str(ref / "leandvb"), "--f32", "--float-scale", str(float_scale),
           "-f", str(samprate), "--sr", str(symbrate), "--anf", "0",
           "--fd-info", "2"] + flags
    p = subprocess.run(cmd, input=write_iq(iq, "u8" if hs else "f32"),
                       capture_output=True)
    state = {"cnr": 0.0, "ss": 0.0, "mer": 0.0,
             "vbermin": 1e9, "vbermax": 0.0, "locktime_max": 0}
    success = False
    for line in p.stderr.decode(errors="replace").splitlines():
        parts = line.split()
        if len(parts) != 2:
            continue
        tag, arg = parts
        if tag == "VBER":
            v = float(arg)
            state["vbermin"] = min(state["vbermin"], v)
            state["vbermax"] = max(state["vbermax"], v)
        elif tag in ("CNR", "SS", "MER"):
            state[tag.lower()] = float(arg)
        elif tag == "LOCKTIME":
            state["locktime_max"] = max(state["locktime_max"], int(arg))
            if int(arg) >= minpackets:
                success = True
    if state["vbermin"] > 1e8:      # locked but no VBER lines parsed
        success = False
    if not success:
        return ({"locktime_max": state["locktime_max"]}
                if state["locktime_max"] else None)
    return state


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("series", nargs="*", default=[])
    ap.add_argument("--ref", action="store_true")
    ap.add_argument("--npackets", type=int, default=3000)
    ap.add_argument("--snr", type=float, default=None,
                    help="run only this SNR point")
    ap.add_argument("--seed", type=int, default=None,
                    help="srand48-style noise seed (default: the "
                         "reference's --deterministic stream)")
    ap.add_argument("--out", default="leandvb_bench_results.txt")
    ap.add_argument("--qef", action="store_true",
                    help="QEF-bound mode: full-capture cumulative VBER "
                         "at the given --snr (default grid 4.5/5.0), "
                         "npackets>=20000 recommended")
    ap.add_argument("--segments", type=int, default=1,
                    help="QEF mode: run the segmented receiver")
    ap.add_argument("--seg-warmup", type=int, default=None,
                    help="segmented precursor window (samples)")
    args = ap.parse_args()

    if args.qef:
        commit = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True).stdout.strip()
        platform = "ref_leandvb" if args.ref else "leansdr_jax"
        if args.segments > 1:
            platform += f"-seg{args.segments}"
        sel = args.series or ["4.2sps-viterbi-rrc"]
        rows = []
        for name in sel:
            ratio, _, opts = SERIES[name]
            if args.segments > 1:
                opts = dict(opts, segments=args.segments)
            snrs = [args.snr] if args.snr is not None else [4.5, 5.0]
            for snr in snrs:
                r = run_qef_point(ratio, snr, opts,
                                  npackets=args.npackets,
                                  use_ref=args.ref, seed=args.seed)
                verdict = ("PASS" if r["locked"] and r["vber"] is not None
                           and r["vber"] <= 2e-4 else "FAIL")
                row = (f"# QEF git:{commit} {platform} {name} "
                       f"snr={snr} seed={args.seed} "
                       f"locked={r['locked']} locktime={r['locktime']} "
                       f"vber={r['vber']} "
                       f"n={r.get('nbits', r.get('nwindows'))} "
                       f"ts={r['ts_packets']} -> {verdict}")
                print(row)
                rows.append(row)
        with open(args.out, "a") as f:
            f.write("\n".join(rows) + "\n")
        return

    sel = args.series or list(SERIES)
    rows = ["# commit platform sampling_ratio RXSNR CNR SS MER "
            "VBERMIN VBERMAX"]
    commit = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                            capture_output=True, text=True).stdout.strip()
    platform = "ref_leandvb" if args.ref else "leansdr_jax"
    if args.segments > 1 and not args.ref:
        platform += f"-seg{args.segments}"
    seedtag = "" if args.seed is None else f" seed={args.seed}"
    for name in sel:
        ratio, snrs, opts = SERIES[name]
        if args.segments > 1 and not args.ref:
            opts = dict(opts, segments=args.segments)
            if args.seg_warmup:
                opts["seg_warmup"] = args.seg_warmup
        rows.append(f"\n# {name}.{seedtag}")
        for snr in snrs:
            if args.snr is not None and abs(snr - args.snr) > 1e-9:
                continue
            r = run_point(ratio, snr, opts, npackets=args.npackets,
                          use_ref=args.ref, seed=args.seed)
            if r is None or "vbermin" not in r:
                lt = (r or {}).get("locktime_max", 0)
                msg = (f"{name} snr={snr}{seedtag}: no lock"
                       f" (max continuous locktime {lt} packets)")
                print(msg)
                rows.append(f"# {platform} {float(Fraction(ratio)):.2f} "
                            f"{snr:.2f}{seedtag} NOLOCK locktime_max={lt}")
                continue
            row = (f"git:{commit} {platform} {float(Fraction(ratio)):.2f} "
                   f"{snr:.2f}{seedtag} {r['cnr']} {r['ss']} {r['mer']} "
                   f"{r['vbermin']:.2e} {r['vbermax']:.2e}")
            print(row)
            rows.append(row)
    with open(args.out, "a") as f:          # append: accumulate runs
        f.write("\n".join(rows) + "\n")


if __name__ == "__main__":
    main()
