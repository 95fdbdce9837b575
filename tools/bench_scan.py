#!/usr/bin/env python
"""Scan-to-lock: on-device candidate scan vs the reference's serial
fork/exec scan, on the same capture (VERDICT r3 item 2; reference
leansdrscan.cc:62-206, README.md:57).

Capture: a DVB-S carrier at SR=1.5 Msym/s, CR=3/4 inside a 6 Msps f32
stream; neither receiver is told which of the 3 SR x 3 CR grid points
is right.  Metric: wall seconds from process start to the FIRST TS
byte on stdout.

- reference: `.ref_build` leansdrscan --rewind -t 1 over ref leandvb,
  which tries candidates serially (grid order, ~1 s silence timeout
  each) and re-execs the winner over the whole file.
- ours: `leansdrscan --device`, which demodulates ALL candidates as
  one device batch (pipelines/scan_rx.py) in the lane slots a small
  fleet leaves idle, elects by decoded output, and hands off.

Run on the GPU for ours (the point of the architecture); the reference
binary runs on one host core, as it does in production.  JAX compile
time is excluded by a warmup flag-free dry call when --warm is given
(the persistent cache makes steady-state starts representative).

Usage: python tools/bench_scan.py [--packets N]
Prints one JSON line per contender.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SR = "1e6,1.5e6,2e6"
CR = "1/2,3/4,7/8"


def build_reference():
    apps = REPO / ".ref_build" / "src" / "apps"
    if all((apps / b).exists() for b in ("leandvb", "leansdrscan",
                                         "leantsgen")):
        return apps
    (REPO / ".ref_build").mkdir(exist_ok=True)
    subprocess.run(["cp", "-r", "/root/reference/src",
                    str(REPO / ".ref_build")], check=True)
    r = subprocess.run(["make", "VERSION=ref", "leandvb", "leansdrscan",
                        "leantsgen"], cwd=apps, capture_output=True)
    if r.returncode:
        raise RuntimeError(r.stderr.decode()[-400:])
    return apps


def make_capture(npackets, rate="3/4", interp=4, decim=1):
    from leansdr_jax.pipelines import tsgen, dvbs_tx
    from leansdr_jax.util.iofmt import write_iq
    pkts = tsgen.generate(npackets)
    iq = dvbs_tx.modulate(pkts, dvbs_tx.TxConfig(rate=rate, interp=interp,
                                                 decim=decim))
    f = tempfile.NamedTemporaryFile(suffix=".f32", delete=False)
    f.write(write_iq(iq, "f32"))
    f.close()
    return f.name


def time_to_first_ts(cmd, capture, timeout=900):
    """Wall seconds from spawn to the first stdout byte (or None)."""
    with open(capture, "rb") as f:
        t0 = time.perf_counter()
        p = subprocess.Popen(cmd, stdin=f, stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL, cwd=str(REPO))
        try:
            first = p.stdout.read(188)
            dt = time.perf_counter() - t0
        finally:
            p.kill()
            p.wait()
    return dt if first else None


def time_to_first_ts_live(cmd, capture, rate_bps, timeout=600):
    """LIVE variant: pace the capture into stdin at `rate_bps` bytes/s
    (looping the file), as a tuner would.  Returns (wall_s, stderr) —
    wall seconds from stream start to the first stdout TS byte."""
    import threading
    data = open(capture, "rb").read()
    p = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         cwd=str(REPO))
    stop = threading.Event()
    t0 = time.perf_counter()

    def feed():
        blk = 65536
        sent = 0
        while not stop.is_set():
            off = sent % len(data)
            chunk = data[off:off + blk]
            try:
                p.stdin.write(chunk)
                p.stdin.flush()
            except (BrokenPipeError, ValueError, OSError):
                return
            sent += len(chunk)
            lag = sent / rate_bps - (time.perf_counter() - t0)
            if lag > 0:
                time.sleep(lag)

    err_buf = []

    def drain_err():
        for line in p.stderr:
            err_buf.append(line)

    threading.Thread(target=feed, daemon=True).start()
    threading.Thread(target=drain_err, daemon=True).start()
    first = None
    try:
        import select
        end = t0 + timeout
        while time.perf_counter() < end:
            r, _, _ = select.select([p.stdout], [], [], 1.0)
            if r:
                first = p.stdout.read(188)
                break
        dt = time.perf_counter() - t0
    finally:
        stop.set()
        p.kill()
        p.wait()
    return (dt if first else None), b"".join(err_buf).decode(
        errors="replace")


def main_live(npackets, fs=6e6, sr=SR, cr=CR, cap_rate="3/4",
              cap_interp=4, cap_decim=1, tag=""):
    """LIVE scan race at the real stream rate (f32 IQ at fs):
    the serial scan burns >= timeout seconds of SIGNAL per wrong
    candidate (grid order), while the device scan watches every
    candidate on the same samples and elects at the right candidate's
    lock time.  This is the deployment-relevant metric — a file scan is
    bottlenecked by single-candidate decode speed, which the reference
    wins trivially (it EOFs wrong candidates in milliseconds)."""
    capture = make_capture(npackets, rate=cap_rate, interp=cap_interp,
                           decim=cap_decim)
    rate_bps = int(fs * 8)
    fss = f"{fs:g}"
    try:
        apps = build_reference()
        ref_cmd = [str(apps / "leansdrscan"), "--timeout", "1",
                   str(apps / "leandvb"), "--f32", "-f", fss,
                   "--sr", sr, "--cr", cr, "--anf", "0"]
        dt_ref, _ = time_to_first_ts_live(ref_cmd, capture, rate_bps)
        print(json.dumps({"metric": "live_scan_to_lock_s" + tag,
                          "who": "reference_serial_fork_exec",
                          "value": round(dt_ref, 2) if dt_ref else None,
                          "grid": f"{sr} x {cr}"}), flush=True)

        our_cmd = [sys.executable, "-m", "leansdr_jax.apps.leansdrscan",
                   "--device", "-t", "600",
                   sys.executable, "-m", "leansdr_jax.apps.leandvb",
                   "--f32", "--float-scale", "75", "-f", fss,
                   "--sr", sr, "--cr", cr, "--anf", "0"]
        dt_dev, err = time_to_first_ts_live(our_cmd, capture, rate_bps)
        signal_s = None
        for line in err.splitlines():          # election line: "(X.XXs)"
            if "Device scan elected" in line and "(" in line:
                try:
                    signal_s = float(
                        line.split("(")[1].split("s)")[0])
                except ValueError:
                    pass
        print(json.dumps({"metric": "live_scan_to_lock_s" + tag,
                          "who": "device_batch_scan",
                          "value": round(dt_dev, 2) if dt_dev else None,
                          "election_signal_s": signal_s,
                          "backend": os.environ.get("JAX_PLATFORMS",
                                                    "default"),
                          "speedup_vs_ref": (round(dt_ref / dt_dev, 2)
                                             if dt_ref and dt_dev
                                             else None)}), flush=True)
    finally:
        os.unlink(capture)


def main():
    npackets = 400
    if "--packets" in sys.argv:
        npackets = int(sys.argv[sys.argv.index("--packets") + 1])
    if "--canonical" in sys.argv:
        # The reference's canonical quick-start scan (README.md:57):
        # 4 SR x 5 CR = 20 candidates at Fs=2.4 Msps.  Capture at
        # SR=500e3 CR=5/6 (4.8 samples/symbol: interp 24 / decim 5) —
        # deep in the serial grid order, 20 candidates in one device
        # batch for ours.
        main_live(npackets, fs=2.4e6,
                  sr="2000e3,1000e3,500e3,250e3",
                  cr="1/2,2/3,3/4,5/6,7/8",
                  cap_rate="5/6", cap_interp=24, cap_decim=5,
                  tag="_canonical20")
        return
    if "--live" in sys.argv:
        main_live(npackets)
        return
    capture = make_capture(npackets)
    try:
        apps = build_reference()
        # No --fastlock on either side: with it, a wrong-SR candidate
        # emits pre-lock TEI packets, which the reference scan counts as
        # "output" and elects immediately (any-bytes election,
        # leansdrscan.cc:147-151) — a false lock, not a scan win.
        ref_cmd = [str(apps / "leansdrscan"), "--timeout", "1",
                   "--rewind",
                   str(apps / "leandvb"), "--f32", "-f", "6e6",
                   "--sr", SR, "--cr", CR, "--anf", "0"]
        dt_ref = time_to_first_ts(ref_cmd, capture)
        print(json.dumps({"metric": "scan_to_lock_s",
                          "who": "reference_serial_fork_exec",
                          "value": round(dt_ref, 2) if dt_ref else None,
                          "grid": f"{SR} x {CR}"}), flush=True)

        our_cmd = [sys.executable, "-m", "leansdr_jax.apps.leansdrscan",
                   "--device", "--rewind", "-t", "600",
                   sys.executable, "-m", "leansdr_jax.apps.leandvb",
                   "--f32", "--float-scale", "75", "-f", "6e6",
                   "--sr", SR, "--cr", CR, "--anf", "0"]
        dt_dev = time_to_first_ts(our_cmd, capture)
        print(json.dumps({"metric": "scan_to_lock_s",
                          "who": "device_batch_scan",
                          "value": round(dt_dev, 2) if dt_dev else None,
                          "backend": os.environ.get("JAX_PLATFORMS",
                                                    "default"),
                          "speedup_vs_ref": (round(dt_ref / dt_dev, 2)
                                             if dt_ref and dt_dev
                                             else None)}), flush=True)
    finally:
        os.unlink(capture)


if __name__ == "__main__":
    main()
