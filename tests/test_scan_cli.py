"""CLI surface of the on-device candidate scan (leansdrscan --device,
VERDICT r3 item 2; reference leansdrscan.cc:62-206 + README.md:57):
feed a capture whose symbol rate / code rate are NOT given as a single
config, and get decoded TS with the right candidate elected.
"""

import subprocess
import sys

import numpy as np

from conftest import file_stdin
from leansdr_jax.pipelines import tsgen, dvbs_tx
from leansdr_jax.util.iofmt import write_iq


def test_device_scan_elects_and_decodes():
    # Capture at SR=1.5e6, CR=3/4 inside a 6 Msps stream; the scan grid
    # is 3 SR x 3 CR = 9 candidates, none marked as "the" config.
    pkts = tsgen.generate(260)
    iq = dvbs_tx.modulate(pkts, dvbs_tx.TxConfig(rate="3/4", interp=4))
    raw = write_iq(iq, "f32")
    cmd = [sys.executable, "-m", "leansdr_jax.apps.leansdrscan",
           "--device", "--rewind", "-t", "600",
           sys.executable, "-m", "leansdr_jax.apps.leandvb",
           "--f32", "--float-scale", "75", "-f", "6e6",
           "--sr", "1e6,1.5e6,2e6", "--cr", "1/2,3/4,7/8",
           "--anf", "0", "--fastlock"]
    with file_stdin(raw) as f:
        r = subprocess.run(cmd, stdin=f, capture_output=True,
                           timeout=1800)
    assert r.returncode == 0, r.stderr[-500:]
    assert b"--sr 1.5e+06 --cr 3/4" in r.stderr, r.stderr[-500:]
    ts = np.frombuffer(r.stdout, np.uint8)
    assert len(ts) % 188 == 0 and len(ts) >= 150 * 188
    ts = ts.reshape(-1, 188)
    assert (ts[:, 0] == 0x47).all()
    # Payload check: decoded packets are real TX packets (skip the
    # first few — pre-lock transients may carry TEI-marked packets).
    hits = sum(bool(np.where((pkts == p).all(axis=1))[0].size)
               for p in ts[3:23])
    assert hits >= 18


def test_device_scan_live_inprocess_handoff():
    """Without --rewind (live mode) the device scan must elect and then
    CONTINUE in-process (scan_rx.focus) — no exec, no restart — and the
    output must include packets decoded during the scan itself."""
    pkts = tsgen.generate(260)
    iq = dvbs_tx.modulate(pkts, dvbs_tx.TxConfig(rate="3/4", interp=4))
    raw = write_iq(iq, "f32")
    cmd = [sys.executable, "-m", "leansdr_jax.apps.leansdrscan",
           "--device", "-t", "600",
           sys.executable, "-m", "leansdr_jax.apps.leandvb",
           "--f32", "--float-scale", "75", "-f", "6e6",
           "--sr", "1e6,1.5e6", "--cr", "1/2,3/4",
           "--anf", "0", "--fastlock"]
    r = subprocess.run(cmd, input=raw, capture_output=True, timeout=1800)
    assert r.returncode == 0, r.stderr[-500:]
    assert b"continuing in-process" in r.stderr, r.stderr[-500:]
    ts = np.frombuffer(r.stdout, np.uint8)
    assert len(ts) % 188 == 0 and len(ts) >= 150 * 188, len(ts) // 188
    ts = ts.reshape(-1, 188)
    assert (ts[:, 0] == 0x47).all()
    hits = sum(bool(np.where((pkts == p).all(axis=1))[0].size)
               for p in ts[3:23])
    assert hits >= 18


def test_device_scan_rejects_other_sweeps():
    r = subprocess.run(
        [sys.executable, "-m", "leansdr_jax.apps.leansdrscan",
         "--device", "cat", "--foo", "a,b"],
        input=b"", capture_output=True)
    assert r.returncode == 1
    assert b"--sr" in r.stderr or b"not supported" in r.stderr
