"""Multi-host (DCN) path: 2 JAX processes, one global mesh, collectives
crossing process boundaries (SURVEY.md section 5.8's "DCN for multi-host
batch distribution").

Runs tools/dcn_demo.py as a subprocess pair: each process owns 4 virtual
CPU devices, jax.distributed forms the 8-device global mesh, and the
sharded fleet demod step's psum/pmean reductions must agree across
processes on a real DVB-S signal.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_two_process_mesh_demod():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)         # workers set their own device count
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, str(REPO / "tools" / "dcn_demo.py")],
        capture_output=True, text=True, timeout=900, env=env,
        cwd=str(REPO))
    assert r.returncode == 0, r.stdout + r.stderr
    lines = [json.loads(l) for l in r.stdout.splitlines()
             if l.startswith("{")]
    assert len(lines) == 2
    for res in lines:
        assert res["processes"] == 2
        assert res["global_devices"] == 8
        assert res["fleet_symbols_psum"] > 0
        assert res["fleet_mer_pmean_db"] > 9.0   # demodulating, not noise
        # Stage 2: the production fleet decode with per-host ingest and
        # per-host native byte backends produced payload-verified TS.
        assert res["fleet_decode_backend"] == "NativeByteBackend"
        assert res["fleet_ts_decoded"] >= 64
        assert res["fleet_ts_verified"] >= 32
        assert res["fleet_aggregate_msps_cpu"] > 0
    assert lines[0]["fleet_symbols_psum"] == lines[1]["fleet_symbols_psum"]
    assert lines[0]["fleet_ts_decoded"] == lines[1]["fleet_ts_decoded"]
