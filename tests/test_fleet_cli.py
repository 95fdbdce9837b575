"""End-to-end drive of the leandvbfleet CLI: N interleaved carriers in,
tagged TS multiplex out (the north-star fleet shape as a product
surface)."""

import struct
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def test_fleet_cli_decodes_all_channels(tmp_path):
    from leansdr_jax.pipelines import tsgen, dvbs_tx

    nchan = 3
    payloads, iqs = [], []
    for c in range(nchan):
        pkts = tsgen.generate(120, start=500 * c)
        payloads.append(pkts)
        iqs.append(dvbs_tx.modulate(
            pkts, dvbs_tx.TxConfig(rate="1/2", interp=2)))
    n = min(len(q) for q in iqs)
    x = np.stack([q[:n] for q in iqs])               # [C, n, 2]
    frames = x.transpose(1, 0, 2).astype(np.float32)  # [n, C, 2]

    r = subprocess.run(
        [sys.executable, "-m", "leansdr_jax.apps.leandvbfleet",
         "--nchan", str(nchan), "--f32", "--float-scale", "75",
         "-f", "4e6", "--sr", "2e6", "--cr", "1/2", "--fastlock",
         "--chunk", "16384"],
        input=frames.tobytes(), capture_output=True, timeout=900,
        cwd=str(REPO))
    assert r.returncode == 0, r.stderr.decode()[-2000:]

    # parse the multiplex
    buf = r.stdout
    got = [[] for _ in range(nchan)]
    o = 0
    while o < len(buf):
        c, k = struct.unpack_from("<II", buf, o)
        o += 8
        assert c < nchan and k > 0
        pk = np.frombuffer(buf[o:o + k * 188], np.uint8).reshape(k, 188)
        o += k * 188
        got[c].append(pk)
    for c in range(nchan):
        assert got[c], f"channel {c} decoded nothing"
        ts = np.concatenate(got[c])
        assert (ts[:, 0] == 0x47).all()
        # most decoded packets must be payload packets we sent
        hits = sum(1 for p in ts
                   if (payloads[c] == p).all(axis=1).any())
        assert hits >= 50, (c, hits, len(ts))


def test_fleet_cli_viterbi(tmp_path):
    from leansdr_jax.pipelines import tsgen, dvbs_tx

    nchan = 2
    payloads, iqs = [], []
    for c in range(nchan):
        pkts = tsgen.generate(120, start=900 * c)
        payloads.append(pkts)
        iqs.append(dvbs_tx.modulate(
            pkts, dvbs_tx.TxConfig(rate="1/2", interp=2)))
    n = min(len(q) for q in iqs)
    frames = np.stack([q[:n] for q in iqs]).transpose(1, 0, 2)

    out_tpl = str(tmp_path / "ch_%d.ts")
    r = subprocess.run(
        [sys.executable, "-m", "leansdr_jax.apps.leandvbfleet",
         "--nchan", str(nchan), "--f32", "--float-scale", "75",
         "-f", "4e6", "--sr", "2e6", "--cr", "1/2", "--fastlock",
         "--viterbi", "--chunk", "16384", "--out-template", out_tpl],
        input=frames.astype(np.float32).tobytes(), capture_output=True,
        timeout=900, cwd=str(REPO))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    for c in range(nchan):
        ts = np.fromfile(out_tpl % c, np.uint8).reshape(-1, 188)
        assert len(ts) >= 40, (c, len(ts))
        assert (ts[:, 0] == 0x47).all()
        hits = sum(1 for p in ts
                   if (payloads[c] == p).all(axis=1).any())
        assert hits >= 40, (c, hits, len(ts))
