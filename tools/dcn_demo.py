#!/usr/bin/env python
"""Multi-HOST (DCN) demonstration: 2 JAX processes, one global mesh.

Each process owns 4 virtual CPU devices; `jax.distributed.initialize`
forms the 8-device global mesh, and a `shard_map` over the `channel`
axis runs the sharded fleet demod step with `pmean` metric reduction —
the same program as parallel/mesh.sharded_demod_step, but with the
collective crossing PROCESS boundaries over gRPC (the CPU stand-in for
a multi-host network; on GPU hosts the same program rides NVLink within
a host and the network across hosts — the JAX programming model is
identical, which is the point of this demo).

Run: python tools/dcn_demo.py    (spawns both processes, ~1 min)
Prints one JSON line per process with the psum-reduced fleet metric and
the number of processes/devices each participant saw.
"""

import json
import multiprocessing as mp
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

NPROC = 2
LOCAL_DEV = 4


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(pid: int, port: int, q):
    try:
        _worker(pid, port, q)
    except Exception as e:          # surface worker failures to the parent
        import traceback
        q.put({"process": pid, "error": repr(e),
               "tb": traceback.format_exc()})


def _worker(pid: int, port: int, q):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={LOCAL_DEV}")
    sys.path.insert(0, str(REPO))
    import jax
    from leansdr_jax.util.jax_cache import setup_cache
    setup_cache(REPO)
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=NPROC, process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from jax import shard_map

    from leansdr_jax.dsp import receiver
    from leansdr_jax.dsp.cstln import Predef, make_dvbs2_constellation
    from leansdr_jax.pipelines import tsgen, dvbs_tx

    C = 16                       # global fleet, 2 per device
    CH = 4096
    cstln = make_dvbs2_constellation(Predef.QPSK, "1/2")
    params = receiver.ReceiverParams(omega=2.0, sampler="linear",
                                     nsymbols=4, exact_lut=False)
    tables = receiver.make_tables(cstln)

    # Identical deterministic stimulus in both processes (process-local
    # data would also work; this keeps the asserts simple).
    pkts = tsgen.generate(11 + (CH + 4096) // 3264 + 2)
    y = dvbs_tx.modulate(pkts, dvbs_tx.TxConfig(rate="1/2", interp=2))
    y = (y * 75.0).astype(np.float32)
    x = np.broadcast_to(y[None, :CH + params.readahead],
                        (C,) + y[:CH + params.readahead].shape)

    mesh = Mesh(np.asarray(jax.devices()).reshape(NPROC * LOCAL_DEV),
                ("channel",))
    state = receiver.init_state(params, C)

    def step(st, xs):
        st2, out = receiver.run_chunks(params, tables, st, xs)
        nsym = out["valid"].sum()
        mer = st2["est_sp"] / jnp.maximum(st2["est_ep"], 1e-9)
        # Fleet-wide reductions cross the process boundary (DCN):
        g_nsym = jax.lax.psum(nsym, "channel")
        g_mer = jax.lax.pmean(mer.mean(), "channel")
        return st2, g_nsym, g_mer

    fn = shard_map(step, mesh=mesh,
                   in_specs=(P("channel"), P("channel")),
                   out_specs=(P("channel"), P(), P()),
                   check_vma=False)
    sh = NamedSharding(mesh, P("channel"))
    xg = jax.device_put(jnp.asarray(x), sh)
    stg = jax.tree.map(lambda a: jax.device_put(a, sh), state)

    st2, g_nsym, g_mer = jax.jit(fn)(stg, xg)

    # N>=2-host kernel-rate point (BASELINE.json: RRC-FIR samples/s at
    # 1 chip / 1 host / N hosts): overlap-save sharded FIR with the halo
    # exchange crossing the process boundary.
    import time
    from leansdr_jax.parallel import halo
    from leansdr_jax.dsp import filtergen
    coeffs = filtergen.root_raised_cosine(32, 0.25, 0.35)
    tmesh = halo.make_time_mesh(jax.devices())
    fir = halo.sharded_fir(coeffs, tmesh)
    NS = 1 << 20
    rng = np.random.default_rng(0)
    sig = jax.device_put(
        jnp.asarray((rng.normal(size=NS) + 1j * rng.normal(size=NS)
                     ).astype(np.complex64)),
        NamedSharding(tmesh, P("time")))
    yv = fir(sig)
    jax.block_until_ready(yv)
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        yv = fir(sig)
    jax.block_until_ready(yv)
    fir_sps = NS * reps / (time.perf_counter() - t0)

    res = {
        "process": pid,
        "processes": jax.process_count(),
        "global_devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
        "fleet_symbols_psum": int(np.asarray(g_nsym).reshape(-1)[0]),
        "fleet_mer_pmean_db": round(
            10 * float(np.log10(np.asarray(g_mer).reshape(-1)[0])), 2),
        "fir_2host_msps": round(fir_sps / 1e6, 1),
    }

    # --- Stage 2: the PRODUCTION fleet decode across hosts -------------
    # Per-host ingest (each process modulates and feeds ONLY its own
    # channels), ONE global-mesh fused device program (mf prefilter ->
    # demod -> compaction ring -> deconvolution), and a PER-HOST native
    # C++ byte backend decoding that host's channels to payload-verified
    # TS. The aggregate rate is allgathered — this is SURVEY 5.8's DCN
    # role: batch (channel) distribution across hosts, byte domain local
    # to each host (leansdrserv.cc:98-260's role, minus HTTP).
    from jax.experimental import multihost_utils
    from leansdr_jax.pipelines.dvbs_rx import RxConfig
    from leansdr_jax.pipelines.multi_rx import (MultiDvbsReceiver,
                                                make_byte_backend)

    CF = 16                       # global fleet channels
    CH2 = 1 << 15
    NWIN = 3
    rx = MultiDvbsReceiver(
        RxConfig(Fs=4e6, Fm=2e6, rate="1/2", fastlock=True,
                 float_scale=75.0, exact_lut=False),
        CF, chunk_samples=CH2)
    ra = rx.params.readahead + (len(rx.mf_taps) - 1
                                if rx.mf_taps is not None else 0)

    shard_c = NamedSharding(mesh, P("channel"))
    shard_last = NamedSharding(mesh, P(None, "channel"))
    rx.state = {k: jax.device_put(v, shard_c)
                for k, v in rx.state.items()}
    dst = rx.deconv.state
    for k, v in dst.items():
        if v.ndim >= 1 and v.shape[0] == CF:
            dst[k] = jax.device_put(v, shard_c)
        elif v.ndim == 2 and v.shape[1] == CF:
            dst[k] = jax.device_put(v, shard_last)

    # Per-host ingest: this process only materializes its own channels.
    ch_per_proc = CF // NPROC
    my_ids = list(range(pid * ch_per_proc, (pid + 1) * ch_per_proc))
    payloads = {c: tsgen.generate(
        12 + (NWIN * CH2 + ra) // 3264 + 2, start=1000 * c)
        for c in my_ids}
    local_iq = np.stack([
        dvbs_tx.modulate(payloads[c],
                         dvbs_tx.TxConfig(rate="1/2", interp=2))
        [: NWIN * CH2 + ra] for c in my_ids]) * np.float32(75.0)

    backend = make_byte_backend(len(my_ids), fastlock=True)
    decoded = verified = 0
    t0 = time.perf_counter()
    for w in range(NWIN):
        win_local = np.ascontiguousarray(
            local_iq[:, w * CH2: (w + 1) * CH2 + ra])
        win = multihost_utils.host_local_array_to_global_array(
            win_local, mesh, P("channel"))
        pend = rx.dispatch(win)
        assert pend is not None
        packed_out, shapes = pend
        # Per-host fetch: only this host's shards cross its link.
        shards = sorted(packed_out.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        buf = np.concatenate([np.asarray(s.data) for s in shards], 0)
        rows = []
        for s in shards:
            sl = s.index[0]
            rows.extend(range(sl.start or 0, sl.stop))
        assert rows == my_ids, (rows, my_ids)
        per_chan = [[] for _ in my_ids]
        o = 0
        for nb, ne in shapes:
            by = buf[:, o:o + nb]
            o += nb + ne * 4
            under = buf[:, o]
            o += 1
            for i in range(len(my_ids)):
                if not under[i]:
                    per_chan[i].append(by[i])
        fill = buf[:, o:o + 4].copy().view(np.int32)[:, 0]
        rx.deconv.sync_fill(fill)
        bytes_by = [np.concatenate(p) if p else np.empty(0, np.uint8)
                    for p in per_chan]
        for i, ts in enumerate(backend.feed(bytes_by)):
            decoded += len(ts)
            verified += sum(1 for o_ in ts
                            if (payloads[my_ids[i]] == o_)
                            .all(axis=1).any())
    elapsed = time.perf_counter() - t0
    agg = multihost_utils.process_allgather(
        np.array([decoded, verified, elapsed, 0.0]))
    g_dec = int(agg[:, 0].sum())
    g_ver = int(agg[:, 1].sum())
    g_rate = CF * NWIN * CH2 / float(agg[:, 2].max()) / 1e6

    res.update({
        "fleet_decode_backend": type(backend).__name__,
        "fleet_ts_decoded": g_dec,
        "fleet_ts_verified": g_ver,
        "fleet_aggregate_msps_cpu": round(g_rate, 2),
    })
    q.put(res)


def main():
    mp.set_start_method("spawn")
    q = mp.Queue()
    port = _free_port()
    ps = [mp.Process(target=worker, args=(i, port, q), daemon=True)
          for i in range(NPROC)]
    for p in ps:
        p.start()
    try:
        results = [q.get(timeout=300) for _ in range(NPROC)]
    finally:
        for p in ps:          # a wedged peer must not hang the demo
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
    for r in sorted(results, key=lambda r: r["process"]):
        print(json.dumps(r))
    assert all(r["processes"] == NPROC for r in results)
    assert all(r["global_devices"] == NPROC * LOCAL_DEV for r in results)
    # Collectives agree across hosts:
    assert results[0]["fleet_symbols_psum"] == \
        results[1]["fleet_symbols_psum"]
    assert results[0]["fleet_symbols_psum"] > 0
    # The production fleet decode crossed hosts consistently and
    # produced payload-verified TS on both sides.
    assert results[0]["fleet_ts_decoded"] == results[1]["fleet_ts_decoded"]
    assert results[0]["fleet_ts_decoded"] >= 64
    assert results[0]["fleet_ts_verified"] >= 32
    print("DCN demo OK", file=sys.stderr)


if __name__ == "__main__":
    main()
