"""Kernel selection per platform, the compile cache, the card-only
scripts' refusal on a CPU host, and the compiled kernels on the card
(tests marked `gpu`)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from leansdr_jax import platform
from leansdr_jax.dsp.cstln import Predef, make_dvbs2_constellation
from leansdr_jax.pipelines.dvbs_rx import RxConfig
from leansdr_jax.pipelines.multi_rx import MultiDvbsReceiver

REPO = Path(__file__).resolve().parent.parent


def test_cpu_families_pick_reference_paths():
    f = platform.families("cpu")
    assert not f.kernels and f.exact_lut and not f.device_blocks
    rx = MultiDvbsReceiver(RxConfig(Fs=4e6, Fm=2e6, rate="3/4",
                                    viterbi=True), 2)
    assert not rx.use_pallas and rx.deconv.kind == "viterbi_xla"


def test_gpu_families_pick_compiled_kernels(monkeypatch):
    f = platform.families("gpu")
    assert f.kernels and not f.exact_lut and not f.interpret
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    rx = MultiDvbsReceiver(RxConfig(Fs=4e6, Fm=2e6, rate="7/8",
                                    viterbi=True, sampler="rrc"), 2)
    assert rx.use_pallas and not rx._interpret
    assert rx.deconv.kind == "viterbi_acs" and not rx.deconv.interpret


def test_unknown_platform_raises(monkeypatch):
    with pytest.raises(RuntimeError, match="no kernel families"):
        platform.families("metal")
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError):
        MultiDvbsReceiver(RxConfig(Fs=4e6, Fm=2e6), 1)


def test_compilation_cache_env_is_honoured(monkeypatch, tmp_path):
    from leansdr_jax.util import jax_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    jax_cache.setup_cache()
    assert jax.config.jax_compilation_cache_dir == before
    assert jax_cache.cache_dir() == str(tmp_path)


def test_compilation_cache_default_is_fixed_path(monkeypatch):
    from leansdr_jax.util import jax_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jax_cache.cache_dir() == str(
        REPO / ".jax_cache" / jax_cache.machine_tag())


def _run(args, cwd=REPO, **env):
    return subprocess.run([sys.executable] + args, cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **env})


def test_chip_smoke_refuses_cpu():
    r = _run(["chip_smoke.py"], JAX_PLATFORMS="cpu")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "no GPU" in r.stderr


def test_chip_smoke_refuses_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run(["chip_smoke.py"], cwd=tmp_path, JAX_PLATFORMS="cpu")
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_bench_refuses_cpu():
    r = _run(["bench.py"], JAX_PLATFORMS="cpu")
    assert r.returncode != 0 and "no GPU" in r.stderr


def test_tx_apps_never_open_a_device(tmp_path):
    """leantsgen | leandvbtx | leanchansim run beside the receiver that
    holds the card, so none of them may initialise a JAX backend: with
    JAX_PLATFORMS naming a platform this host lacks, any backend
    initialisation fails."""
    env = dict(JAX_PLATFORMS="cuda", PYTHONPATH=str(REPO))
    ts = tmp_path / "t.ts"
    steps = [(["-m", "leansdr_jax.apps.leantsgen", "-c", "40"], None),
             (["-m", "leansdr_jax.apps.leandvbtx", "-f", "2", "--cr",
               "1/2"], ts),
             (["-m", "leansdr_jax.apps.leanchansim", "--if32", "--of32",
               "--awgn", "-14", "--deterministic"], tmp_path / "tx.iq")]
    data = b""
    for args, _ in steps:
        r = subprocess.run([sys.executable] + args, input=data,
                           capture_output=True, timeout=300,
                           env={**os.environ, **env})
        assert r.returncode == 0, r.stderr[-400:]
        assert len(r.stdout) > 0
        data = r.stdout


@pytest.mark.gpu
def test_demod_kernel_compiled_matches_scan(gpu):
    """Compiled demod kernel vs the XLA scan on the card: the same
    emitted symbol sequence (ulp-level float differences may move an
    emission by a sample, never a decision on a clean stream)."""
    from leansdr_jax.dsp import receiver, receiver_pallas as rp
    from leansdr_jax.pipelines import tsgen, dvbs_tx
    cstln = make_dvbs2_constellation(Predef.QPSK, "1/2")
    params = receiver.ReceiverParams(omega=2.0, sampler="linear",
                                     nsymbols=4, exact_lut=False)
    iq = dvbs_tx.modulate(tsgen.generate(60),
                          dvbs_tx.TxConfig(rate="1/2", interp=2))
    n = (len(iq) - 1) // 128 * 128
    x = jax.numpy.asarray(iq[None, :n + 1] * 75.0)
    st0 = receiver.init_state(params, 1)
    _, packed = rp.demod_pallas(params, rp.sym_constants(cstln),
                                rp.pack_state(st0), x)
    _, sym, valid = rp.unpack_outputs(packed)
    _, out = receiver.run_chunks(params, receiver.make_tables(cstln),
                                 st0, x)
    a = sym[0][valid[0]]
    b = np.asarray(out["symbol"][0])[np.asarray(out["valid"][0])]
    m = min(len(a), len(b))
    assert m > 1000 and (a[:m] == b[:m]).mean() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("rate", ["1/2", "3/4", "7/8"])
def test_acs_kernel_compiled_matches_bank(gpu, rate):
    from leansdr_jax.fec import viterbi as vit
    from leansdr_jax.fec.viterbi_acs import viterbi_acs
    t = vit.make_trellis(rate)
    T, N = 256, 16
    rng = np.random.default_rng(2)
    cs = rng.integers(0, t.ncs, (T, N)).astype(np.int32)
    cost = -(rng.integers(0, 4, (T, N)) * 3).astype(np.int32)
    z = jax.numpy.zeros((N, 64), jax.numpy.int32)
    _, _, _, us, q = viterbi_acs(rate, z, z, z, jax.numpy.asarray(cs),
                                 jax.numpy.asarray(cost))
    bank = vit.ViterbiBank(t, N)
    for k in range(T):
        bus, bq = bank.update(np.arange(N), cs[k].astype(np.int64),
                              cost[k].astype(np.int64))
        assert np.array_equal(np.asarray(us)[k], bus)
        assert np.array_equal(np.asarray(q)[k], bq)
