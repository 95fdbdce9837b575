"""Golden tests: our TX chain vs the reference leandvbtx binary."""

import subprocess

import numpy as np
import pytest

from leansdr_jax.pipelines import tsgen, dvbs_tx
from leansdr_jax.util.iofmt import read_iq


def test_tsgen_matches_reference(ref_apps, golden_dir):
    ref = np.fromfile(golden_dir / "ts300.bin", dtype=np.uint8)
    ours = tsgen.generate(300).reshape(-1)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("interp,rate", [(2, "1/2"), (2, "3/4"), (4, "1/2"),
                                         (2, "7/8"), (2, "2/3")])
def test_tx_iq_matches_reference(ref_apps, golden_dir, interp, rate):
    ts = (golden_dir / "ts300.bin").read_bytes()
    r = subprocess.run(
        [str(ref_apps / "leandvbtx"), "-f", str(interp), "--cr", rate],
        input=ts, capture_output=True, check=True)
    ref_iq = read_iq(r.stdout, "f32")

    packets = np.frombuffer(ts, dtype=np.uint8).reshape(-1, 188)
    cfg = dvbs_tx.TxConfig(rate=rate, interp=interp)
    our_iq = dvbs_tx.modulate(packets, cfg)

    assert our_iq.shape == ref_iq.shape, (our_iq.shape, ref_iq.shape)
    assert np.allclose(our_iq, ref_iq, atol=2e-4), (
        np.abs(our_iq - ref_iq).max())


def test_device_modulator_matches_host():
    """The all-device jitted TX (matmul RS encode, shifted-lane convolution,
    polyphase RRC) must match the host chain (itself golden vs the
    reference binary) at float tolerance."""
    from leansdr_jax.pipelines.dvbs_tx_device import DeviceModulator
    pkts = tsgen.generate(60)
    host = dvbs_tx.modulate(pkts, dvbs_tx.TxConfig(rate="1/2", interp=2))
    dev = DeviceModulator(rate="1/2", interp=2)
    y = dev.modulate(pkts)
    latency = (dev.ncoeffs + 2) // 2
    seg = y[latency * 2: latency * 2 + len(host)]
    assert np.abs(host - seg).max() < 1e-5


@pytest.mark.parametrize("kw", [
    dict(rate="1/2", interp=2),
    dict(rate="3/4", interp=2),
    dict(rate="7/8", interp=4, decim=2),
    dict(rate="1/2", interp=2, agc=True),
])
def test_tx_stream_equals_batch(kw):
    """TxStream.feed over arbitrary chunk boundaries must concatenate to
    exactly the batch modulate() output (streaming TX, leandvbtx.cc is a
    streaming process)."""
    cfg = dvbs_tx.TxConfig(**kw)
    pkts = tsgen.generate(90)
    batch = dvbs_tx.modulate(pkts, cfg)

    tx = dvbs_tx.TxStream(cfg)
    rng = np.random.default_rng(7)
    chunks, k = [], 0
    while k < len(pkts):
        n = int(rng.integers(1, 17))
        chunks.append(tx.feed(pkts[k:k + n]))
        k += n
    ours = np.concatenate(chunks)
    assert ours.shape == batch.shape
    np.testing.assert_array_equal(ours, batch)
