"""Pallas demod kernel vs the XLA scan path (interpret mode on CPU):
bit-identical symbols, costs and emission pattern."""

import numpy as np
import jax.numpy as jnp
import pytest

from leansdr_jax.dsp import receiver, receiver_pallas as rp
from leansdr_jax.dsp.cstln import Predef, make_dvbs2_constellation
from leansdr_jax.pipelines import tsgen, dvbs_tx


def test_kernel_matches_scan_path():
    pkts = tsgen.generate(30)
    iq = dvbs_tx.modulate(pkts, dvbs_tx.TxConfig(rate="1/2", interp=2))
    cstln = make_dvbs2_constellation(Predef.QPSK, "1/2")
    tables = receiver.make_tables(cstln)
    params = receiver.ReceiverParams(omega=2.0, sampler="linear",
                                     nsymbols=4, exact_lut=False)
    n = min((len(iq) - 1) // 128 * 128, 1280)
    x = jnp.asarray(iq[None, :n + 1, :])

    st0 = receiver.init_state(params, 1)
    s_x, o_x = receiver.run_chunks(params, tables, st0, x)

    planes = rp.pack_state(st0)
    st_p, packed = rp.demod_pallas(params, rp.sym_constants(cstln),
                                   planes, x, interpret=True)
    cost, sym, valid = rp.unpack_outputs(packed, 1)

    vx = np.asarray(o_x["valid"][0])
    assert (vx == valid[0]).all()
    np.testing.assert_array_equal(
        np.asarray(o_x["symbol"][0])[vx], sym[0][valid[0]])
    np.testing.assert_array_equal(
        np.asarray(o_x["cost"][0])[vx], cost[0][valid[0]])
    su = rp.unpack_state(st_p, 1)
    for k in ("mu", "freqw", "agc_gain", "est_insp"):
        assert abs(float(s_x[k][0]) - float(su[k][0])) < max(
            1e-3, 1e-4 * abs(float(s_x[k][0]))), k


def test_kernel_matches_scan_path_huge_amplitudes():
    """|IQ| >= 2048 exercises halving rounds 5..12 (sdr.h:470-485):
    unscaled --s16/--f32 inputs hit this during acquisition while the
    AGC is still converging."""
    pkts = tsgen.generate(20)
    iq = dvbs_tx.modulate(pkts, dvbs_tx.TxConfig(rate="1/2", interp=2))
    cstln = make_dvbs2_constellation(Predef.QPSK, "1/2")
    tables = receiver.make_tables(cstln)
    params = receiver.ReceiverParams(omega=2.0, sampler="linear",
                                     nsymbols=4, exact_lut=False)
    n = min((len(iq) - 1) // 128 * 128, 1024)
    x = jnp.asarray(iq[None, :n + 1, :]) * 300.0   # amplitudes ~22000

    st0 = receiver.init_state(params, 1)
    s_x, o_x = receiver.run_chunks(params, tables, st0, x)

    st_p, packed = rp.demod_pallas(params, rp.sym_constants(cstln),
                                   rp.pack_state(st0), x, interpret=True)
    cost, sym, valid = rp.unpack_outputs(packed, 1)
    vx = np.asarray(o_x["valid"][0])
    assert (vx == valid[0]).all()
    np.testing.assert_array_equal(
        np.asarray(o_x["symbol"][0])[vx], sym[0][valid[0]])
    np.testing.assert_array_equal(
        np.asarray(o_x["cost"][0])[vx], cost[0][valid[0]])
    # The soft costs must not be saturated to zero (the 4-round bug).
    assert (np.asarray(o_x["cost"][0])[vx] != 0).any()


@pytest.mark.parametrize("predef,cr,nsym", [
    (Predef.PSK8, "2/3", 8),
    (Predef.APSK16, "3/4", 16),
])
def test_kernel_matches_scan_path_nonqpsk(predef, cr, nsym):
    """The generic constellation branch of the demod kernel (the
    nsym-way argmin sweep, receiver_pallas.py) vs the XLA scan path:
    same symbols/costs/valid pattern for 8PSK and 16APSK."""
    rng = np.random.default_rng(5)
    cstln = make_dvbs2_constellation(predef, cr)
    tables = receiver.make_tables(cstln)
    params = receiver.ReceiverParams(omega=2.0, sampler="linear",
                                     nsymbols=nsym, exact_lut=False)
    n = 1280
    # Noisy random symbols at the AGC setpoint amplitude.
    pts = cstln.symbols.astype(np.float32)
    sym_ix = rng.integers(0, nsym, n // 2 + 2)
    base = np.repeat(pts[sym_ix], 2, axis=0)[: n + 1]
    x = jnp.asarray((base + rng.normal(scale=8.0, size=base.shape)
                     ).astype(np.float32)[None])

    st0 = receiver.init_state(params, 1)
    s_x, o_x = receiver.run_chunks(params, tables, st0, x)

    st_p, packed = rp.demod_pallas(params, rp.sym_constants(cstln),
                                   rp.pack_state(st0), x, interpret=True)
    cost, sym, valid = rp.unpack_outputs(packed, 1)
    vx = np.asarray(o_x["valid"][0])
    assert (vx == valid[0]).all() and vx.sum() > 100
    np.testing.assert_array_equal(
        np.asarray(o_x["symbol"][0])[vx], sym[0][valid[0]])
    np.testing.assert_array_equal(
        np.asarray(o_x["cost"][0])[vx], cost[0][valid[0]])


def test_state_pack_roundtrip():
    params = receiver.ReceiverParams(omega=1.5, nsymbols=4)
    st = receiver.init_state(params, 7)
    st["mu"] = jnp.arange(7, dtype=jnp.float32)
    st["hist_p"] = jnp.arange(7 * 6, dtype=jnp.float32).reshape(7, 3, 2)
    planes = rp.pack_state(st)
    back = rp.unpack_state(planes, 7)
    np.testing.assert_allclose(np.asarray(back["mu"]), np.asarray(st["mu"]))
    np.testing.assert_allclose(np.asarray(back["hist_p"]),
                               np.asarray(st["hist_p"]))
