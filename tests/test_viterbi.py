"""Viterbi layer tests (trellis validity + decode correctness)."""

import numpy as np
import pytest

from leansdr_jax.fec import convenc
from leansdr_jax.fec.viterbi import (make_trellis, ViterbiBank, ViterbiSync,
                                     make_sync_maps, NSTATES)
from leansdr_jax.dsp.cstln import Predef, make_dvbs2_constellation


@pytest.mark.parametrize("rate", ["1/2", "3/4", "5/6", "7/8", "4/6"])
def test_trellis_valid(rate):
    """Mirror of the reference's startup check: the code must produce no
    branch collisions (viterbi.h:83-86) and each state must have exactly
    NUS incoming branches."""
    t = make_trellis(rate)
    assert (np.sum(t.pred >= 0, axis=1) == t.nus).all()


def test_viterbi_decodes_clean_stream():
    """Hard-decision decode of a clean rate-1/2 encoded stream recovers
    the input bits after the traceback depth."""
    rate = "1/2"
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 80, dtype=np.uint8)
    syms, _ = convenc.encode(data, rate, 2)   # 2-bit coded symbols

    t = make_trellis(rate)
    bank = ViterbiBank(t, 1)
    outbits = []
    for cs in syms:
        us, q = bank.update(np.array([0]), np.array([int(cs)]),
                            np.array([-10]))  # flat negative metric
        outbits.append(int(us[0]))
    ob = np.array(outbits, np.uint8)
    dbits = np.unpackbits(data)
    # Find the decoded stream inside the input bits (traceback latency).
    w = np.lib.stride_tricks.sliding_window_view(dbits, 256)
    assert (w == ob[64:64 + 256]).all(axis=1).any()


def test_sync_maps_qpsk():
    cstln = make_dvbs2_constellation(Predef.QPSK, "1/2")
    maps, nconj, nrot, nshifts = make_sync_maps(cstln, "1/2")
    # QPSK 1/2: bits_out=2 == bits_per_symbol -> 1 shift; 2 conj x 2 rot
    assert (nconj, nrot, nshifts) == (2, 2, 1)
    # rotation 0 / no conj must be the identity map
    np.testing.assert_array_equal(maps[0], np.arange(4))
    # every map is a permutation
    for m in maps:
        assert sorted(m.tolist()) == [0, 1, 2, 3]


def test_device_bank_matches_host_bank():
    """The device ACS scan must produce the same outputs as the NumPy
    bank for identical inputs."""
    import jax.numpy as jnp
    from leansdr_jax.fec.viterbi import _viterbi_chunk_device
    rate = "3/4"
    rng = np.random.default_rng(2)
    t = make_trellis(rate)
    S, B = 3, 64
    cs = rng.integers(0, t.ncs, (S, B))
    cost = -rng.integers(0, 3000, (S, B))
    host = ViterbiBank(t, S)
    us_h = np.zeros((S, B), np.int64)
    q_h = np.zeros((S, B), np.int64)
    for b in range(B):
        us, q = host.update(np.arange(S), cs[:, b], cost[:, b])
        us_h[:, b] = us
        q_h[:, b] = q
    cst = jnp.zeros((S, 64), jnp.int32)
    phi = jnp.zeros((S, 64), jnp.uint32)
    plo = jnp.zeros((S, 64), jnp.uint32)
    cst, phi, plo, us_d, q_d = _viterbi_chunk_device(
        rate, cst, phi, plo, jnp.asarray(cs), jnp.asarray(cost))
    np.testing.assert_array_equal(us_h, np.asarray(us_d))
    np.testing.assert_array_equal(q_h, np.asarray(q_d))
    np.testing.assert_array_equal(host.cost, np.asarray(cst))
