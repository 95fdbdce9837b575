"""Device-resident deconvolution (fec/deconv_device.py) ground truth.

Mirrors the identity check of test_deconv_inverts_encoder but through the
fused device path: compaction ring + GF(2) convolution + hypothesis
election must invert the TX encoder for every rate, under channel
rotations/conjugation (sync hypotheses) and symbol slips (alignment
hypotheses), with channels exercising different impairments in one batch.
"""

import numpy as np
import pytest

from leansdr_jax.fec import convenc, deconv
from leansdr_jax.fec.deconv_device import DeviceDeconvolver

import jax.numpy as jnp


def _apply_sync_transform(syms: np.ndarray, sync_id: int) -> np.ndarray:
    """Remap TX symbols so hypothesis `sync_id` is the one that decodes.

    sync_maps()[sync_id][s_rx] gives the IQ bits; the identity hypothesis
    is 0, so the channel transform for hypothesis h maps a symbol with
    bits map[0][s] to the rx symbol s' with map[h][s'] == map[0][s].
    """
    maps = deconv.sync_maps()
    inv = np.zeros(4, np.uint8)
    for s_rx in range(4):
        inv[maps[sync_id, s_rx]] = s_rx
    return inv[maps[0, syms]]


def _recovers(bytes_out: np.ndarray, needle: np.ndarray) -> bool:
    for invv in (0, 1):
        b = np.unpackbits(bytes_out) ^ invv
        if len(b) < len(needle):
            return False
        w = np.lib.stride_tricks.sliding_window_view(b, len(needle))
        if (w == needle).all(axis=1).any():
            return True
    return False


@pytest.mark.parametrize("rate", ["1/2", "3/4", "5/6", "7/8", "4/6"])
def test_device_deconv_inverts_encoder(rate):
    rng = np.random.default_rng(7)
    spec = deconv.deconv_spec(rate)
    # 5880*8 bits is divisible by bits_in for every rate (1,3,4,5,7).
    data = rng.integers(0, 256, 5880, dtype=np.uint8)
    dbits = np.unpackbits(data)
    needle = dbits[9000:9400]
    syms, _ = convenc.encode(data, rate, 2)

    # 4 channels: different sync rotations; plus per-channel symbol slip.
    # Rate 5/6 is excluded from conjugate transforms: its primary and
    # alternate polynomials share per-column I/Q tap parities, so the
    # disagreement metric cannot distinguish conjugation — the SAME blind
    # spot exists in the reference fastlock election (dvb.h:414-436,
    # strict '<' keeps the earlier sync on the exact tie), verified
    # against the polynomial table. Non-fastlock next_sync rotation
    # resolves it there and here.
    C = 4
    syncsel = [0, 1, 2, 3] if rate != "5/6" else [0, 1, 0, 1]
    slips = [0, 1 % max(1, spec.punctweight // 2), 0,
             (spec.punctweight // 2) - 1]
    chans = []
    n = len(syms) - max(slips) - 4
    for c in range(C):
        s = _apply_sync_transform(syms, syncsel[c])[slips[c]:slips[c] + n]
        chans.append(s)
    sym_tc = np.stack(chans, axis=1)                   # [n, C]

    # Interleave some invalid samples to exercise compaction.
    expanded = np.zeros((n + n // 3, C), np.uint8)
    vmask = np.ones((n + n // 3, C), bool)
    vmask[::4] = False                                 # every 4th invalid
    pos = np.cumsum(vmask[:, 0]) - 1
    take = vmask[:, 0]
    expanded[take] = sym_tc[pos[take]]
    nsamp = expanded.shape[0]

    dd = DeviceDeconvolver(rate, C, nsamp, omega=float(nsamp) / n,
                           fastlock=True, sub_symbols=1024)
    dd.append(jnp.asarray(expanded), jnp.asarray(vmask))
    dd.note_production(n)
    outs = [[] for _ in range(C)]
    while dd.can_decode():
        by, errs, under = dd.decode()
        assert not np.asarray(under).any()
        by = np.asarray(by)
        for c in range(C):
            outs[c].append(by[c])
    for c in range(C):
        assert outs[c], "no decode happened"
        full = np.concatenate(outs[c])
        assert _recovers(full, needle), f"channel {c} failed to invert"


def test_device_deconv_matches_host_blocks():
    """Steady-state output equals the host window formulation
    (deconvolve_block) for the elected hypothesis."""
    rng = np.random.default_rng(3)
    rate = "3/4"
    data = rng.integers(0, 256, 4002, dtype=np.uint8)  # *8 % bits_in == 0
    syms, _ = convenc.encode(data, rate, 2)
    n = len(syms)
    C = 2
    sym_tc = np.stack([syms, syms], axis=1)
    dd = DeviceDeconvolver(rate, C, n, omega=1.0, fastlock=True,
                           sub_symbols=2048)
    dd.append(jnp.asarray(sym_tc), jnp.asarray(np.ones((n, C), bool)))
    dd.note_production(n)
    assert dd.can_decode()
    by, errs, under = dd.decode()
    by = np.asarray(by)
    host = deconv.deconvolve_block(syms, rate, 0)
    # Device consumed plan.consumed symbols; host decoded everything.
    nb = min(by.shape[1], len(host))
    np.testing.assert_array_equal(by[0, :nb], host[:nb])
    np.testing.assert_array_equal(by[1, :nb], host[:nb])
    assert int(np.asarray(errs).sum()) == 0


def test_append_drift_guard_protects_leaders():
    """A channel whose fill lags the fleet by more than DELTA_MAX must
    not corrupt the in-window channels' ring contents (the laggard is
    dragged forward with a documented stream discontinuity)."""
    from leansdr_jax.fec.deconv_device import (DELTA_MAX, deconv_append,
                                               make_plan)
    rng = np.random.default_rng(3)
    C, n = 3, 512
    plan = make_plan("1/2", C, n, omega=2.0)
    state = {
        "buf": jnp.zeros((plan.cap, C), jnp.uint8),
        "fill": jnp.asarray([1000, 1000 - (DELTA_MAX + 200), 990],
                            np.int32),
        "locked": jnp.zeros(C, np.int32),
    }
    sym = rng.integers(0, 4, (n, C)).astype(np.uint8)
    valid = rng.random((n, C)) < 0.5
    st2 = deconv_append(plan, state, jnp.asarray(sym),
                        jnp.asarray(valid), None)
    buf = np.asarray(st2["buf"])
    fill2 = np.asarray(st2["fill"])
    for c in (0, 2):                       # in-window channels: exact
        start = [1000, None, 990][c]
        vs = sym[valid[:, c], c]
        np.testing.assert_array_equal(buf[start:start + len(vs), c], vs)
        assert fill2[c] == start + len(vs)
    # The laggard was dragged into the window, not beyond the leaders.
    assert fill2[1] >= fill2.max() - (DELTA_MAX + n)
