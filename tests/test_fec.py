"""Unit tests for the byte-domain FEC chain (SURVEY.md section 4.5 item 3)."""

import numpy as np
import pytest

from leansdr_jax.fec import prbs, rs, interleave, convenc, deconv


def test_prbs_pattern_basics():
    pat = prbs.prbs_pattern()
    assert pat[0] == 0xFF
    assert len(pat) == 188 * 8
    # Sync positions (multiples of 188, except 0) are inhibited to 0.
    assert all(pat[188 * k] == 0 for k in range(1, 8))
    # Known first PRBS byte: register 000251 -> 0x03 (EN 300 421 fig. 2).
    assert pat[1] != 0


def test_randomize_roundtrip():
    pkts = np.random.default_rng(0).integers(
        0, 256, (24, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    rand, _ = prbs.randomize(pkts, 0)
    # Packet 0 of each cycle has inverted sync.
    assert rand[0, 0] == 0xB8
    assert all(rand[k, 0] == 0x47 for k in range(1, 8))
    out, good, _ = prbs.derandomize_np(rand, 0)
    assert good.all()
    np.testing.assert_array_equal(out, pkts)


def test_rs_roundtrip_no_errors():
    rng = np.random.default_rng(1)
    msgs = rng.integers(0, 256, (16, 188), dtype=np.uint8)
    enc = rs.encode(msgs)
    assert enc.shape == (16, 204)
    assert not rs.syndromes(enc).any()
    dec, failed, bits = rs.decode(enc)
    assert not failed.any()
    assert (bits == 0).all()
    np.testing.assert_array_equal(dec, msgs)


@pytest.mark.parametrize("nerr", [1, 2, 4, 8])
def test_rs_corrects_errors(nerr):
    rng = np.random.default_rng(nerr)
    msgs = rng.integers(0, 256, (8, 188), dtype=np.uint8)
    enc = rs.encode(msgs)
    for row in enc:
        pos = rng.choice(204, size=nerr, replace=False)
        row[pos] ^= rng.integers(1, 256, nerr).astype(np.uint8)
    dec, failed, bits = rs.decode(enc)
    assert not failed.any()
    assert (bits > 0).all()
    np.testing.assert_array_equal(dec, msgs)


def test_rs_detects_uncorrectable():
    rng = np.random.default_rng(99)
    msgs = rng.integers(0, 256, (4, 188), dtype=np.uint8)
    enc = rs.encode(msgs)
    enc[:, :30] ^= rng.integers(1, 256, (4, 30)).astype(np.uint8)
    dec, failed, bits = rs.decode(enc)
    assert failed.all()


def test_rs_gf2_matmul_paths():
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    msgs = rng.integers(0, 256, (4, 188), dtype=np.uint8)
    enc = rs.encode(msgs)
    bits = np.unpackbits(msgs, axis=1)
    par = np.asarray(rs.jax_encode(jnp.asarray(bits)))
    np.testing.assert_array_equal(
        np.packbits(par, axis=1), enc[:, 188:])
    pbits = np.unpackbits(enc, axis=1)
    synd = np.asarray(rs.jax_syndromes(jnp.asarray(pbits)))
    assert not synd.any()


def test_interleave_roundtrip():
    rng = np.random.default_rng(3)
    pkts = rng.integers(0, 256, (40, 204), dtype=np.uint8)
    stream, backlog = interleave.interleave(pkts)
    assert backlog.shape == (11, 204)
    out, rest = interleave.deinterleave(stream)
    # The deinterleaver re-aligns with a DEPTH-byte latency; with both
    # directions chained the payload must come back exactly.
    assert out.shape[0] == (len(stream) - interleave.DEPTH) // 204
    # After the interleaver/deinterleaver pair, packet k of the output
    # equals packet k+11 of the input (end-to-end delay of 11 packets).
    for k in range(out.shape[0]):
        np.testing.assert_array_equal(out[k], pkts[k + 11])


def test_convenc_rate12_known_polys():
    # One byte 0x80: single 1 bit followed by zeros; with G1/G2 the first
    # outputs follow the impulse response of the code.
    syms, st = convenc.encode(np.array([0x80], np.uint8), "1/2", 2)
    assert syms.shape == (8,)
    assert syms.dtype == np.uint8
    assert (syms < 4).all()


def test_deconv_spec_derivation():
    # QPSK 1/2: the derived polynomial must be the documented 0x3ba
    # (dvb.h:119-120) and the alternate 0x38cca.
    spec = deconv.deconv_spec("1/2")
    assert spec.punctperiod == 1
    assert spec.punctweight == 2
    assert spec.deconv[0] == 0x3BA
    assert spec.deconv2[0] == 0x38CCA


@pytest.mark.parametrize("rate", ["1/2", "3/4", "5/6", "7/8", "4/6"])
def test_deconv_inverts_encoder(rate):
    """TX convol encode -> symbols -> deconvolve must return the input
    bitstream (mirrors the startup identity check, dvb.h:274-292, but
    end-to-end through the encoder).

    The encoder's 9-bit register latency (HISTSIZE=16 vs K=7) plus the
    puncture phase mean the recovered bitstream appears at an arbitrary
    bit offset, possibly inverted (180-degree ambiguity resolved by
    mpeg_sync polarity) and needing a symbol slip (resolved by next_sync).
    We search over slips / syncs / polarity like the receiver does.
    """
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 840, dtype=np.uint8)
    dbits = np.unpackbits(data)
    needle = dbits[1500:1900]
    syms, _ = convenc.encode(data, rate, 2)
    spec = deconv.deconv_spec(rate)
    for slip in range(spec.punctweight // 2):
        for sync_id in range(4):
            out = deconv.deconvolve_block(syms[slip:], rate, sync_id)
            if len(out) < 60:
                continue
            for inv in (0, 1):
                b = np.unpackbits(out) ^ inv
                w = np.lib.stride_tricks.sliding_window_view(b, len(needle))
                if (w == needle).all(axis=1).any():
                    return
    raise AssertionError("no sync/slip/polarity inverted the encoder")
