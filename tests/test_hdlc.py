"""HDLC deframer + ETR192 descrambler tests."""

import numpy as np

from leansdr_jax.proto.hdlc import (HdlcDec, HdlcSync, etr192_descramble,
                                    etr192_scramble, CRC16_INIT, CRC16_POLY)


def _crc16(data):
    crc = CRC16_INIT
    for b in data:
        crc ^= int(b)
        for _ in range(8):
            crc = (crc >> 1) ^ CRC16_POLY if (crc & 1) else (crc >> 1)
    return crc ^ 0xFFFF


def hdlc_encode(frames):
    """Reference-style HDLC bit stream: flags + LSB-first bytes + stuffing."""
    bits = [0, 1, 1, 1, 1, 1, 1, 0]    # opening flag
    for frame in frames:
        payload = list(frame) + [0, 0]
        crc = _crc16(frame)
        payload[-2] = crc & 0xFF
        payload[-1] = crc >> 8
        ones = 0
        for byte in payload:
            for k in range(8):         # LSB first
                bit = (byte >> k) & 1
                bits.append(bit)
                if bit:
                    ones += 1
                    if ones == 5:
                        bits.append(0)  # stuffing
                        ones = 0
                else:
                    ones = 0
        bits += [0, 1, 1, 1, 1, 1, 1, 0]   # closing flag
    while len(bits) % 8:
        bits.append(0)
    # MSB-first packing into bytes (hdlc_dec consumes byte<<=1 from MSB)
    return np.packbits(np.array(bits, np.uint8))


def test_hdlc_roundtrip():
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, n, dtype=np.uint8)
              for n in (10, 40, 100)]
    stream = hdlc_encode(frames)
    dec = HdlcDec(2, 278, invert=False)
    out, herr, ferr = dec.decode(stream)
    assert ferr == 0
    assert len(out) == len(frames)
    for a, b in zip(out, frames):
        np.testing.assert_array_equal(a, b)


def test_hdlc_sync_polarity_election():
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, 64, dtype=np.uint8) for _ in range(20)]
    stream = hdlc_encode(frames) ^ 0xFF          # inverted polarity
    sync = HdlcSync(2, 278, fastlock=True)
    out = sync.process(np.concatenate([stream, stream]))
    assert sync.cur_sync == 1                    # inverted decoder elected
    assert sync.framecount >= len(frames)


def test_etr192_roundtrip():
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, 200, dtype=np.uint8)
    scr, _, _ = etr192_scramble(data)
    dsc, _, _ = etr192_descramble(scr)
    # Self-synchronizing: after the 20-bit register fills, output matches.
    np.testing.assert_array_equal(dsc[4:], data[4:])
