"""core/generic.py + util/pmp.py unit coverage (SURVEY section 2.3 and
the PMP zero-copy descriptor wire format, P8)."""

import numpy as np

from leansdr_jax.core.generic import (ItemCounter, RateEstimator,
                                      decimate, serialize)


def test_item_counter_and_decimate():
    c = ItemCounter()
    assert c.process(np.arange(10)) == 10
    assert c.process(np.arange(5)) == 15
    np.testing.assert_array_equal(decimate(np.arange(10), 3),
                                  [0, 3, 6, 9])


def test_serialize_reinterprets():
    x = np.array([0x0201, 0x0403], np.uint16)
    b = serialize(x, np.uint8)
    np.testing.assert_array_equal(b, [1, 2, 3, 4])   # little-endian


def test_rate_estimator_window():
    r = RateEstimator(sample_size=100)
    r.update(1, 60)
    assert r.latest is None          # window not yet full
    r.update(2, 60)
    assert r.latest == 3 / 120       # emitted once >= 100 denominator
    r.update(0, 100)
    assert r.latest == 0.0
    assert len(r.estimates) == 2


def test_pmp_descriptor_roundtrip():
    from leansdr_jax.util import pmp
    d = pmp.PmpDescriptor(physaddr=0x1234_5678_9ABC, size=65536,
                          canary=0xDEAD).pack()
    assert len(d) == pmp.DESC_SIZE
    back = pmp.parse(d)
    assert (back.physaddr, back.size, back.canary) == \
        (0x1234_5678_9ABC, 65536, 0xDEAD)
    import pytest
    with pytest.raises(ValueError):
        pmp.parse(b"\x00" * pmp.DESC_SIZE)
