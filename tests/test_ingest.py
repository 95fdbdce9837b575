"""Double-buffered ingest (util/ingest.py, SURVEY 2.10 P7)."""

import io

import numpy as np

from leansdr_jax.util.ingest import DeviceFeeder, read_chunks


def test_device_feeder_order_and_contents():
    chunks = [np.full((64,), k, np.float32) for k in range(20)]
    out = list(DeviceFeeder(chunks, depth=3))
    assert len(out) == 20
    for k, d in enumerate(out):
        a = np.asarray(d)
        assert a.shape == (64,) and (a == k).all()


def test_device_feeder_overlaps_consumer():
    # A slow consumer must still see every chunk exactly once, and the
    # producer thread must terminate (sentinel drained).
    import time
    chunks = (np.full((8,), k, np.int32) for k in range(10))
    fd = DeviceFeeder(chunks, depth=2)
    seen = []
    for d in fd:
        time.sleep(0.01)
        seen.append(int(np.asarray(d)[0]))
    assert seen == list(range(10))
    fd._thread.join(timeout=5)
    assert not fd._thread.is_alive()


def test_read_chunks_exact_boundaries():
    f = io.BytesIO(bytes(range(250)))
    parts = list(read_chunks(f, 100))
    assert [len(p) for p in parts] == [100, 100, 50]
    assert b"".join(parts) == bytes(range(250))
