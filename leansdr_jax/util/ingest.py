"""Double-buffered host->device ingest (SURVEY.md 2.10 P7: the device
replacement for the reference's Unix-pipe sample transport).

A background thread reads/convert/uploads chunk k+1 while the device
processes chunk k, hiding transfer latency behind compute. Works with
any callable source of [n, ...] numpy chunks.
"""

import queue
import threading

import jax
import jax.numpy as jnp


class DeviceFeeder:
    """Iterate device-resident chunks with one-chunk prefetch."""

    def __init__(self, chunks, device=None, depth: int = 2):
        """chunks: iterable of numpy arrays. depth: prefetch queue size."""
        self._q = queue.Queue(maxsize=depth)
        self._device = device or jax.devices()[0]
        self._thread = threading.Thread(
            target=self._pump, args=(iter(chunks),), daemon=True)
        self._thread.start()

    def _pump(self, it):
        try:
            for a in it:
                self._q.put(jax.device_put(a, self._device))
        finally:
            self._q.put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item


def read_chunks(f, nbytes: int):
    """Yield successive byte chunks from a binary stream."""
    while True:
        b = f.read(nbytes)
        if not b:
            return
        yield b
