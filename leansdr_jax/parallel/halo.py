"""Overlap-save FIR filtering sharded over a `time` mesh axis.

The device-native replacement for the reference's zero-copy sample transport
(PMP descriptors, SURVEY.md section 2.10 P8): when a single channel must
exceed one chip's throughput, the sample stream is sharded into
contiguous time blocks across devices, and the feed-forward filter stages
exchange their ncoeffs-1-sample boundary overlap with the left neighbor
via `ppermute` over ICI. Loop-state handoff between sequential block
owners (for the recurrence stages) uses the same neighbor pattern; it is
O(KB) per step (SURVEY.md section 5.7).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def make_time_mesh(devices=None, axis: str = "time") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def sharded_fir(coeffs: np.ndarray, mesh: Mesh, axis: str = "time"):
    """Build a jitted time-sharded FIR: y[t] = sum_k c[k] * x[t-k].

    x is [n] complex64 (n divisible by the mesh size). Each device
    convolves its local block using a left halo of ncoeffs-1 samples
    received from its left neighbor over ICI (zeros at the stream head).
    Output matches the 'same-causal' convolution: y = conv(x, c)[:n].
    """
    c = jnp.asarray(np.asarray(coeffs))
    nc = len(coeffs)
    ndev = mesh.devices.size

    def local(xb):
        # xb: local [n/D] block. Fetch the previous block's tail.
        tail = xb[-(nc - 1):]
        left = jax.lax.ppermute(
            tail, axis, [(i, (i + 1) % ndev) for i in range(ndev)])
        idx = jax.lax.axis_index(axis)
        left = jnp.where(idx == 0, jnp.zeros_like(left), left)
        ext = jnp.concatenate([left, xb])          # [nc-1 + n/D]
        # Causal FIR via correlation with reversed taps.
        y = jnp.convolve(ext, c, mode="valid")     # [n/D]
        return y

    fn = shard_map(local, mesh=mesh, in_specs=P(axis), out_specs=P(axis),
                   check_vma=False)
    return jax.jit(fn)
