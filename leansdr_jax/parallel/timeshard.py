"""Time-axis sharding of the RECURRENT receiver stages with loop-state
handoff between sequential block owners (SURVEY.md section 5.7 / P8).

The feed-forward stages shard trivially (halo.sharded_fir); the PLL /
timing / AGC recurrence cannot — block s+1's state depends on block s.
The device-native answer is a ring pipeline over the `time` mesh axis:

  * stream j's block s is RESIDENT on device (j + s) mod D — a diagonal
    layout, so consecutive blocks of one stream sit on neighboring
    devices;
  * at superstep s every device demodulates one block of a DIFFERENT
    stream, then every stream's loop state rotates one hop around the
    ring (one `ppermute` over ICI, O(state) = a few KB per stream);
  * the state that reaches block s+1's owner has seen every prior
    sample of that stream, so the recurrence is honored EXACTLY — the
    decoded symbols are bit-identical to a single-device run (tested in
    tests/test_parallel.py).

All D devices stay busy every superstep once D streams are in flight
(the reference's multi-process pipeline, leanmlmrx.cc:54-78, has the
same fill property).  Handoff latency rides the ICI ring, never DCN.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..dsp import receiver


def diagonal_layout(x: np.ndarray, block: int, ra: int) -> np.ndarray:
    """[D, n, 2] stream-major samples -> ins[D, S, block+ra, 2] in the
    diagonal (resident) layout: ins[d, s] = samples
    [s*block, s*block + block + ra) of stream (d - s) mod D."""
    D, n, _ = x.shape
    S = (n - ra) // block
    ins = np.empty((D, S, block + ra, 2), x.dtype)
    for d in range(D):
        for s in range(S):
            j = (d - s) % D
            ins[d, s] = x[j, s * block:s * block + block + ra]
    return ins


def undiagonal(outs: np.ndarray, D: int) -> np.ndarray:
    """[S, D, ...] superstep-major kernel output -> [D, S, ...] in
    stream-major order: stream j's block s was computed on device
    (j + s) mod D."""
    S = outs.shape[0]
    return np.stack([np.stack([outs[s, (j + s) % D] for s in range(S)])
                     for j in range(D)])


def ring_stream_demod(params: receiver.ReceiverParams, mesh: Mesh,
                      axis: str = "time"):
    """Build the jitted ring-pipelined demodulator.

    Returns fn(tables, state, ins) with
      state: receiver.init_state(params, D) — leaf axis 0 sharded over
             the ring; entry d starts as stream d's state;
      ins:   diagonal_layout(...) as a [D, S, B+ra, 2] device array
             sharded on axis 0;
    -> (final state [D, ...], outputs with leaves [S, D, ...]
        superstep-major; see undiagonal()).
    """
    D = mesh.devices.size
    perm = [(i, (i + 1) % D) for i in range(D)]

    def local(tables, st, ins):
        # ins local: [1, S, B+ra, 2]; st leaves [1, ...].
        def step(carry, xb):
            s, out = receiver.run_chunks_impl(params, tables, carry,
                                              xb[None])
            s = jax.tree.map(
                lambda a: jax.lax.ppermute(a, axis, perm), s)
            return s, out        # leaves [1, ...]; axis 1 = device
        st, outs = jax.lax.scan(step, st, ins[0])
        return st, outs

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(axis), P(None, axis)),
        check_vma=False,
    )
    return jax.jit(fn)
