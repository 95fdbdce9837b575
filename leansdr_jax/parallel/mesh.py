"""Multi-chip scaling: channel sharding over a device mesh.

The framework's dominant parallel axis is `channel` — independent carriers
demodulated in lockstep (SURVEY.md sections 2.10/5.8: the device-native
replacement for leansdr's process-level and thread-level parallelism).
Each device owns a channel shard; the demodulator scan runs fully locally,
and only scalar metrics (lock quality, MER aggregation for scan election)
cross the ICI as collectives.

A `time` axis (overlap-save halo exchange via ppermute for the
feed-forward filter stages) is the second mesh dimension once a single
channel must exceed one chip's throughput.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..dsp import receiver


def make_channel_mesh(devices=None, axis: str = "channel") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def sharded_demod_step(params: receiver.ReceiverParams, mesh: Mesh):
    """Build a jitted multi-chip demod step.

    Channels are sharded over the mesh axis; per-device the full scan
    demodulator runs on its local channel block; a `pmean` of MER across
    the mesh demonstrates the metrics-reduction collective used by the
    scan-election supervisor.

    Returns step(tables, state, x) -> (state, outputs, mean_mer).
    """
    spec_c = P("channel")
    # state: every leaf is [C, ...] -> shard along channel axis.
    state_spec = spec_c
    tab_spec = P()           # tables replicated

    def local_step(tables, state, x):
        state, out = receiver.run_chunks_impl(params, tables, state, x)
        mean_mer = jax.lax.pmean(jnp.mean(out["mer"]), "channel")
        return state, out, mean_mer

    fn = shard_map(
        local_step, mesh=mesh,
        in_specs=(tab_spec, state_spec, spec_c),
        out_specs=(state_spec, spec_c, P()),
        check_vma=False,
    )
    return jax.jit(fn)
