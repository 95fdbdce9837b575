"""Driver-surface checks for __graft_entry__.py.

The round driver compile-checks `entry()` single-chip and executes
`dryrun_multichip(N)` on N virtual CPU devices; these tests keep both
surfaces from rotting between rounds (the round-4 dryrun regression —
an over-strict deconv.kind assert plus a startup-imported platform
plugin overriding JAX_PLATFORMS — would have been caught here).
"""

import sys
from pathlib import Path

import jax

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def test_entry_compiles_and_runs():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    # (state, outputs) pytree with at least one finite array.
    leaves = jax.tree_util.tree_leaves(out)
    assert leaves, "entry() step produced an empty pytree"


def test_dryrun_multichip_small():
    import __graft_entry__ as g

    # 2 virtual devices (conftest forces 8 CPU devices, so 2 exist).
    # Asserts inside dryrun_multichip verify TS decode + payloads.
    g.dryrun_multichip(2)
