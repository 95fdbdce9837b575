"""Ring-compaction butterfly (fec/deconv_device.deconv_append) contract.

The append was rewritten from a bitonic key sort to a monotone-routing
butterfly (log2 passes instead of ~log^2). The ring contract it must
keep, chunk after chunk, including fleet-drift drag events:

  1. data below each channel's pre-drag fill is preserved;
  2. the chunk's valid symbols (and costs) land contiguously at the
     (possibly dragged) fill;
  3. fill advances by the valid count, clamped to the write-window cap.

Rows between a laggard's old fill and its dragged fill are garbage BY
DESIGN (both the sort and the butterfly leave arbitrary bytes there;
framing re-locks through the discontinuity).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from leansdr_jax.fec.deconv_device import (DELTA_MAX, deconv_append,
                                           make_plan)


@pytest.mark.parametrize("store_costs", [True, False])
def test_append_butterfly_ring_contract(store_costs):
    rng = np.random.default_rng(42)
    C, n = 5, 1 << 12
    D = DELTA_MAX
    plan = make_plan("1/2", C, n, 2.0, store_costs=store_costs)
    cap = plan.cap
    st = {"buf": jnp.asarray(rng.integers(0, 4, (cap, C)).astype(np.uint8)),
          "cost": jnp.asarray(
              rng.integers(-32768, 0, (cap, C)).astype(np.int16)),
          "fill": jnp.asarray(rng.integers(0, 200, C).astype(np.int32))}
    fills = np.asarray(st["fill"]).copy()
    for it in range(3):
        sym = rng.integers(0, 4, (n, C)).astype(np.uint8)
        # Wildly different densities force drag events across chunks.
        valid = rng.random((n, C)) < rng.uniform(0.2, 0.9)
        cost = rng.integers(-32768, 0, (n, C)).astype(np.int16)
        pre = {k: np.asarray(v).copy() for k, v in st.items()}
        st = deconv_append(plan, st, jnp.asarray(sym), jnp.asarray(valid),
                           jnp.asarray(cost) if store_costs else None)
        dragged = np.maximum(fills, fills.max() - (D - 1))
        b = np.asarray(st["buf"])
        cc = np.asarray(st["cost"])
        f = np.asarray(st["fill"])
        for c in range(C):
            vs = sym[valid[:, c], c]
            assert f[c] == min(dragged[c] + len(vs), cap - D - n)
            keep = min(fills[c], dragged[c])
            np.testing.assert_array_equal(b[:keep, c], pre["buf"][:keep, c])
            np.testing.assert_array_equal(
                b[dragged[c]:dragged[c] + len(vs), c], vs)
            if store_costs:
                vc = cost[valid[:, c], c]
                np.testing.assert_array_equal(cc[:keep, c],
                                              pre["cost"][:keep, c])
                np.testing.assert_array_equal(
                    cc[dragged[c]:dragged[c] + len(vc), c], vc)
        fills = f.copy()
