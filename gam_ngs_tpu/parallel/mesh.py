"""Device-mesh construction for the sharded pipeline.

The workload's parallel structure (SURVEY.md §2.7): alignment problems
and read-table rows are embarrassingly parallel, so the mesh is used
data-parallel — the batch axis is sharded over every device, and the
only collectives are reductions of library statistics / global counters
(psum over the whole mesh) plus gathers of per-partition results.

The mesh is one flat axis.  The cards of one host reach each other
all-to-all at the same rate (NVLink), so there is no topology for a
second axis to follow.

The DP band axis (301 lanes) is deliberately NOT sharded across
devices: one band row is a few hundred integers, so splitting it would
turn every DP step into a cross-device exchange.  Long alignments are
instead decomposed in time (chained windows, ops.bsw_batch) and across
problems in space.
"""

from __future__ import annotations

import numpy as np

DATA_AXIS = "part"   # graph-partition / problem-batch axis


def device_mesh(n_devices: int | None = None):
    """Build a 1-D `(part,)` Mesh over the first n local devices."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise RuntimeError(f"need {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (DATA_AXIS,))
