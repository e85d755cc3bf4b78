"""Multi-host scale-out: jax.distributed over the particle batch.

SURVEY.md section 5.8 prescribes "a `jax.distributed` + pjit/shard_map
layer over a 1-D (or 2-D batch x host) device mesh" as the accelerator
equivalent of the reference's (vestigial) OpenMP parallelism
(main_loops.jl:227).  Data parallelism over particles is the only
strategy the physics admits; this module adds the multi-PROCESS story
on top of parallel/shard.py:

  * `init_distributed` wires the process into the jax.distributed
    cluster (coordinator + process id), after which `jax.devices()`
    spans every host and the existing `make_mesh()` builds a global
    1-D 'dp' mesh.  Tally psums cross the process boundary where the
    mesh does — XLA inserts the collectives from the mesh.
  * `global_state` turns the host-built (replicated) population into a
    global array sharded over the mesh.  Every process builds the SAME
    full population from the same seeds (lane keys derive from GLOBAL
    lane indices, ops/state.init_state), so any process can serve any
    shard and results stay bitwise independent of the process count —
    the multi-host extension of the mesh-shape-invariance contract
    (tests/test_parallel.py).

Nothing on a plain GPU host tells JAX of a cluster, so the
coordinator address, process count and process id are passed
explicitly (tests/test_multihost.py drives 2 local CPU processes over
a virtual 8-device mesh).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .shard import DP_AXIS, make_mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join the jax.distributed cluster (no-op if already initialized).

    Unless the platform is pinned to the CPU, each process opens only
    local card ``process_id`` (``local_device_ids``): one process per
    card on one host, because a second JAX process on a card the first
    holds fails for want of device memory.
    """
    # jax.process_count() would itself initialize the backend; use the
    # side-effect-free probe
    if jax.distributed.is_initialized():
        return
    kw = {}
    if coordinator_address is not None:
        kw = dict(coordinator_address=coordinator_address,
                  num_processes=num_processes, process_id=process_id)
        platforms = (jax.config.jax_platforms or "").lower()
        if process_id is not None and not platforms.startswith("cpu"):
            kw["local_device_ids"] = [process_id]
    jax.distributed.initialize(**kw)


def global_mesh() -> Mesh:
    """1-D 'dp' mesh over every device of every process."""
    return make_mesh()


def _put_leaf(x, mesh: Mesh, spec: P):
    """Host-replicated leaf -> global array with the given spec.

    Handles PRNG key arrays (extended dtypes can't ride
    make_array_from_callback: globalize the raw counter words and
    re-wrap)."""
    if jax.dtypes.issubdtype(getattr(x, "dtype", None),
                             jax.dtypes.prng_key):
        data = np.asarray(jax.random.key_data(x))
        impl = str(jax.random.key_impl(x))
        g = jax.make_array_from_callback(
            data.shape, NamedSharding(mesh, spec),
            lambda idx: data[idx])
        return jax.random.wrap_key_data(g, impl=impl)
    x = np.asarray(x)
    return jax.make_array_from_callback(
        x.shape, NamedSharding(mesh, spec), lambda idx: x[idx])


def global_state(state, mesh: Mesh):
    """Host-replicated population -> global array sharded over lanes.

    Every process holds the identical full-batch state (deterministic
    seeds); each serves the shards that live on its local devices.
    """
    return jax.tree.map(lambda x: _put_leaf(x, mesh, P(DP_AXIS)), state)
