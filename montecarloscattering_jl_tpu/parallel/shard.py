"""Multi-chip data parallelism over the particle batch.

The reference is serial with vestigial OpenMP comments
(main_loops.jl:227, all_flux.jl:154); SURVEY.md sections 2/5.8 define
the accelerator equivalent: shard the particle batch over a 1-D device
mesh ('dp' axis), run each shard's helix while_loop independently (no
collectives in the hot loop — lanes are independent between tallies),
and psum the tally pytree once per segment.  TP/PP/SP/EP have no
counterpart in this workload (recorded N/A by design).  The devices
are joined all to all, so the mesh needs no topology shaping.

Determinism: lane RNG keys are derived from the GLOBAL lane index
before sharding and the engine splits pcut populations on the host
between segments, so per-lane trajectories are bitwise independent of
the mesh shape; only the tally summation order differs.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import state as stt
from ..ops import step as stp

DP_AXIS = "dp"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D data-parallel mesh over the available devices.

    With ``n_devices`` set, fewer available devices is an error — a
    silently truncated mesh would "validate" multi-chip semantics on a
    smaller (or single-device) mesh while claiming the requested size.
    """
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devs)} device(s) are visible "
                f"({jax.default_backend()} backend); force a virtual "
                f"CPU mesh with JAX_PLATFORMS=cpu and "
                f"--xla_force_host_platform_device_count={n_devices}")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (DP_AXIS,))


def _state_spec() -> stt.ParticleState:
    """PartitionSpec pytree: every per-lane array sharded on axis 0."""
    return jax.tree.map(lambda _: P(DP_AXIS), stt.ParticleState(
        *([0] * len(stt.ParticleState._fields))))


def sharded_run_segment(mesh: Mesh, ss: stp.StepStatic,
                        compact_levels: int = 0):
    """Build the jitted sharded segment runner for a static config.

    Returns f(state, tallies, grids, sc) -> (state, tallies) with the
    state sharded over lanes and tallies psum-reduced (replicated).
    compact_levels applies the live-lane compaction ladder per shard
    (each shard drains its own lanes; no collectives in the ladder).
    """
    state_spec = _state_spec()
    # tally record buffers carry a lane axis and shard with the batch;
    # everything else is replicated (and psum-reduced on the way out)
    tally_spec = stt.Tallies(*[P() for _ in stt.Tallies._fields])._replace(
        rec=P(None, None, DP_AXIS))

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(state_spec, tally_spec, P(), P()),
             out_specs=(state_spec, tally_spec),
             check_vma=False)
    def seg(state, tallies, grids, sc):
        s, t = stp.run_segment(state, tallies, grids, sc, ss,
                               compact_levels)
        # one reduction per segment: the analogue of the reference's
        # "omp critical" tally sections
        t = jax.tree.map(lambda x: jax.lax.psum(x, DP_AXIS), t)
        return s, t

    return jax.jit(seg, donate_argnums=(0, 1))


def shard_state(state: stt.ParticleState, mesh: Mesh) -> stt.ParticleState:
    """Place a host-built state onto the mesh, lanes sharded."""
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        state, _state_spec())


def pad_to_devices(n: int, n_devices: int, multiple: int = 128) -> int:
    """Batch size divisible by both the lane multiple and the mesh."""
    m = multiple * n_devices
    return ((n + m - 1) // m) * m
