"""Worker process for the 2-process multi-host test.

Launched by tests/test_multihost.py with:
    python multihost_worker.py <coordinator> <num_procs> <proc_id> <out.npz>

Each process owns MCS_MH_DEVS (default 4) virtual CPU devices; the
global mesh spans num_procs x MCS_MH_DEVS.  Every process builds the
identical full population (deterministic seeds; lane keys derive from
GLOBAL lane indices) and contributes its local shards via
jax.make_array_from_callback.  The tally psum crosses the process
boundary.  Process 0 writes the finalized tallies for the parent to
compare against the single-process run (itself this worker with
num_procs=1, MCS_MH_DEVS=8, so both sides run the same 8-shard mesh).

Stage 1: the sharded segment.  Stage 2: the mesh pcut ladder the
engine runs under --devices N — sharded drains with the population
gathered to every host between segments and split there (ops/cuts),
tallies psum'd per segment.
"""

import os
import sys

_DEVS = int(os.environ.get("MCS_MH_DEVS", "4"))
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={_DEVS}")
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402


def main(coordinator: str, num_procs: int, proc_id: int, out: str):
    from montecarloscattering_jl_tpu.parallel.multihost import (
        global_mesh, global_state, init_distributed)

    init_distributed(coordinator_address=coordinator,
                     num_processes=num_procs, process_id=proc_id)
    assert jax.process_count() == num_procs, jax.process_count()
    assert jax.device_count() == _DEVS * num_procs, jax.device_count()

    import __graft_entry__ as ge
    from montecarloscattering_jl_tpu.ops import state as stt
    from montecarloscattering_jl_tpu.parallel.shard import (
        sharded_run_segment)

    mesh = global_mesh()
    assert mesh.size == _DEVS * num_procs

    batch = 256
    setup, state, tal, grids, sc, ss = ge._build(batch=batch)
    from montecarloscattering_jl_tpu.utils.params import MAX_HELIX_STEPS
    import jax.numpy as jnp
    state = state._replace(
        nsteps=jnp.full(batch, MAX_HELIX_STEPS - 64, jnp.int32))

    state_g = global_state(state, mesh)
    # uncommitted (numpy) inputs are assumed identical on every
    # process and are auto-placed by jit against the shard_map specs
    npify = lambda t: jax.tree.map(np.asarray, t)
    tal, grids, sc = npify(tal), npify(grids), npify(sc)
    seg = sharded_run_segment(mesh, ss)
    out_state, out_tal = seg(state_g, tal, grids, sc)
    jax.block_until_ready(out_tal)
    fin = stt.finalize_tallies(out_tal)

    # tallies are psum-replicated: every process can read them
    if proc_id == 0:
        np.savez(out,
                 pxx_flux=np.asarray(fin.pxx_flux),
                 energy_flux=np.asarray(fin.energy_flux),
                 psd=np.asarray(fin.psd),
                 num_crossings=np.asarray(fin.num_crossings))
    print(f"proc {proc_id} OK: {jax.process_count()} processes, "
          f"{jax.device_count()} devices, mesh {mesh.size}", flush=True)

    # ---- stage 2: the mesh pcut ladder across the process boundary ----
    ladder_out = _run_ladder_stage(mesh)
    if proc_id == 0:
        base = np.load(out)
        np.savez(out, **dict(base), **ladder_out)
    print(f"proc {proc_id} ladder OK", flush=True)


def _gather_state(state):
    """Global lane-sharded state -> the full population as host numpy
    on every process (the host-split loop's per-segment sync)."""
    from jax.experimental import multihost_utils

    data = state._replace(key=jax.random.key_data(state.key))
    return jax.tree.map(
        lambda x: np.asarray(multihost_utils.process_allgather(
            x, tiled=True)), data)


def _run_ladder_stage(mesh):
    """Two pcut segments of the mesh host-split ladder over the global
    mesh: sharded drain (sharded_run_segment), host split of the SAVED
    lanes (ops/cuts.pcut_split, identical on every process), sharded
    drain of the split population.  Returns replicated results as
    numpy."""
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from montecarloscattering_jl_tpu.ops import state as stt
    from montecarloscattering_jl_tpu.ops.cuts import pcut_split
    from montecarloscattering_jl_tpu.parallel.multihost import (
        global_state)
    from montecarloscattering_jl_tpu.parallel.shard import (
        sharded_run_segment)
    from montecarloscattering_jl_tpu.utils.params import MAX_HELIX_STEPS

    batch = 256
    setup, state, tal, grids, sc, ss = ge._build(batch=batch)
    cfg = setup.cfg
    state = state._replace(
        nsteps=jnp.full(batch, MAX_HELIX_STEPS - 400, jnp.int32))
    npify = lambda t: jax.tree.map(np.asarray, t)
    tal_h, grids = npify(tal), npify(grids)
    seg = sharded_run_segment(mesh, ss)

    n_new, nsteps, fins = [], [], []
    # pcuts a few lanes reach within the 400 remaining steps
    p_med = float(np.median(np.hypot(np.asarray(state.pb),
                                     np.asarray(state.pperp))))
    for i, pcut in enumerate((100.0 * p_med, 200.0 * p_med)):
        sci = npify(sc._replace(pcut=jnp.asarray(pcut, sc.pcut.dtype)))
        out_state, out_tal = seg(global_state(state, mesh), tal_h,
                                 grids, sci)
        fins.append(stt.finalize_tallies(out_tal))
        host = _gather_state(out_state)
        nsteps.append(int(host.nsteps.astype(np.int64).sum()))
        split = pcut_split(host, batch, batch)
        n_new.append(0 if split is None else split.n)
        if split is None:
            break
        state = stt.init_state(
            split.weight, np.hypot(split.pb, split.pperp), split.pb,
            split.x, split.igrid, split.ux_prev, cfg.xn_per_fine,
            setup.x_grid_stop, jax.random.key(11 + i), phi=split.phi,
            downstream=split.downstream, inj=split.inj,
            acctime=split.acctime, tcut=split.tcut, xn_per=split.xn_per)
        state = state._replace(prp_x=jnp.asarray(split.prp_x))
    assert n_new[0] > 0, "no lane reached the first pcut"
    psd = sum(np.asarray(f.psd, np.float64) for f in fins)
    ncross = sum(np.asarray(f.num_crossings) for f in fins)
    pxx = sum(np.asarray(f.pxx_flux) for f in fins)
    return {
        "h_psd": psd,
        "h_num_crossings": ncross,
        "h_pxx_flux": pxx,
        "h_n_new": np.asarray(n_new, np.int64),
        "h_nsteps": np.asarray(nsteps, np.uint64),
    }


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
