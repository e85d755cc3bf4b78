"""Multi-host (multi-process) scale-out: 2 local CPU processes with 4
virtual devices each form one 8-device 'dp' mesh via jax.distributed;
the tally psum crosses the process boundary (the DCN analogue of
SURVEY.md section 5.8).  Tallies must match the single-process
8-device run — lane keys derive from global indices, so results are
independent of the process layout.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_tallies_match_single_process(tmp_path):
    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "multihost_worker.py")
    out = str(tmp_path / "proc0.npz")
    coord = f"localhost:{_free_port()}"

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, worker, coord, "2", str(i), out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(2)]
    logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"proc {i} failed:\n{logs[i]}"

    got = np.load(out)

    # single-process reference on this process's own 8-device mesh
    import jax
    import __graft_entry__ as ge
    import jax.numpy as jnp
    from montecarloscattering_jl_tpu.ops import state as stt
    from montecarloscattering_jl_tpu.parallel.shard import (
        make_mesh, sharded_run_segment)
    from montecarloscattering_jl_tpu.utils.params import MAX_HELIX_STEPS

    batch = 256
    setup, state, tal, grids, sc, ss = ge._build(batch=batch)
    state = state._replace(
        nsteps=jnp.full(batch, MAX_HELIX_STEPS - 64, jnp.int32))
    mesh = make_mesh(8)
    from montecarloscattering_jl_tpu.parallel.shard import shard_state
    seg = sharded_run_segment(mesh, ss)
    out_state, out_tal = seg(shard_state(state, mesh), tal, grids, sc)
    fin = stt.finalize_tallies(out_tal)

    # lane trajectories are bitwise identical (global-index lane keys);
    # only the cross-process psum reduction ORDER differs from the
    # single-process topology.  num_crossings sums exact integers in
    # f64 — order-independent, so it must match bitwise; weighted sums
    # agree to reduction rounding (~1e-16 relative, near-zero zones
    # anchored by atol).
    np.testing.assert_array_equal(got["num_crossings"],
                                  np.asarray(fin.num_crossings))
    pxx = np.asarray(fin.pxx_flux)
    en = np.asarray(fin.energy_flux)
    psd = np.asarray(fin.psd)
    np.testing.assert_allclose(got["pxx_flux"], pxx, rtol=1e-12,
                               atol=1e-15 * np.abs(pxx).max())
    np.testing.assert_allclose(got["energy_flux"], en, rtol=1e-12,
                               atol=1e-15 * np.abs(en).max())
    np.testing.assert_allclose(got["psd"], psd, rtol=1e-6,
                               atol=1e-6 * np.abs(psd).max())

    # ---- ladder stage: 2-process vs 1-process -------------------------
    # Both sides ran the mesh host-split ladder on the SAME 8-shard
    # mesh inside worker subprocesses; a shard's computation depends
    # only on its lane block, so with equal mesh size results differ
    # only in cross-process reduction order.
    out1 = str(tmp_path / "single.npz")
    env1 = dict(env, MCS_MH_DEVS="8")
    r = subprocess.run(
        [sys.executable, worker, f"localhost:{_free_port()}", "1", "0",
         out1],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env1,
        timeout=600)
    assert r.returncode == 0, f"single-proc worker failed:\n" \
                              f"{r.stdout.decode()}"
    ref = np.load(out1)

    np.testing.assert_array_equal(got["h_n_new"], ref["h_n_new"])
    np.testing.assert_array_equal(got["h_nsteps"], ref["h_nsteps"])
    np.testing.assert_array_equal(got["h_num_crossings"],
                                  ref["h_num_crossings"])
    hp = ref["h_psd"]
    np.testing.assert_allclose(got["h_psd"], hp, rtol=1e-5,
                               atol=1e-6 * (np.abs(hp).max() or 1.0))
    hx = ref["h_pxx_flux"]
    np.testing.assert_allclose(got["h_pxx_flux"], hx, rtol=1e-5,
                               atol=1e-6 * (np.abs(hx).max() or 1.0))
