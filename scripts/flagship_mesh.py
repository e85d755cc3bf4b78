"""Mesh flagship: the nonlinear smoothed shock sharded over a device
mesh (BASELINE.md config 5).

The particle batch shards over a 1-D 'dp' mesh and every pcut segment
runs sharded (parallel/shard.sharded_run_segment) with the tallies
psum'd once per segment and the population split on the host between
segments — the engine users get with --devices N.  Lanes are
independent between tallies, so throughput should scale with the
device count at fixed per-device batch; the per-segment psum and the
host split are the only shared work.

Multi-host pods: pass --multihost to initialize jax.distributed first
(parallel/multihost.py); run one process per host with the same args.

CPU rehearsal (the workflow, not the numbers):
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/flagship_mesh.py --devices 8 --per-pcut 1024 --iters 2
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

from montecarloscattering_jl_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)

enable_compile_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=0,
                    help="mesh size (0 = all visible devices)")
    ap.add_argument("--per-pcut", type=int, default=65536,
                    help="split target per pcut level (global, not "
                    "per device)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--multihost", action="store_true",
                    help="initialize jax.distributed before building "
                    "the mesh (one process per host)")
    ap.add_argument("-o", "--out-dir", default="flagship_mesh_out")
    args = ap.parse_args()

    if args.multihost:
        from montecarloscattering_jl_tpu.parallel.multihost import (
            init_distributed)
        init_distributed()

    import jax.numpy as jnp

    from montecarloscattering_jl_tpu.engine import run
    from montecarloscattering_jl_tpu.parallel.shard import make_mesh
    from montecarloscattering_jl_tpu.utils import load_config

    mesh = make_mesh(args.devices or None)
    print(f"mesh: {mesh.size} devices ({jax.default_backend()})")

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "tests/data/dsa_nonrel.toml"))
    cfg.n_itrs = args.iters
    cfg.do_smoothing = True
    cfg.n_pts_inj = args.per_pcut
    cfg.n_pts_pcut = args.per_pcut
    cfg.n_pts_pcut_hi = args.per_pcut

    t0 = time.perf_counter()
    res = run(cfg, p_dtype=jnp.float64 if args.f64 else jnp.float32,
              mesh=mesh, out_dir=args.out_dir)
    dt = time.perf_counter() - t0
    print(f"wall={dt:.1f}s trajs={res.n_trajectories} "
          f"pushes={res.n_pushes} -> {res.n_trajectories/dt:.0f} "
          f"trajs/s, {res.n_pushes/dt/1e6:.1f} M pushes/s "
          f"({res.n_pushes/dt/1e6/mesh.size:.1f} M/device)")
    print("timers:", {k: round(v, 1)
                      for k, v in res.timers.totals.items()})


if __name__ == "__main__":
    main()
