"""Weak-scaling curve of the mesh pcut ladder.

Runs the same per-shard workload at mesh sizes 1, 2, 4, 8 on the
virtual CPU mesh (or real devices when available) and reports the
per-shard push rate vs mesh size.  Perfect weak scaling = flat
per-shard rate: particle lanes are independent between tallies, so the
only cross-shard work is the per-segment tally psum
(parallel/shard.sharded_run_segment) and the host split between
segments — the measurement quantifies what they cost per added shard.

CPU-mesh numbers measure SCALING SHAPE only; absolute rates come from
a run on the accelerator.

Usage:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/weak_scaling.py --per-shard 8192 --iters 1

Writes one JSON line per mesh size + a summary table to stdout.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

from montecarloscattering_jl_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-shard", type=int, default=8192,
                    help="particle lanes per shard (fixed as the mesh "
                    "grows — weak scaling)")
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--sizes", default="1,2,4,8",
                    help="comma-separated mesh sizes")
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args()
    enable_compile_cache()

    import jax.numpy as jnp

    from montecarloscattering_jl_tpu.engine import run
    from montecarloscattering_jl_tpu.parallel.shard import make_mesh
    from montecarloscattering_jl_tpu.utils import load_config

    sizes = [int(s) for s in args.sizes.split(",")]
    n_dev = len(jax.devices())
    sizes = [s for s in sizes if s <= n_dev]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    rows = []
    for size in sizes:
        cfg = load_config(os.path.join(root,
                                       "tests/data/dsa_nonrel.toml"))
        cfg.n_itrs = args.iters
        cfg.do_smoothing = True
        # weak scaling: global batch grows with the mesh so the
        # per-shard lane count stays fixed
        cfg.n_pts_inj = args.per_shard * size
        cfg.n_pts_pcut = args.per_shard * size
        cfg.n_pts_pcut_hi = args.per_shard * size
        mesh = make_mesh(size) if size > 1 else None

        t0 = time.perf_counter()
        res = run(cfg, p_dtype=jnp.float64 if args.f64
                  else jnp.float32, mesh=mesh)
        dt = time.perf_counter() - t0
        transport = res.timers.totals.get("transport", dt)
        row = {
            "mesh": size,
            "per_shard_lanes": args.per_shard,
            "wall_s": round(dt, 2),
            "transport_s": round(transport, 2),
            "pushes": int(res.n_pushes),
            "mpushes_per_s": round(res.n_pushes / dt / 1e6, 2),
            "mpushes_per_s_per_shard": round(
                res.n_pushes / dt / 1e6 / size, 3),
            "mpushes_per_s_per_shard_transport": round(
                res.n_pushes / max(transport, 1e-9) / 1e6 / size, 3),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    base = rows[0]["mpushes_per_s_per_shard_transport"]
    print("\nmesh  per-shard M/s (transport)  efficiency")
    for r in rows:
        eff = r["mpushes_per_s_per_shard_transport"] / base
        print(f"{r['mesh']:4d}  {r['mpushes_per_s_per_shard_transport']:22.3f}  "
              f"{eff:8.2%}")


if __name__ == "__main__":
    main()
