"""BASELINE.json config 5: large trajectory counts sharded over a
device mesh.

Shards the particle batch over every available device ('dp' axis)
and scales the per-pcut population with the mesh — the same program
on four GPUs or on the virtual 8-device CPU mesh used in CI:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/05_pod_scale.py --per-chip 2048

Determinism note: lane RNG is keyed by global lane index, so the
physics is bitwise independent of how many devices participate.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

from montecarloscattering_jl_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-chip", type=int, default=2048,
                    help="particles per pcut per chip")
    ap.add_argument("--iterations", type=int, default=1)
    ap.add_argument("--f32", action="store_true")
    args = ap.parse_args()
    enable_compile_cache()

    import jax.numpy as jnp

    from montecarloscattering_jl_tpu.engine.driver import run
    from montecarloscattering_jl_tpu.parallel import make_mesh
    from montecarloscattering_jl_tpu.utils import load_config

    n_dev = len(jax.devices())
    mesh = make_mesh() if n_dev > 1 else None
    print(f"devices: {n_dev} x {jax.devices()[0].platform}")

    cfg = load_config(os.path.join(os.path.dirname(__file__),
                                   "01_test_particle.toml"))
    cfg.n_itrs = args.iterations
    cfg.n_pts_inj = args.per_chip * n_dev
    cfg.n_pts_pcut = args.per_chip * n_dev
    cfg.n_pts_pcut_hi = args.per_chip * n_dev

    t0 = time.time()
    res = run(cfg, mesh=mesh,
              p_dtype=jnp.float32 if args.f32 else jnp.float64)
    dt = time.time() - t0
    print(f"{res.n_trajectories} trajectories, {res.n_pushes} pushes "
          f"in {dt:.1f}s -> {res.n_pushes / dt / 1e6:.2f} M pushes/s "
          f"({res.n_pushes / dt / 1e6 / n_dev:.2f} M/s/chip)")
    last = res.iterations[-1]
    # test-particle mode has no back-reaction, so the escaping energy
    # flux can exceed the far-upstream flux (>1 is expected here; the
    # smoothed config of example 02 drives this below 1)
    print(f"escaping / far-upstream energy flux: {last.en_esc_frac:.4f};"
          f" Gamma_downstream = {last.gamma_downstream:.4f}")


if __name__ == "__main__":
    main()
