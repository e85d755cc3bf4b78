"""Command-line driver: python -m montecarloscattering_jl_tpu [options].

The CLI face of the framework, replacing the reference's (@main) entry
(MonteCarloScattering.jl:60): read a TOML config, run the nonlinear
loop, write the output-file surface.
"""

import argparse
import logging
import os
import sys
import time


# --platform choice -> jax_platforms value: JAX names the NVIDIA backend
# "cuda" ("gpu" would also try to initialize ROCm and fail)
JAX_PLATFORMS = {"gpu": "cuda", "cpu": "cpu"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="montecarloscattering_jl_tpu",
        description="Nonlinear Monte Carlo DSA shock runs on an "
                    "accelerator (JAX/XLA)")
    ap.add_argument("config", nargs="?", default="mc_in.toml",
                    help="TOML run configuration (default: mc_in.toml)")
    ap.add_argument("-o", "--out-dir", default=".",
                    help="output directory (default: cwd)")
    ap.add_argument("--platform", choices=[*JAX_PLATFORMS, "default"],
                    default="default", help="force a JAX platform")
    ap.add_argument("--devices", type=int, default=0,
                    help="shard the particle batch over N devices "
                         "(0 = all available when > 1)")
    ap.add_argument("--f32", action="store_true",
                    help="float32 momenta (positions stay float64)")
    ap.add_argument("--checkpoint", default=None,
                    help="write a checkpoint here after every iteration")
    ap.add_argument("--resume", default=None,
                    help="resume from a checkpoint (iteration-boundary "
                         "NPZ or segment-boundary .mid, auto-detected)")
    ap.add_argument("--mid-every", type=int, default=0,
                    help="with --checkpoint: also write a "
                         "segment-boundary checkpoint (<path>.mid) "
                         "every N pcut segments so a kill mid-species "
                         "resumes inside the transport ladder")
    ap.add_argument("--no-fused", action="store_true",
                    help="use host-side pcut splitting instead of the "
                         "fused on-device ladder")
    ap.add_argument("--compact-levels", type=int, default=-1,
                    help="live-lane compaction ladder depth "
                         "(-1 auto, 0 off)")
    ap.add_argument("--coordinator", default=None,
                    help="multi-host: jax.distributed coordinator "
                         "address (host:port)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="multi-host: total process count")
    ap.add_argument("--process-id", type=int, default=None,
                    help="multi-host: this process's id")
    ap.add_argument("-v", "--verbose", action="store_true")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(message)s")

    import jax
    if args.platform != "default":
        jax.config.update("jax_platforms", JAX_PLATFORMS[args.platform])
    jax.config.update("jax_enable_x64", True)
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    import jax.numpy as jnp

    from .engine.driver import run
    from .utils import load_config

    if not os.path.exists(args.config):
        print(f"error: config file {args.config!r} not found",
              file=sys.stderr)
        return 2

    if args.coordinator is not None or args.num_processes is not None:
        from .parallel.multihost import init_distributed
        init_distributed(coordinator_address=args.coordinator,
                         num_processes=args.num_processes,
                         process_id=args.process_id)

    cfg = load_config(args.config)
    mesh = None
    if args.devices != 1 and len(jax.devices()) > 1:
        from .parallel import make_mesh
        mesh = make_mesh(args.devices or None)

    t0 = time.time()
    result = run(cfg, out_dir=args.out_dir,
                 p_dtype=jnp.float32 if args.f32 else jnp.float64,
                 mesh=mesh, checkpoint=args.checkpoint,
                 resume=args.resume, fused=not args.no_fused,
                 compact_levels=args.compact_levels,
                 mid_every=args.mid_every)
    dt = time.time() - t0
    print(f"finished: {len(result.iterations)} iterations, "
          f"{result.n_trajectories} trajectories, "
          f"{result.n_pushes} pushes in {dt:.1f}s "
          f"({result.n_pushes / max(dt, 1e-9) / 1e6:.2f} M pushes/s)")
    print(f"outputs written to {os.path.abspath(args.out_dir)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
