"""Flagship single-device run: nonlinear smoothed shock to
convergence at production batch size (BASELINE.md config 2), with
wall time, pushes/s, per-iteration convergence and the phase timers.
The convergence signal is the max pxx_flux / far-upstream-flux
overshoot, which should decay toward 1 over the iterations.

Usage:

    python scripts/flagship_nonlinear.py [--per-pcut 65536] [--iters 10]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from montecarloscattering_jl_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)

enable_compile_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-pcut", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("-o", "--out-dir", default="flagship_out")
    args = ap.parse_args()

    import jax.numpy as jnp

    from montecarloscattering_jl_tpu.engine import run
    from montecarloscattering_jl_tpu.utils import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "tests/data/dsa_nonrel.toml"))
    cfg.n_itrs = args.iters
    cfg.do_smoothing = True
    cfg.n_pts_inj = args.per_pcut
    cfg.n_pts_pcut = args.per_pcut
    cfg.n_pts_pcut_hi = args.per_pcut

    t0 = time.perf_counter()
    res = run(cfg, p_dtype=jnp.float64 if args.f64 else jnp.float32,
              out_dir=args.out_dir)
    dt = time.perf_counter() - t0
    print(f"wall={dt:.1f}s trajs={res.n_trajectories} "
          f"pushes={res.n_pushes} -> {res.n_trajectories/dt:.0f} trajs/s,"
          f" {res.n_pushes/dt/1e6:.1f}M pushes/s")
    for i, itr in enumerate(res.iterations):
        pxx = float(max(itr.diag.pxx_norm)) if itr.diag else float("nan")
        print(f"iter {i+1}: gamma_dw={itr.gamma_downstream:.4f} "
              f"en_esc={itr.en_esc_frac:.4f} pxx_norm_max={pxx:.3f}")
    print("timers:", {k: round(v, 1)
                      for k, v in res.timers.totals.items()})
    sub = getattr(res, "subtimers", None)
    if sub:
        print("transport breakdown:", {k: round(v, 1)
                                       for k, v in sub.items()})


if __name__ == "__main__":
    main()
