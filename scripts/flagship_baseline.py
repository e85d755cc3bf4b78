"""Reference-parity baseline flagship: run configs/baseline.toml —
the key-for-key mirror of the reference's shipped mc_in.toml
(mc_in.toml:11,75-130 of the reference) — to completion on the
accelerator.

The shipped reference config is a gamma0 = 5 parallel shock, protons +
electrons, 20 iterations, 45 pcuts, tcuts + radiative losses + fast
push + custom eps_B, with the testing switches no-scatter / no-DSA ON
and smoothing off (mc_in.toml:132-139) — i.e. the workload the
reference's own input file describes.  --dsa flips those switches to
the physical configuration (scattering + DSA + smoothing) for the
science variant.

Records the convergence/diagnostic dashboard the reference prints to
mc_grid.dat / stdout: r_comp vs r_RH, Gamma_2 vs R-H, escaping-flux
fractions vs q_esc theory, flux-conservation norms, wall time, push
and trajectory totals; writes the full file surface (mc_out, mc_grid,
coupled CSVs, dN/dp grids) to --out-dir.
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
    ap.add_argument("--dsa", action="store_true",
                    help="science variant: scattering + DSA + smoothing")
    ap.add_argument("--pcuts-per-decade", type=int, default=0,
                    help="replace the shipped 45-pcut ladder with a "
                    "geometric one (utils.config.auto_pcut_ladder); "
                    "the shipped ladder's factor-60 first gap cannot "
                    "be climbed at gamma0=5 where P_ret ~ 0.25")
    ap.add_argument("--iters", type=int, default=0,
                    help="override num-iterations (0 = config value)")
    ap.add_argument("--max-helix-steps", type=int, default=0,
                    help="raise the per-segment helix step cap (the "
                    "reference hardcodes 10k with its own FIXME, "
                    "particle_loop.jl:162; a gamma0=5 DSA cycle needs "
                    "~20k fine-scattering steps downstream, so the "
                    "--dsa science run dies by step-cap without this; "
                    "200000 is a good value)")
    ap.add_argument("--n-pts-mult", type=int, default=1,
                    help="multiply the config's particle counts "
                    "(n_pts_inj / n_pts_pcut / n_pts_pcut_hi).  The "
                    "reference's shipped 100/400/2000 counts starve "
                    "the gamma0=5 nonlinear fixed point: once "
                    "smoothing weakens the subshock, 392 lanes "
                    "cannot populate the first pcut and the tallies "
                    "die.  16-64x fixes it.")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--checkpoint", default=None,
                    help="iteration-boundary checkpoint path (engine "
                    "driver passthrough)")
    ap.add_argument("--resume", default=None,
                    help="resume from an iteration or .mid checkpoint")
    ap.add_argument("--mid-every", type=int, default=0,
                    help="with --checkpoint: segment-boundary "
                    "checkpoint every N pcut segments")
    ap.add_argument("-o", "--out-dir", default="flagship_baseline_out")
    args = ap.parse_args()
    if args.max_helix_steps:
        # must land before utils.params is first imported
        os.environ["MCS_MAX_HELIX_STEPS"] = str(args.max_helix_steps)

    import jax.numpy as jnp
    import numpy as np

    from montecarloscattering_jl_tpu.engine import run
    from montecarloscattering_jl_tpu.utils import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", "baseline.toml"))
    if args.dsa:
        cfg.dont_scatter = False
        cfg.dont_dsa = False
        cfg.do_smoothing = True
    if args.pcuts_per_decade:
        from montecarloscattering_jl_tpu.utils.config import (
            auto_pcut_ladder, check_pcuts)
        cfg.pcuts = auto_pcut_ladder(
            cfg.pcuts[0], args.pcuts_per_decade, cfg.emax,
            cfg.emax_per_aa, cfg.pmax)
        check_pcuts(cfg.pcuts, cfg.emax, cfg.emax_per_aa, cfg.pmax)
    if args.iters:
        cfg.n_itrs = args.iters
    if args.n_pts_mult > 1:
        cfg.n_pts_inj *= args.n_pts_mult
        cfg.n_pts_pcut *= args.n_pts_mult
        cfg.n_pts_pcut_hi *= args.n_pts_mult

    t0 = time.perf_counter()
    res = run(cfg, p_dtype=jnp.float64 if args.f64 else jnp.float32,
              out_dir=args.out_dir, checkpoint=args.checkpoint,
              resume=args.resume, mid_every=args.mid_every)
    dt = time.perf_counter() - t0
    setup = res.setup

    print(f"wall={dt:.1f}s iterations={len(res.iterations)} "
          f"species={cfg.n_ions} pcuts={len(cfg.pcuts)}")
    print(f"trajs={res.n_trajectories} pushes={res.n_pushes} "
          f"-> {res.n_trajectories/dt:.0f} trajs/s, "
          f"{res.n_pushes/dt/1e6:.1f} M pushes/s")
    print(f"r_comp={setup.r_comp:.4f} r_RH={setup.r_rh:.4f} "
          f"Gamma2_RH={setup.gamma2_rh:.4f}")
    for i, itr in enumerate(res.iterations):
        pxx = en = float("nan")
        if itr.diag is not None:
            pxx = float(np.max(itr.diag.pxx_norm))
            en = float(np.max(itr.diag.energy_norm))
        print(f"iter {i+1:2d}: Gamma_dw={itr.gamma_downstream:.4f} "
              f"px_esc={itr.px_esc_frac:.4f} "
              f"en_esc={itr.en_esc_frac:.4f} "
              f"q_esc_px={itr.q_esc_px:.4f} q_esc_en={itr.q_esc_en:.4f}"
              f" pxx_norm_max={pxx:.3f} en_norm_max={en:.3f}")
    print("timers:", {k: round(v, 1)
                      for k, v in res.timers.totals.items()})
    for f in ("mc_out.dat", "mc_grid.dat", "mc_coupled_weights.csv",
              "mc_coupled_spectra.csv"):
        p = os.path.join(args.out_dir, f)
        print(f"{f}: {'%d bytes' % os.path.getsize(p) if os.path.exists(p) else 'MISSING'}")


if __name__ == "__main__":
    main()
