"""Smoke-drive one transport segment on the baseline config.

Uses the engine API (build_setup + TransportEngine) — the same
construction path as bench.py and the CLI — so the script cannot drift
from the kernel signatures.  Runs on CPU by default (SMOKE_CPU=0 keeps
the hardware backend).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

if os.environ.get("SMOKE_CPU", "1") == "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from montecarloscattering_jl_tpu.engine.run import TransportEngine  # noqa: E402
from montecarloscattering_jl_tpu.engine.setup import build_setup  # noqa: E402
from montecarloscattering_jl_tpu.models.injection import init_pop  # noqa: E402
from montecarloscattering_jl_tpu.ops import state as stt  # noqa: E402
from montecarloscattering_jl_tpu.ops import step as stp  # noqa: E402
from montecarloscattering_jl_tpu.utils import load_config  # noqa: E402
from montecarloscattering_jl_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)


def main(n_pts=100, seed=3):
    enable_compile_cache()
    # the DSA test config (baseline.toml ships the reference's
    # no-scatter/no-DSA smoke switches, mc_in.toml:132-139, under
    # which lanes just reflect at the shock)
    cfg = load_config(os.path.join(os.path.dirname(__file__), "..",
                                   "tests", "data", "dsa_nonrel.toml"))
    setup = build_setup(cfg)
    eng = TransportEngine(setup)
    prof = setup.profile
    grids = eng.segment_grids(prof)
    sc = eng.segment_scalars(0, 2, prof.bmag2)
    ss = eng.step_static(0)

    rng = np.random.default_rng(seed)
    pop = init_pop(rng, cfg.species, 0, 1, cfg.energy_inj, True, n_pts,
                   setup.x_grid_start, cfg.rg0, 1.0, True, -1.0,
                   cfg.beta0, cfg.gamma0, cfg.u0, setup.x_grid_rg,
                   prof.ux_sk, prof.gamma_sf)
    n = len(pop.ptot_pf)

    state = stt.init_state(pop.weight, pop.ptot_pf, pop.pb_pf, pop.x_cm,
                           pop.i_grid, prof.ux_sk[pop.i_grid],
                           cfg.xn_per_fine, setup.x_grid_stop,
                           jax.random.key(1))
    tal = stt.make_tallies(setup.nb, setup.bins.n_mom,
                           setup.bins.n_theta, ss.n_xspec, 1,
                           jnp.float32, batch=n, chunk=8)
    t0 = time.time()
    state2, tal2 = stp.run_segment_jit(state, tal, grids, sc, ss)
    jax.block_until_ready(state2)
    dt = time.time() - t0
    fin = stt.finalize_tallies(tal2)
    pxx = np.asarray(fin.pxx_flux)
    en = np.asarray(fin.energy_flux)
    f_px, f_en = setup.f_px_upstream, setup.f_energy_upstream
    print(f"{n} particles, segment {dt:.1f}s; statuses:",
          np.bincount(np.asarray(state2.status), minlength=3),
          "reasons:", np.bincount(np.asarray(state2.reason), minlength=5))
    print("steps max/mean:", int(state2.nsteps.max()),
          round(float(state2.nsteps.mean()), 1))
    print("pxx/F_px bnd 60..75:", np.round(pxx[60:76] / f_px, 3))
    print("en/F_en  bnd 60..75:", np.round(en[60:76] / f_en, 3))
    print("psd totals: cr", float(fin.psd.sum()),
          " therm", float(fin.therm_psd.sum()))
    print("final x/rg0 pct:",
          np.percentile(np.asarray(state2.x) / cfg.rg0, [5, 50, 95]).round(3))
    return state2, fin, cfg, setup


if __name__ == "__main__":
    main(n_pts=int(sys.argv[1]) if len(sys.argv) > 1 else 100)
