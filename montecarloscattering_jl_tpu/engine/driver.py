"""Top-level run driver: iteration fixed point + per-ion reductions.

Replaces the reference's (@main) body after setup plus iter_finalize /
ion_finalize (MonteCarloScattering.jl:600-654, iter_finalize.jl:1-146,
ion_finalize.jl:1-84).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..models.rankine_hugoniot import q_esc_calcs
from ..models.smoothing import (
    SmoothDiagnostics, set_gamma_adiab_grid, smooth_grid)
from ..ops import reduce as red
from ..ops.finish import EscapeTallies
from ..utils import constants as K
from ..utils.config import RunConfig, load_config
from .run import IterationTallies, TransportEngine
from .setup import RunSetup, build_setup

log = logging.getLogger("mcs.driver")


@dataclass
class IonFinal:
    """Per-(iteration, ion) reduction products (ion_finalize.jl:1-84)."""

    dndp_therm: np.ndarray      # [n_mom+1, nb, 3] normalized dN/dp
    dndp_cr: np.ndarray         # [n_mom+1, nb, 3]
    zone_pop: np.ndarray        # [nb]
    zone_vol: np.ndarray
    p_psd_par: np.ndarray       # [nb]
    p_psd_perp: np.ndarray
    energy_density_psd: np.ndarray
    d2n_ef: np.ndarray | None   # ISM-frame d2N/(dp dcos) (electron IC)
    esc: EscapeTallies
    psd: np.ndarray
    therm_psd: np.ndarray
    num_crossings: np.ndarray
    spectra_sf: np.ndarray      # x_spec detector spectra [n_mom+1, nx]
    spectra_pf: np.ndarray
    n_pushes: int
    n_trajectories: int


@dataclass
class IterationResult:
    ion_finals: list
    tallies: IterationTallies
    diag: SmoothDiagnostics
    gamma_downstream: float
    q_esc_px: float
    q_esc_en: float
    px_esc_frac: float
    en_esc_frac: float
    profile_after: object = None
    emission: object = None     # EmissionResult when do_photons


@dataclass
class RunResult:
    setup: RunSetup
    iterations: list = field(default_factory=list)
    wall_time: float = 0.0
    n_pushes: int = 0
    n_trajectories: int = 0
    timers: object = None   # PhaseTimers
    subtimers: object = None  # MCS_SUBTIMERS=1 transport breakdown

    @property
    def last(self) -> IterationResult:
        return self.iterations[-1]


def ion_finalize_start(setup: RunSetup, res, prof, i_ion: int,
                       want_d2n_ef: bool):
    """Dispatch the per-species device reduction NOW (async) and
    return ``finish() -> IonFinal`` carrying the blocking work.

    Split so the driver can overlap species i's reduction with species
    i+1's transport: the fused device program is
    queued before the next ladder's programs (in-order device stream),
    while the fetches + f64 host normalization run on a worker thread
    during the next ladder's async dispatch loop.  The math and its
    ordering are identical to a synchronous call."""
    cfg, bins = setup.cfg, setup.bins
    s = cfg.species[i_ion]
    e0 = s.rest_energy

    # The PSD blocks arrive device-resident on single-process runs (the
    # transport engine skips their D2H so ion_reduce_device can consume
    # them in place).  IonFinal lives for the whole run inside
    # RunResult.iterations, so storing the device arrays would grow HBM
    # by ~2 PSD blocks per (iteration, ion).  Kick the host copies off
    # now so the transfer overlaps the device reductions below.
    for a in (res.psd, res.therm_psd):
        if hasattr(a, "copy_to_host_async"):
            a.copy_to_host_async()

    # cell-weight spreading mode: the reference hardcodes the scalene
    # triangle (i_approx=2, particle_counter.jl:72) and errors on the
    # exact mode 3 (transformers.jl:132-134); here 3 is implemented
    # (ops/reduce._exact_cdf) and selectable
    i_approx = int(os.environ.get("MCS_I_APPROX", "2"))

    zone_pop, zone_vol = red.zone_populations(
        setup.x_grid_cm, setup.i_shock, s.number_density, cfg.beta0,
        cfg.gamma0, cfg.jet_rad_pc, cfg.jet_sph_frac, prof.ux_sk,
        prof.gamma_sf)

    # one fused device program for every boost/rebin in this reduction
    # (one dispatch and one fetch instead of four of each); the
    # ~1e50-scale zone-population normalization of the ISM-frame
    # d2N stays on the host in f64 (it overflows f32 and commutes with
    # the per-zone boost)
    out = red.ion_reduce_device(
        res.psd, res.therm_psd, bins, e0, prof.gamma_sf,
        prof.ux_sk, cfg.gamma0, i_approx=i_approx, want_ef=want_d2n_ef,
        fetch=False)

    def finish() -> IonFinal:
        dn_cr, dn_th, d2n_tot, d2n_ef = jax.device_get(out)
        dn_cr, dn_th, d2n_tot = (np.asarray(dn_cr), np.asarray(dn_th),
                                 np.asarray(d2n_tot))
        if want_d2n_ef:
            ef_norm = red.ef_zone_norm(res.psd, res.therm_psd, zone_pop,
                                       res.num_crossings,
                                       s.number_density)
            d2n_ef = (np.asarray(d2n_ef, np.float64)
                      * ef_norm[None, None, :])

        dn_th, dn_cr = red.normalize_dndp(
            dn_cr, dn_th, bins.mom_edges, zone_pop, s.number_density,
            cfg.gamma0, prof.ux_sk, prof.gamma_sf)

        p_par, p_perp, e_dens = red.thermo_calcs(
            res.psd, res.therm_psd, bins, s.mass, zone_pop,
            res.num_crossings, s.number_density, s.temperature, s.zz,
            cfg.beta0, cfg.gamma0, prof.ux_sk, prof.gamma_sf,
            d2n=d2n_tot)

        return IonFinal(
            dndp_therm=dn_th, dndp_cr=dn_cr, zone_pop=zone_pop,
            zone_vol=zone_vol, p_psd_par=p_par, p_psd_perp=p_perp,
            energy_density_psd=e_dens, d2n_ef=d2n_ef, esc=res.esc,
            psd=np.asarray(res.psd),
            therm_psd=np.asarray(res.therm_psd),
            num_crossings=res.num_crossings,
            spectra_sf=res.spectra_sf, spectra_pf=res.spectra_pf,
            n_pushes=res.n_pushes, n_trajectories=res.n_trajectories)

    return finish


def ion_finalize(setup: RunSetup, res, prof, i_ion: int,
                 want_d2n_ef: bool) -> IonFinal:
    """Per-species reductions: dN/dp in 3 frames, zone populations,
    normalization, pressures, ISM-frame d2N (ion_finalize.jl:25-59).
    Synchronous wrapper of ion_finalize_start."""
    return ion_finalize_start(setup, res, prof, i_ion, want_d2n_ef)()


def run(cfg: RunConfig | str, out_dir: str | None = None,
        emission_hook=None, p_dtype=None, mesh=None,
        checkpoint: str | None = None,
        resume: str | None = None, fused: bool = True,
        compact_levels: int = -1, mid_every: int = 0) -> RunResult:
    """Full nonlinear run (main_loops.jl:52-391).

    `emission_hook(setup, prof, ion_finals, i_iter)` is called after
    each iteration's species loop when photon production is enabled.
    `p_dtype` selects the momentum precision (float64 default; float32
    keeps positions/times in float64).  `mesh` shards the particle
    batch over devices.  `checkpoint`/`resume` persist the nonlinear
    fixed-point state between processes (the restart the reference
    never implemented, MonteCarloScattering.jl:462).

    `mid_every` > 0 (or MCS_MID_CKPT_EVERY) additionally writes a
    SEGMENT-boundary checkpoint to ``checkpoint + '.mid'`` every that
    many pcut segments, so a run whose long pole is one species'
    transport ladder can resume inside it: live population (with
    per-lane RNG keys/counters), pcut index, tally accumulators,
    iteration tallies, and completed species' reductions.  ``resume``
    accepts either flavor and detects which one it was given.
    """
    from ..utils.tracing import PhaseTimers
    # positions/PRP/acctime are float64 by contract (the grid spans 14
    # decades): enforce x64 for library callers who haven't set it,
    # before any array is built — momenta stay p_dtype-selectable
    if not jax.config.jax_enable_x64:
        log.info("enabling jax_enable_x64 (position precision contract)")
        jax.config.update("jax_enable_x64", True)
    timers = PhaseTimers()
    t_start = time.time()
    if isinstance(cfg, str):
        cfg = load_config(cfg)
    with timers.phase("setup"):
        setup = build_setup(cfg)
    kw = {}
    if p_dtype is not None:
        kw["p_dtype"] = p_dtype
    engine = TransportEngine(setup, mesh=mesh, fused=fused,
                             compact_levels=compact_levels, **kw)
    prof = setup.profile
    nb = setup.nb

    if cfg.do_old_prof:
        from .old_profile import read_old_profile
        prof = read_old_profile(
            "mc_grid_old.dat", cfg, setup.x_grid_cm, cfg.n_old_skip,
            cfg.n_old_profs, cfg.n_old_per_prof)
        log.info("restarted profile from mc_grid_old.dat")

    gamma_grid = np.zeros((nb, 2))
    q_px_hist = np.zeros(cfg.n_itrs)
    q_en_hist = np.zeros(cfg.n_itrs)
    px_esc_hist = np.zeros(cfg.n_itrs)
    en_esc_hist = np.zeros(cfg.n_itrs)
    gamma_dw_hist = np.zeros(cfg.n_itrs)
    prof_weight_fac = cfg.prof_weight_fac
    i_start = 0

    mid_resume = None      # (i_ion, transport payload, it, finals)
    if resume is not None:
        from ..parallel.checkpoint import (
            is_mid_checkpoint, load_checkpoint, load_mid_checkpoint)
        if is_mid_checkpoint(resume):
            mid = load_mid_checkpoint(resume)
            d = mid["driver"]
            ck = d
            prof = d["profile"]
            mid_resume = mid
            engine.n_pushes_total = int(d["engine_pushes"])
            engine.n_trajectories_total = int(d["engine_trajs"])
        else:
            ck = load_checkpoint(resume)
            prof = ck["profile"]
        gamma_grid = np.array(ck["gamma_grid"])
        n = min(len(ck["q_px_hist"]), cfg.n_itrs)
        q_px_hist[:n] = ck["q_px_hist"][:n]
        q_en_hist[:n] = ck["q_en_hist"][:n]
        px_esc_hist[:n] = ck["px_esc_hist"][:n]
        en_esc_hist[:n] = ck["en_esc_hist"][:n]
        gamma_dw_hist[:n] = ck["gamma_dw_hist"][:n]
        prof_weight_fac = float(ck["prof_weight_fac"])
        i_start = int(ck["i_iter"])
        log.info("resumed from %s at iteration %d%s", resume, i_start,
                 (" (mid-iteration, species %d segment %d)"
                  % (mid["i_ion"], mid["next_seg"]))
                 if mid_resume is not None else "")

    rho0 = sum(s.number_density * s.mass for s in cfg.species)
    result = RunResult(setup=setup)

    # Reduction overlap: species i's reduction
    # finish() — device fetch + f64 host normalization — runs on a
    # worker thread while species i+1's transport dispatches.  The
    # device program itself is queued in-stream before the next
    # ladder's programs; outputs are bitwise identical to the serial
    # order.  Multi-process runs stay synchronous (every process must
    # walk the same dispatch sequence).
    from concurrent.futures import ThreadPoolExecutor
    overlap = (jax.process_count() == 1
               and os.environ.get("MCS_OVERLAP_REDUCE", "1") == "1")
    pool = ThreadPoolExecutor(max_workers=1) if overlap else None

    mid_ckpt = None
    mid_every = mid_every or int(os.environ.get("MCS_MID_CKPT_EVERY",
                                                "0"))
    if checkpoint is not None and mid_every > 0:
        from ..parallel.checkpoint import MidCheckpointer
        mid_ckpt = MidCheckpointer(
            checkpoint + ".mid", every=mid_every,
            stop_after_save=os.environ.get(
                "MCS_MID_STOP_AFTER", "0") == "1")

    for i_iter in range(i_start, cfg.n_itrs):
        log.info("iteration %d/%d", i_iter + 1, cfg.n_itrs)
        it = engine.new_iteration_tallies(prof)
        pending = []
        i_ion_start = 0
        resume_tr = None
        if mid_resume is not None and i_iter == i_start:
            # mid-iteration resume: completed species' reductions come
            # from the checkpoint; the in-flight species restores its
            # population and continues at the saved segment
            it = mid_resume["it"]
            i_ion_start = int(mid_resume["i_ion"])
            pending = list(mid_resume["driver"]["ion_finals"])
            resume_tr = mid_resume
            mid_resume = None
        for i_ion in range(i_ion_start, cfg.n_ions):
            if mid_ckpt is not None:
                def _ctx(pend=list(pending), ii=i_iter):
                    return dict(
                        profile=prof, gamma_grid=gamma_grid.copy(),
                        q_px_hist=q_px_hist.copy(),
                        q_en_hist=q_en_hist.copy(),
                        px_esc_hist=px_esc_hist.copy(),
                        en_esc_hist=en_esc_hist.copy(),
                        gamma_dw_hist=gamma_dw_hist.copy(),
                        prof_weight_fac=prof_weight_fac, i_iter=ii,
                        random_seed=cfg.random_seed,
                        engine_pushes=engine.n_pushes_total,
                        engine_trajs=engine.n_trajectories_total,
                        ion_finals=[p.result() if hasattr(p, "result")
                                    else p for p in pend])
                mid_ckpt.context_fn = _ctx
            with timers.phase("transport"):
                res = engine.run_ion(i_iter, i_ion, prof, it,
                                     ckpt=mid_ckpt,
                                     resume_mid=resume_tr)
            resume_tr = None
            want_2d = (cfg.species[i_ion].is_electron
                       or i_ion == cfg.n_ions - 1)
            with timers.phase("reductions"):
                fin = ion_finalize_start(setup, res, prof, i_ion,
                                         want_2d)
                pending.append(pool.submit(fin) if pool else fin())
        with timers.phase("reductions"):
            ion_finals = [p.result() if hasattr(p, "result") else p
                          for p in pending]

        # ---- iteration close-out (iter_finalize.jl:20-54) ------------------
        px_esc_hist[i_iter] = (it.px_esc_upstream / setup.f_px_upstream)
        en_esc_hist[i_iter] = (it.energy_esc_upstream
                               / setup.f_energy_upstream)

        # pressures summed over species (the reference keeps only the
        # last species' thermo output, ion_finalize->main_loops:321;
        # the sum is the physically complete closure)
        p_par = sum(f.p_psd_par for f in ion_finals)
        p_perp = sum(f.p_psd_perp for f in ion_finals)
        e_dens = sum(f.energy_density_psd for f in ion_finals)
        gamma_grid = set_gamma_adiab_grid(
            gamma_grid, i_iter, setup.x_grid_cm, setup.gamma2_rh,
            p_par, p_perp, e_dens)

        gamma_dw_hist[i_iter] = 1.0 + (
            it.sum_p_downstream / max(it.sum_ke_downstream, 1e-300))

        q_px, q_en = q_esc_calcs(
            gamma_dw_hist[i_iter], setup.r_comp, setup.r_rh, cfg.u0,
            cfg.beta0, cfg.gamma0, cfg.species, setup.gamma2,
            setup.beta2, setup.u2)
        q_px_hist[i_iter] = q_px
        q_en_hist[i_iter] = q_en
        n_avg = min(i_iter + 1, 4)
        q_px_avg = q_px_hist[i_iter - n_avg + 1:i_iter + 1].mean()
        q_en_avg = q_en_hist[i_iter - n_avg + 1:i_iter + 1].mean()

        timers.totals["smoothing"] += 0.0
        t_sm = time.time()
        prof_new, diag, prof_weight_fac = smooth_grid(
            i_iter, setup.i_shock, prof, cfg, setup.x_grid_rg,
            gamma_grid, p_par, p_perp, it.pxx_flux, it.energy_flux,
            q_px_avg, q_en_avg, setup.f_px_upstream,
            setup.f_energy_upstream, setup.gamma2_rh, setup.u2,
            setup.beta2, setup.gamma2, prof_weight_fac,
            cfg.species[0].number_density, cfg.species[0].temperature,
            rho0, cfg.use_custom_eps_b)
        timers.totals["smoothing"] += time.time() - t_sm
        timers.counts["smoothing"] += 1

        itres = IterationResult(
            ion_finals=ion_finals, tallies=it, diag=diag,
            gamma_downstream=gamma_dw_hist[i_iter],
            q_esc_px=q_px_avg, q_esc_en=q_en_avg,
            px_esc_frac=px_esc_hist[i_iter],
            en_esc_frac=en_esc_hist[i_iter],
            profile_after=prof_new)
        if cfg.do_photons:
            # photon production per shell/zone (ion_finalize.jl:72-78)
            from ..models.emission import photon_calcs
            with timers.phase("emission"):
                itres.emission = photon_calcs(setup, prof, ion_finals,
                                              i_iter)
            if emission_hook is not None:
                emission_hook(setup, prof, ion_finals, i_iter)
        result.iterations.append(itres)

        prof = prof_new
        if checkpoint is not None:
            from ..parallel.checkpoint import save_checkpoint
            save_checkpoint(
                checkpoint, i_iter=i_iter + 1, profile=prof,
                gamma_grid=gamma_grid, q_px_hist=q_px_hist,
                q_en_hist=q_en_hist, px_esc_hist=px_esc_hist,
                en_esc_hist=en_esc_hist, gamma_dw_hist=gamma_dw_hist,
                prof_weight_fac=prof_weight_fac,
                random_seed=cfg.random_seed)
            if mid_ckpt is not None and os.path.exists(mid_ckpt.path):
                # the iteration checkpoint supersedes any mid-iteration
                # state from inside this iteration
                os.remove(mid_ckpt.path)

    if pool is not None:
        pool.shutdown(wait=True)
    result.wall_time = time.time() - t_start
    result.n_pushes = engine.n_pushes_total
    result.n_trajectories = engine.n_trajectories_total
    result.timers = timers
    result.subtimers = dict(engine.subtimers) or None

    if out_dir is not None:
        from .io import write_outputs
        with timers.phase("io"):
            write_outputs(result, out_dir)
    return result
