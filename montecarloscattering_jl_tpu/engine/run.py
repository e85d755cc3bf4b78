"""Run orchestration: the iteration / species / pcut loop nest.

Host-level replacement for main_loops (main_loops.jl:12-396): the outer
fixed-point loop and the pcut schedule stay in Python (they are O(20)
and O(45) trips), while each pcut segment is one jitted device program
(ops/step.run_segment) over the whole particle batch.
"""

from __future__ import annotations

import logging
import math
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..models.injection import init_pop
from ..ops import state as stt
from ..ops import step as stp
from ..ops.cuts import pcut_split
from ..ops.finish import EscapeTallies, finish_particles_jit
from ..utils import constants as K
from ..utils.config import RunConfig
from ..utils.params import E_REL_PT
from .setup import RunSetup, build_setup

log = logging.getLogger("mcs.engine")

# finalize as ONE device program instead of one dispatch per eager
# cumsum/reshape
_finalize_tallies_jit = jax.jit(stt.finalize_tallies)


def _round_up(n: int, m: int = 128) -> int:
    return ((n + m - 1) // m) * m


@dataclass
class IonResult:
    """Per-(iteration, species) tallies after all pcuts."""

    psd: np.ndarray            # [n_mom+1, n_theta+1, nb]
    therm_psd: np.ndarray
    num_crossings: np.ndarray  # [nb]
    esc: EscapeTallies
    spectra_sf: np.ndarray
    spectra_pf: np.ndarray
    n_pushes: int = 0
    n_trajectories: int = 0


@dataclass
class IterationTallies:
    """Per-iteration flux accumulators (zeroed at main_loops.jl:56-87)."""

    pxx_flux: np.ndarray
    pxz_flux: np.ndarray
    energy_flux: np.ndarray
    px_esc_upstream: float = 0.0
    energy_esc_upstream: float = 0.0
    sum_p_downstream: float = 0.0
    sum_ke_downstream: float = 0.0
    weight_coupled: np.ndarray = None
    spectra_coupled: np.ndarray = None
    # ion -> electron energy pool [erg per zone], filled by ion species
    # and consumed by electrons later in the same iteration
    # (main_loops.jl:83-84,164)
    energy_pool: np.ndarray = None
    eps_target: np.ndarray = None


@dataclass
class TransportEngine:
    """Builds and caches the device-side segment inputs for a run.

    With `mesh` set (> 1 device), segments run under shard_map with the
    particle batch sharded over the 'dp' axis and tallies psum-reduced
    (parallel/shard.py); single-device runs use the plain jitted path.
    """

    setup: RunSetup
    p_dtype: object = jnp.float64
    psd_dtype: object = jnp.float32
    mesh: object = None
    batch_size: int = 0
    tally_chunk: int = 8
    fused: bool = True
    # live-lane compaction ladder depth (ops/step.run_segment): halve
    # the active window up to this many times as lanes drain.  Lane
    # trajectories are bitwise unchanged; tally sums reorder at float
    # rounding, so equivalence tests pin it to 0.  -1 = auto (halve
    # down to a 4096-lane floor).
    compact_levels: int = -1
    n_pushes_total: int = 0
    n_trajectories_total: int = 0

    def __post_init__(self):
        cfg = self.setup.cfg
        self.batch_size = _round_up(
            max(cfg.n_pts_inj + 64, cfg.n_pts_pcut, cfg.n_pts_pcut_hi))
        if self.batch_size > 8192:
            # 4096-multiples keep every halved compaction window
            # 128-lane aligned (4096 = 2^12), so the auto ladder always
            # engages; padding cost is < 6% at flagship sizes
            self.batch_size = _round_up(self.batch_size, 4096)
        self.n_tcut_slots = max(len(cfg.tcuts), 1)
        self.base_key = jax.random.key(cfg.random_seed)
        self._sharded_seg = {}
        self.subtimers = defaultdict(float)   # MCS_SUBTIMERS=1 breakdown
        if self.mesh is not None and self.mesh.size > 1:
            from ..parallel.shard import pad_to_devices
            self.batch_size = pad_to_devices(self.batch_size,
                                             self.mesh.size)
        if self.compact_levels < 0:
            self.compact_levels = self._auto_compact_levels()

    def _auto_compact_levels(self) -> int:
        """Halve the active window down to a 4096-lane floor (per
        shard when a mesh is set)."""
        b = self.batch_size
        if self.mesh is not None and self.mesh.size > 1:
            b //= self.mesh.size
        levels = 0
        while b > 4096 and b % 256 == 0:
            b //= 2
            levels += 1
        return levels

    def _segment_runner(self, ss):
        """Plain or sharded segment executor for a static config."""
        lv = self.compact_levels
        if self.mesh is None or self.mesh.size <= 1:
            # run_segment_chunked == run_segment_jit below the chunk
            # threshold; above it the drain is host-chunked
            return (lambda st, tl, gr, sc, _ss:
                    stp.run_segment_chunked(st, tl, gr, sc, _ss, lv))
        if ss not in self._sharded_seg:
            from ..parallel.shard import sharded_run_segment
            f = sharded_run_segment(self.mesh, ss, compact_levels=lv)
            self._sharded_seg[ss] = lambda st, tl, gr, sc, _ss: f(
                st, tl, gr, sc)
        return self._sharded_seg[ss]

    def ladder_path(self) -> str:
        """The pcut ladder run_ion takes: "scan" (the whole ladder as
        one lax.scan program, up to MCS_FUSED_MAX_BATCH lanes),
        "hybrid" (one device program per segment, above it) or "host"
        (host-split per-pcut loop: --no-fused, or a device mesh)."""
        if not self.fused or (self.mesh is not None
                              and self.mesh.size > 1):
            return "host"
        fused_max = int(os.environ.get("MCS_FUSED_MAX_BATCH", 65536))
        return "scan" if self.batch_size <= fused_max else "hybrid"

    # -- per-segment input builders -----------------------------------------

    def segment_grids(self, prof, eps_target=None,
                      recv_pool=None) -> stp.SegmentGrids:
        cfg = self.setup.cfg
        nb = self.setup.nb
        f = lambda a: jnp.asarray(a, self.p_dtype)
        tcuts = np.full(self.n_tcut_slots, np.inf)
        tcuts[:len(cfg.tcuts)] = cfg.tcuts
        if eps_target is None:
            eps_target = np.zeros(nb)
        prefix = np.zeros(nb + 1)
        if recv_pool is not None:
            prefix[1:] = np.cumsum(recv_pool)
        return stp.SegmentGrids(
            x_grid=jnp.asarray(self.setup.x_grid_cm, stt.X_DTYPE),
            ux=f(prof.ux_sk), uz=f(prof.uz_sk), utot=f(prof.utot),
            gamma_sf=f(prof.gamma_sf), gamma_ef=f(prof.gamma_ef),
            beta_ef=f(prof.beta_ef), btot=f(prof.btot),
            b_cos=f(np.cos(prof.theta)), b_sin=f(np.sin(prof.theta)),
            tcuts=jnp.asarray(tcuts),
            x_spec=jnp.asarray(np.asarray(cfg.x_spec)
                               if cfg.x_spec else np.zeros(1)),
            eps_target=f(eps_target),
            recv_prefix=jnp.asarray(prefix, jnp.float64),
        )

    def segment_scalars(self, i_ion: int, i_pcut: int, bmag2: float
                        ) -> stp.SegmentScalars:
        cfg = self.setup.cfg
        s = cfg.species[i_ion]
        pcut = cfg.pcuts[i_pcut]
        pcut_prev = cfg.pcuts[i_pcut - 1] if i_pcut > 0 else 0.0
        # momentum/field-domain scalars carry the state dtype so the
        # f32 path stays f32; position/time scalars stay float64
        j = lambda v: jnp.asarray(v, self.p_dtype)
        j64 = lambda v: jnp.asarray(v, stt.X_DTYPE)
        return stp.SegmentScalars(
            aa=j(s.aa), abs_charge=j(abs(s.charge)), m=j(s.mass),
            pcut=j(pcut), pcut_prev=j(pcut_prev),
            pmax_cutoff=j(pmax_cutoff(cfg, s.mass)),
            u2=j(self.setup.u2), bmag2=j(bmag2),
            b_cmbz=j(self.setup.b_cmbz),
            gamma0_u0=j(cfg.gamma0 * cfg.u0),
            feb_up=j64(cfg.feb_upstream), feb_dw=j64(cfg.feb_downstream),
            x_grid_stop=j64(self.setup.x_grid_stop),
            age_max=j64(cfg.age_max), pe_crit=j(cfg.pe_crit),
            gamma_e_crit=j(cfg.gamma_e_crit),
            inj_frac=j(cfg.inj_fracs[i_ion]),
        )

    def step_static(self, i_ion: int) -> stp.StepStatic:
        cfg = self.setup.cfg
        b = self.setup.bins
        return stp.StepStatic(
            eta_mfp=cfg.eta_mfp, xn_per_coarse=cfg.xn_per_coarse,
            xn_per_fine=cfg.xn_per_fine, dont_scatter=cfg.dont_scatter,
            frg_alpha=(cfg.frg_alpha if cfg.use_custom_frg else 1.0),
            frg_rg0_cm=(cfg.frg_rg0_rg * cfg.rg0
                        if cfg.use_custom_frg else 0.0),
            dont_dsa=cfg.dont_dsa, do_rad_losses=cfg.do_rad_losses,
            do_retro=cfg.do_retro, do_tcuts=cfg.do_tcuts,
            use_custom_eps_b=cfg.use_custom_eps_b,
            is_electron=cfg.species[i_ion].is_electron,
            do_energy_transfer=(cfg.energy_transfer_frac > 0
                                and cfg.n_ions > 1),
            electron_weight_fac=self.setup.electron_weight_fac,
            n_xspec=len(cfg.x_spec), i_grid_feb=self.setup.i_grid_feb,
            i_shock=self.setup.i_shock,
            nb=self.setup.nb, psd_mom_min=b.psd_mom_min,
            bins_per_dec_mom=b.bins_per_dec_mom, n_mom=b.n_mom,
            cos_fine=b.cos_fine, dcos=b.dcos, theta_min=b.theta_min,
            bins_per_dec_theta=b.bins_per_dec_theta, n_theta=b.n_theta)

    # -- the loops ----------------------------------------------------------

    def run_ion(self, i_iter: int, i_ion: int, prof,
                it: IterationTallies, ckpt=None,
                resume_mid=None) -> IonResult:
        """All pcuts for one species (main_loops.jl:95-341 inner part).

        ``ckpt`` (parallel/checkpoint.MidCheckpointer) saves a
        segment-boundary checkpoint every ``ckpt.every`` pcut segments
        on the host-split per-pcut loop, the path whose segment
        boundaries the host sees.  ``resume_mid`` is a payload from
        load_mid_checkpoint for THIS (i_iter, i_ion): the population,
        accumulators, and segment index are restored and the ladder
        continues from the saved boundary."""
        setup, cfg, bins = self.setup, self.setup.cfg, self.setup.bins
        s = cfg.species[i_ion]
        nb, b = setup.nb, self.batch_size
        if resume_mid is not None:
            if (resume_mid["i_iter"], resume_mid["i_ion"]) != \
                    (i_iter, i_ion):
                raise ValueError(
                    "mid checkpoint is for (iter %d, ion %d), not "
                    "(%d, %d)" % (resume_mid["i_iter"],
                                  resume_mid["i_ion"], i_iter, i_ion))
        if ckpt is not None:
            ckpt.reset(resume_mid["next_seg"] if resume_mid else 0)
        # MCS_SUBTIMERS=1: attribute the transport phase to
        # [population setup | ladder | tally fetch] in self.subtimers
        # (adds two device syncs per species — measurement runs only)
        _subt = os.environ.get("MCS_SUBTIMERS", "0") == "1"
        _t0 = time.perf_counter() if _subt else 0.0

        grids = self.segment_grids(prof, eps_target=it.eps_target,
                                   recv_pool=it.energy_pool)
        ss = self.step_static(i_ion)
        ion_key = jax.random.fold_in(
            jax.random.fold_in(self.base_key, i_iter), i_ion)

        if resume_mid is None:
            # injected population (main_loops.jl:126-153);
            # deterministic rng keyed like the reference's
            # Xoshiro(f(i_iter, i_ion))
            rng = np.random.default_rng(
                (cfg.random_seed, i_iter, i_ion))
            pop = init_pop(
                rng, cfg.species, i_ion, cfg.inp_distr, cfg.energy_inj,
                cfg.inj_weight, cfg.n_pts_inj, setup.x_grid_start,
                cfg.rg0, cfg.eta_mfp, cfg.do_fast_push,
                cfg.x_fast_stop_rg, cfg.beta0, cfg.gamma0, cfg.u0,
                setup.x_grid_rg, prof.ux_sk, prof.gamma_sf)
            # fast-push analytic flux backfill (init_pop returns zeros
            # when not applicable)
            it.pxx_flux += pop.pxx_flux
            it.pxz_flux += pop.pxz_flux
            it.energy_flux += pop.energy_flux

            n0 = len(pop.ptot_pf)
            pad = lambda a, fill=0.0: np.concatenate(
                [np.asarray(a), np.full(b - len(a), fill,
                                        np.asarray(a).dtype)])
            state = stt.init_state(
                pad(pop.weight), pad(pop.ptot_pf), pad(pop.pb_pf),
                pad(pop.x_cm), pad(pop.i_grid).astype(np.int32),
                pad(prof.ux_sk[pop.i_grid]), cfg.xn_per_fine,
                setup.x_grid_stop, jax.random.fold_in(ion_key, 0),
                p_dtype=self.p_dtype)
        else:
            # population (incl. per-lane PRNG keys + step counters)
            # restored from the segment-boundary checkpoint; the
            # backfill fluxes are already inside the restored `it`
            state = stt.ParticleState(*[
                jnp.asarray(x) for x in resume_mid["state"]])
            n0 = int(resume_mid["trajectories"])

        # per-ion accumulators (cleared per species, ion_init.jl:1-16)
        psd_acc = np.zeros((bins.n_mom + 1, bins.n_theta + 1, nb))
        therm_acc = np.zeros_like(psd_acc)
        ncross_acc = np.zeros(nb)
        spectra_sf = np.zeros((bins.n_mom + 1, max(len(cfg.x_spec), 1)))
        spectra_pf = np.zeros_like(spectra_sf)
        esc = EscapeTallies.zeros(bins.n_mom, bins.n_theta)
        pushes = 0
        trajectories = n0

        p_pcut_hi = pcut_hi_momentum(cfg.energy_pcut_hi, s.mass)

        if _subt:
            jax.block_until_ready(state.weight)
            self.subtimers["pop_setup"] += time.perf_counter() - _t0
            _t0 = time.perf_counter()

        ladder = self.ladder_path()
        if ladder != "host":
            # Fused ladders: on-device splitting between segments
            # (ops/fused_ion.py) removes the host round trip of the
            # per-pcut loop below.
            from ..ops.fused_ion import (run_ion_fused_jit,
                                         run_ion_xla_hybrid)
            if resume_mid is not None:
                raise ValueError(
                    "mid checkpoint resume needs the host-split loop "
                    "(--no-fused), whose segment boundaries the host "
                    "sees; this run selected the fused %s ladder"
                    % ladder)
            if ckpt is not None:
                log.warning(
                    "mid checkpointing inactive for iter %d ion %d: the "
                    "fused %s ladder has no host-visible segment "
                    "boundaries", i_iter, i_ion, ladder)
            n_pcuts = len(cfg.pcuts)
            pcuts = jnp.asarray(cfg.pcuts, self.p_dtype)
            pcut_prevs = jnp.asarray(
                np.concatenate([[0.0], cfg.pcuts[:-1]]), self.p_dtype)
            n_targets = jnp.asarray(
                [cfg.n_pts_pcut if p < p_pcut_hi else cfg.n_pts_pcut_hi
                 for p in cfg.pcuts], jnp.int32)
            seg_keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
                ion_key, jnp.arange(1, n_pcuts + 1, dtype=jnp.uint32))
            sc = self.segment_scalars(i_ion, 0, prof.bmag2)
            lv = self.compact_levels
            tal = stt.make_tallies(nb, bins.n_mom, bins.n_theta,
                                   len(cfg.x_spec), self.n_tcut_slots,
                                   self.psd_dtype, batch=self.batch_size,
                                   chunk=self.tally_chunk,
                                   p_dtype=self.p_dtype)
            if ladder == "scan":
                state, tal, esc, n_new, nsteps = run_ion_fused_jit(
                    state, tal, esc, grids, sc, ss,
                    pcuts, pcut_prevs, n_targets, seg_keys,
                    compact_levels=lv)
            else:
                state, tal, esc, n_new, nsteps = run_ion_xla_hybrid(
                    state, tal, esc, grids, sc, ss,
                    np.asarray(cfg.pcuts),
                    np.concatenate([[0.0], cfg.pcuts[:-1]]),
                    np.asarray(n_targets), seg_keys,
                    compact_levels=lv)
            if _subt:
                jax.block_until_ready(nsteps)
                _dt = time.perf_counter() - _t0
                self.subtimers["ladder"] += _dt
                logging.getLogger(__name__).warning(
                    "ladder iter=%d ion=%d: %.2fs %.0fM pushes "
                    "(%.1fM/s) n_new=%s", i_iter, i_ion, _dt,
                    float(np.sum(np.asarray(nsteps, np.float64)))
                    / 1e6,
                    float(np.sum(np.asarray(nsteps, np.float64)))
                    / _dt / 1e6,
                    np.asarray(n_new).tolist())
                _t0 = time.perf_counter()
            # One jitted program for the prefix-sum finalize, then ONE
            # batched async fetch of every host-consumed field.  The big PSD
            # blocks stay device-resident on single-process runs:
            # ion_reduce_device consumes them directly, so fetching
            # them here was a pure D2H->H2D roundtrip of the largest
            # buffers per species (the round-5 tally_fetch subtimer).
            fin = _finalize_tallies_jit(tal)
            keep_device = jax.process_count() == 1
            want_tcut = cfg.do_tcuts
            want_pool = (it.energy_pool is not None
                         and not ss.is_electron)
            (pxx_h, pxz_h, enf_h, ncross_h, pxu_h, enu_h, spd_h, sked_h,
             ssf_h, spf_h), tcut_h, pool_h, esc_h, n_new_h, ns_h = (
                jax.device_get(((fin.pxx_flux, fin.pxz_flux,
                                 fin.energy_flux, fin.num_crossings,
                                 fin.px_esc_up, fin.en_esc_up,
                                 fin.sum_p_dw, fin.sum_ke_dw,
                                 fin.spectra_sf, fin.spectra_pf),
                                (fin.weight_coupled,
                                 fin.spectra_coupled) if want_tcut
                                else (),
                                fin.energy_pool if want_pool else (),
                                esc, n_new, nsteps)))
            it.pxx_flux += pxx_h
            it.pxz_flux += pxz_h
            it.energy_flux += enf_h
            it.px_esc_upstream += float(pxu_h)
            it.energy_esc_upstream += float(enu_h)
            it.sum_p_downstream += float(spd_h) * s.number_density
            it.sum_ke_downstream += float(sked_h) * s.number_density
            if want_tcut:
                it.weight_coupled[:, i_ion] += tcut_h[0]
                it.spectra_coupled[:, :, i_ion] += tcut_h[1]
            if keep_device:
                # Assignment, not accumulation: this fused branch runs
                # ONCE per ion (the whole pcut ladder is inside the
                # device program) and returns immediately below, unlike
                # the per-pcut loop at the end of run_ion which must
                # accumulate.  If this branch ever gains a loop, switch
                # to `psd_acc = psd_acc + fin.psd`.
                psd_acc = fin.psd
                therm_acc = fin.therm_psd
            else:
                psd_acc += np.asarray(fin.psd)
                therm_acc += np.asarray(fin.therm_psd)
            ncross_acc += ncross_h
            spectra_sf += ssf_h
            spectra_pf += spf_h
            if want_pool:
                it.energy_pool += pool_h
            pushes = int(np.asarray(ns_h, np.uint64).sum())
            trajectories += int(np.asarray(n_new_h, np.int64).sum())
            self.n_pushes_total += pushes
            self.n_trajectories_total += trajectories
            if _subt:
                self.subtimers["tally_fetch"] += time.perf_counter() - _t0
            return IonResult(
                psd=psd_acc, therm_psd=therm_acc,
                num_crossings=ncross_acc,
                esc=esc_h,
                spectra_sf=spectra_sf, spectra_pf=spectra_pf,
                n_pushes=pushes, n_trajectories=trajectories)

        seg_run = self._segment_runner(ss)
        start_pcut = 0
        if resume_mid is not None:
            if resume_mid["mode"] != "host":
                raise ValueError(
                    "mid checkpoint was written by the %r path but "
                    "this run selects the host-split loop; rerun with "
                    "the same engine configuration"
                    % resume_mid["mode"])
            start_pcut = int(resume_mid["next_seg"])
            psd_acc = np.array(resume_mid["psd_acc"])
            therm_acc = np.array(resume_mid["therm_acc"])
            ncross_acc = np.array(resume_mid["ncross_acc"])
            spectra_sf = np.array(resume_mid["spectra_sf"])
            spectra_pf = np.array(resume_mid["spectra_pf"])
            esc = EscapeTallies(*[np.array(x)
                                  for x in resume_mid["esc"]])
            pushes = int(resume_mid["pushes"])
        for i_pcut in range(start_pcut, len(cfg.pcuts)):
            sc = self.segment_scalars(i_ion, i_pcut, prof.bmag2)
            tal = stt.make_tallies(nb, bins.n_mom, bins.n_theta,
                                   len(cfg.x_spec), self.n_tcut_slots,
                                   self.psd_dtype, batch=b,
                                   chunk=self.tally_chunk,
                                   p_dtype=self.p_dtype)
            state, tal = seg_run(state, tal, grids, sc, ss)
            fin = stt.finalize_tallies(tal)

            # accumulate (scopes follow main_loops.jl:56-87 / ion_init)
            it.pxx_flux += np.asarray(fin.pxx_flux)
            it.pxz_flux += np.asarray(fin.pxz_flux)
            it.energy_flux += np.asarray(fin.energy_flux)
            it.px_esc_upstream += float(fin.px_esc_up)
            it.energy_esc_upstream += float(fin.en_esc_up)
            it.sum_p_downstream += float(fin.sum_p_dw) * s.number_density
            it.sum_ke_downstream += float(fin.sum_ke_dw) * s.number_density
            if cfg.do_tcuts:
                it.weight_coupled[:, i_ion] += np.asarray(
                    fin.weight_coupled)
                it.spectra_coupled[:, :, i_ion] += np.asarray(
                    fin.spectra_coupled)
            psd_acc += np.asarray(fin.psd)
            therm_acc += np.asarray(fin.therm_psd)
            ncross_acc += np.asarray(fin.num_crossings)
            spectra_sf += np.asarray(fin.spectra_sf)
            spectra_pf += np.asarray(fin.spectra_pf)
            if it.energy_pool is not None and not ss.is_electron:
                it.energy_pool += np.asarray(fin.energy_pool)

            esc = finish_particles_jit(state, esc, grids, sc, ss)
            pushes += int(np.asarray(state.nsteps).sum())

            # splitting (cuts.jl:34-124)
            n_target = (cfg.n_pts_pcut if cfg.pcuts[i_pcut] < p_pcut_hi
                        else cfg.n_pts_pcut_hi)
            split = pcut_split(state, n_target, self.batch_size)
            if split is None:
                log.info("iter %d ion %d: pcut chain ended at %d",
                         i_iter, i_ion, i_pcut)
                break
            trajectories += split.n
            seg_key = jax.random.fold_in(ion_key, i_pcut + 1)
            state = stt.init_state(
                split.weight, np.hypot(split.pb, split.pperp), split.pb,
                split.x, split.igrid, split.ux_prev, cfg.xn_per_fine,
                setup.x_grid_stop, seg_key, phi=split.phi,
                downstream=split.downstream, inj=split.inj,
                acctime=split.acctime, tcut=split.tcut,
                xn_per=split.xn_per, p_dtype=self.p_dtype)
            # preserve per-lane PRP from the saved state
            state = state._replace(
                prp_x=jnp.asarray(split.prp_x, stt.X_DTYPE))

            if ckpt is not None:
                # segment boundary: the freshly split state is exactly
                # what segment i_pcut+1 consumes, so a resume here is
                # bitwise-identical to the uninterrupted run (the seg
                # RNG key depends only on (seed, iter, ion, pcut))
                ckpt.maybe(i_pcut + 1, lambda: dict(
                    mode="host", i_iter=i_iter, i_ion=i_ion,
                    next_seg=i_pcut + 1, state=state,
                    psd_acc=psd_acc, therm_acc=therm_acc,
                    ncross_acc=ncross_acc, spectra_sf=spectra_sf,
                    spectra_pf=spectra_pf,
                    esc=jax.tree.map(np.asarray, esc),
                    pushes=pushes, trajectories=trajectories, it=it))

        self.n_pushes_total += pushes
        self.n_trajectories_total += trajectories
        return IonResult(
            psd=psd_acc, therm_psd=therm_acc, num_crossings=ncross_acc,
            esc=jax.tree.map(np.asarray, esc),
            spectra_sf=spectra_sf, spectra_pf=spectra_pf,
            n_pushes=pushes, n_trajectories=trajectories)

    def new_iteration_tallies(self, prof=None) -> IterationTallies:
        cfg, nb = self.setup.cfg, self.setup.nb
        n_mom = self.setup.bins.n_mom
        eps = np.zeros(nb)
        if cfg.energy_transfer_frac > 0 and prof is not None:
            eps = populate_eps_target(
                cfg.energy_transfer_frac, cfg.u0, cfg.gamma0,
                self.setup.u2, self.setup.gamma2, prof)
        return IterationTallies(
            pxx_flux=np.zeros(nb), pxz_flux=np.zeros(nb),
            energy_flux=np.zeros(nb),
            weight_coupled=np.zeros((self.n_tcut_slots, cfg.n_ions)),
            spectra_coupled=np.zeros((n_mom + 1, self.n_tcut_slots,
                                      cfg.n_ions)),
            energy_pool=np.zeros(nb),
            eps_target=eps,
        )


def populate_eps_target(energy_transfer_frac: float, u0: float,
                        gamma0: float, u2: float, gamma2: float,
                        prof) -> np.ndarray:
    """Electron energy-transfer target fraction per zone
    (populate_eps_target!, iter_init.jl:1-15): eps ~ (z - 1) scaled so
    the full compression reaches energy_transfer_frac (Ardaneh+ 2015)."""
    beta0 = u0 / K.C_CGS
    beta2 = u2 / K.C_CGS
    z_max = gamma0 * beta0 / (gamma2 * beta2)
    prefac = energy_transfer_frac / max(z_max - 1.0, 1e-30)
    eps = np.zeros(len(prof.ux_sk))
    moving = prof.ux_sk != u0
    z_curr = gamma0 * u0 / (prof.gamma_sf * prof.ux_sk)
    eps[moving] = prefac * (z_curr[moving] - 1.0)
    return eps


def pmax_cutoff(cfg: RunConfig, mass: float) -> float:
    """Per-species maximum momentum (get_pmax_cutoff, ion_init.jl:55-72)."""
    e0 = mass * K.C_CGS**2
    if cfg.emax > 0:
        g = 1.0 + cfg.emax / e0
        return mass * K.C_CGS * math.sqrt(g * g - 1.0)
    if cfg.emax_per_aa > 0:
        g = 1.0 + cfg.emax_per_aa / e0
        return mass * K.C_CGS * math.sqrt(g * g - 1.0)
    if cfg.pmax > 0:
        return cfg.pmax
    raise ValueError("maximum energy not set")


def pcut_hi_momentum(energy_pcut_hi_kev: float, mass: float) -> float:
    """Momentum above which the high-E particle count applies
    (pcut_hi, ion_init.jl:74-82).  energy_pcut_hi is keV per nucleon;
    the nonrelativistic branch restores the m*c scale the reference
    drops."""
    e_rm = energy_pcut_hi_kev * K.KEV_ERG / (K.MP_C2)
    if e_rm < E_REL_PT:
        return mass * K.C_CGS * math.sqrt(2.0 * e_rm)
    return mass * K.C_CGS * math.sqrt((e_rm + 1.0) ** 2 - 1.0)
