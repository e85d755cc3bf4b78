"""Fused batched transport step: the accelerator replacement for the
reference's per-particle helix loop.

One call to `helix_step` advances every lane of a ParticleState by one
time step dt = T_gyro / N_g, performing — as masked lane-parallel
updates instead of control flow — everything the reference does per
trip through loop_helix (particle_loop.jl:154-499):

  zone-field gather, frame re-transform on flow-gradient crossings,
  escape tests, radiative losses, pitch-angle scattering, pcut
  save-out, movement with no-DSA reflection, PRP placement, flux/PSD
  tallies, the probability-of-return test, and the retro-time replay
  (prob_return.jl:217-344) which runs as a per-lane mode of the same
  step so mixed populations stay in one jitted while_loop.

`run_segment` iterates helix_step under lax.while_loop until every
lane is SAVED or FINISHED (or the MAX_HELIX_STEPS cap fires, matching
particle_loop.jl:162-165).

Design notes (SURVEY.md section 7):
  * Positions/PRP/acctime are float64 (13-decade dynamic range);
    momenta inherit the state dtype.
  * Range tallies use the difference-array trick in ops/state.py.
  * RNG is counter-based: lane key x step index -> threefry uniforms,
    mirroring the reference's per-(iter,ion,pcut,particle) seed
    discipline (particle_loop.jl:32-41) with per-step granularity.
  * The reference's negative gyro constant for electrons
    (particle_loop.jl:72 with zz < 0, which would make t_step < 0) is
    corrected to |z|.
  * The retro walk keeps the pitch drawn by its large-angle scatter;
    the reference clobbers it with the pre-scatter pitch
    (prob_return.jl:329-330), which would disable LAS entirely.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..models.psd_bins import psd_bin_angle, psd_bin_momentum
from ..utils.constants import C_CGS, RAD_LOSS_FAC
from ..utils.params import (
    ALL_FLUX_SPIKE_AWAY,
    E_REL_PT,
    MAX_HELIX_STEPS,
)
from . import state as st
from .scattering import radiation_loss, scattering
from .state import ACTIVE, FINISHED, SAVED, ParticleState, Tallies
from .transforms import (
    transform_p_ps,
    transform_p_ps_parallel,
    transform_p_psp,
    transform_p_psp_parallel,
)

# Uniform slots are shared between mutually exclusive lane modes
# (scattering vs retro walk; shock reflection vs PRP return) to keep
# the per-step threefry cost down: 8 uniforms per lane per step.
_N_UNIFORM = 8
_U_SCAT1, _U_SCAT2 = 0, 1        # pitch-angle scattering
_U_RETRO_PHI, _U_RETRO_MU = 0, 1  # retro LAS (retro lanes don't scatter)
_U_PRET = 2                       # P_ret test at the PRP
_U_RET_MU = 3                     # analytic-return pitch
_U_RET_PHI = 4                    # return phase
_U_REFL_INJ = (5, 6)              # no-DSA reflection injection tests
_U_REFL_PHI = (7, 3)              # reflection phase draws (slot 3 is
#                                   free for lanes at the shock)

_N_REFLECT_TRIES = 2


class SegmentGrids(NamedTuple):
    """Traced per-boundary arrays (length nb) + small traced vectors."""

    x_grid: jnp.ndarray      # boundary positions [cm], float64
    ux: jnp.ndarray          # flow speed x [cm/s]
    uz: jnp.ndarray
    utot: jnp.ndarray
    gamma_sf: jnp.ndarray
    gamma_ef: jnp.ndarray
    beta_ef: jnp.ndarray
    btot: jnp.ndarray        # [G]
    b_cos: jnp.ndarray       # cos(theta_B)
    b_sin: jnp.ndarray
    tcuts: jnp.ndarray       # [n_tcut_slots] (padded with +inf)
    x_spec: jnp.ndarray      # [max(n_xspec,1)] detector positions [cm]
    eps_target: jnp.ndarray  # [nb] electron heating target fraction
    recv_prefix: jnp.ndarray  # [nb+1] prefix sum of the received-energy
    #                           pool [erg] (do_energy_transfer)


class SegmentScalars(NamedTuple):
    """Traced scalars that change between segments (species / pcut)
    without triggering recompilation."""

    aa: jnp.ndarray            # mass in proton masses
    abs_charge: jnp.ndarray    # |z| q [esu]
    m: jnp.ndarray             # mass [g]
    pcut: jnp.ndarray          # current splitting momentum [g cm/s]
    pcut_prev: jnp.ndarray
    pmax_cutoff: jnp.ndarray
    u2: jnp.ndarray            # downstream flow speed [cm/s]
    bmag2: jnp.ndarray         # downstream field [G]
    b_cmbz: jnp.ndarray        # CMB-equivalent field at source z [G]
    gamma0_u0: jnp.ndarray     # flux normalization gamma0 * u0
    feb_up: jnp.ndarray        # [cm]
    feb_dw: jnp.ndarray        # [cm] (<= 0: PRP mode)
    x_grid_stop: jnp.ndarray   # [cm]
    age_max: jnp.ndarray       # [s] (<= 0: disabled)
    pe_crit: jnp.ndarray       # [g cm/s]
    gamma_e_crit: jnp.ndarray
    inj_frac: jnp.ndarray


@dataclass(frozen=True)
class StepStatic:
    """Static (compile-time) configuration of the step kernel."""

    eta_mfp: float
    xn_per_coarse: float
    xn_per_fine: float
    dont_scatter: bool
    dont_dsa: bool
    do_rad_losses: bool
    do_retro: bool
    do_tcuts: bool
    use_custom_eps_b: bool
    is_electron: bool
    do_energy_transfer: bool
    electron_weight_fac: float
    n_xspec: int
    i_grid_feb: int
    i_shock: int
    nb: int
    # PSD binning
    psd_mom_min: float
    bins_per_dec_mom: int
    n_mom: int
    cos_fine: float
    dcos: float
    theta_min: float
    bins_per_dec_theta: int
    n_theta: int
    # theta_B = 0 everywhere (the only geometry the config admits,
    # check_shock_angle): enables the trig-free parallel transforms;
    # in this mode the scattering phase-angle adjustment is skipped
    # (its only observable is the pxz diagnostic, which the parallel
    # smoother hardcodes to zero, smoothers.jl:183)
    parallel: bool = True
    # custom f(r_g) MFP law (reserved in the reference,
    # scattering.jl:52-54): lambda = eta * r_g * (r_g/frg_rg0_cm)^
    # (frg_alpha - 1); frg_rg0_cm = 0 selects the standard eta*r_g
    frg_alpha: float = 1.0
    frg_rg0_cm: float = 0.0


def _mod2pi(x):
    return jnp.mod(x, 2.0 * jnp.pi)


def _lane_uniforms(state: ParticleState):
    """[B, N_UNIFORM] uniforms from (lane key, step counter).

    Cost-trimmed threefry: one fold_in block plus two blocks of raw
    bits per lane per step; the 8 uniforms are the 16-bit halves of
    the 4 raw words ((h + 0.5) / 2^16 in [0, 1), resolution 1.5e-5 —
    far below any physical sensitivity of the scattering/return
    draws).  Streams stay keyed by global lane index, preserving
    bitwise mesh-shape independence.
    """
    keys = jax.vmap(jax.random.fold_in)(
        state.key, state.nsteps.astype(jnp.uint32))
    words = jax.vmap(
        lambda k: jax.random.bits(k, (_N_UNIFORM // 2,), jnp.uint32))(keys)
    lo = (words & jnp.uint32(0xFFFF)).astype(jnp.float32)
    hi = (words >> jnp.uint32(16)).astype(jnp.float32)
    halves = jnp.concatenate([lo, hi], axis=1)        # [B, N_UNIFORM]
    return (halves + 0.5) * (1.0 / 65536.0)


def helix_step(state: ParticleState, tallies: Tallies,
               grids: SegmentGrids, sc: SegmentScalars,
               ss: StepStatic) -> tuple[ParticleState, Tallies]:
    """Advance every lane by one helix (or retro) step."""
    c = C_CGS
    m = sc.m
    mc = m * c
    e0 = m * c * c
    p_dtype = state.pb.dtype

    act = state.status == ACTIVE
    norm = act & ~state.retro
    do_block3 = norm & ~state.just_returned

    u = _lane_uniforms(state)

    # ---- gather zone fields ------------------------------------------------
    # all eight zone fields arrive through ONE one-hot [B, nb] x [nb, 8]
    # contraction (the stack is loop-invariant/hoisted).  HIGHEST keeps
    # the f32 product exact: the default lets the GPU round operands
    # to TF32 (10 mantissa bits), which would perturb zone velocities.
    ig = state.igrid
    zstack = jnp.stack([grids.ux, grids.uz, grids.utot, grids.gamma_sf,
                        grids.gamma_ef, grids.btot, grids.b_cos,
                        grids.b_sin], axis=1)          # [nb, 8]
    ig_oh = jax.nn.one_hot(ig, ss.nb, dtype=zstack.dtype)
    zf = jnp.einsum("bn,nf->bf", ig_oh, zstack,
                    preferred_element_type=zstack.dtype,
                    precision=lax.Precision.HIGHEST)    # [B, 8]
    ux, uz, utot, gsf = zf[:, 0], zf[:, 1], zf[:, 2], zf[:, 3]
    gef, bmag, bcos, bsin = zf[:, 4], zf[:, 5], zf[:, 6], zf[:, 7]

    if ss.use_custom_eps_b:
        # Blandford-McKee decay beyond the grid end
        # (particle_loop.jl:206-209)
        beyond = (state.x > sc.x_grid_stop)
        b_far = grids.btot[ss.nb - 2] * jnp.sqrt(
            sc.x_grid_stop / jnp.maximum(state.x, sc.x_grid_stop)
        ).astype(p_dtype)
        bmag = jnp.where(beyond, b_far, bmag)

    gyro_denom = 1.0 / (sc.abs_charge * bmag)

    pb, pperp, phi = state.pb, state.pperp, state.phi
    ptot = jnp.hypot(pb, pperp)
    gamma_pf = jnp.hypot(ptot / mc, 1.0)

    status = state.status
    reason = state.reason
    weight = state.weight

    # ---- Code Block 3 (particle_loop.jl:180-387) ---------------------------
    # frame re-transform when the lane crossed a flow gradient
    ux_now = ux
    changed = do_block3 & (ux_now != state.ux_prev)
    # old zone fields: the parallel-shock profile is fully described by
    # (ux_prev); uz = 0 and theta = 0 everywhere.  For generality we
    # reconstruct the old gamma from ux_prev.
    beta_old = state.ux_prev / c
    gsf_old = 1.0 / jnp.sqrt(jnp.maximum(1.0 - beta_old**2, 1.0e-30))
    if ss.parallel:
        pb_tr, g_tr = transform_p_psp_parallel(
            pb, pperp, gamma_pf, state.ux_prev, gsf_old, ux, gsf, m, c)
        pb = jnp.where(changed, pb_tr, pb)
    else:
        tr = transform_p_psp(
            pb, pperp, gamma_pf, phi,
            state.ux_prev, jnp.zeros_like(uz), jnp.abs(state.ux_prev),
            gsf_old, jnp.ones_like(bcos), jnp.zeros_like(bsin),
            ux, uz, utot, gsf, bcos, bsin, m, c)
        pb = jnp.where(changed, tr.pb_pf, pb)
        pperp = jnp.where(changed, tr.pperp_pf, pperp)
        phi = jnp.where(changed, tr.phi, phi)
    ptot = jnp.hypot(pb, pperp)
    gamma_pf = jnp.hypot(ptot / mc, 1.0)
    # the lane's momenta are now expressed in this zone's flow frame;
    # ux_prev tracks that frame (NOT the zone reached after moving)
    ux_prev = jnp.where(do_block3, ux_now, state.ux_prev)

    # escape: downstream with scattering disabled (particle_loop.jl:252-259)
    r_g_perp = pperp * c * gyro_denom
    if ss.dont_scatter:
        esc_noscat = do_block3 & (state.x > 10.0 * r_g_perp)
        status = jnp.where(esc_noscat, FINISHED, status)
        reason = jnp.where(esc_noscat, st.R_DOWNSTREAM, reason)
        do_block3 &= ~esc_noscat

    # escape: pmax in both frames (particle_loop.jl:261-275)
    if ss.parallel:
        ptot_sk0, _, _ = transform_p_ps_parallel(pb, pperp, gamma_pf, ux,
                                                 gsf, m, c)
    else:
        ptot_sk0 = transform_p_ps(pb, pperp, gamma_pf, phi, ux, uz, utot,
                                  gsf, bcos, bsin, m, c).ptot_sk
    esc_pmax = (do_block3 & (ptot > sc.pmax_cutoff)
                & (ptot_sk0 > sc.pmax_cutoff))
    status = jnp.where(esc_pmax, FINISHED, status)
    reason = jnp.where(esc_pmax, st.R_UPSTREAM_PMAX, reason)
    do_block3 &= ~esc_pmax

    # escape: upstream FEB after injection (particle_loop.jl:277-283)
    esc_feb = do_block3 & state.inj & (state.x < sc.feb_up)
    status = jnp.where(esc_feb, FINISHED, status)
    reason = jnp.where(esc_feb, st.R_UPSTREAM_PMAX, reason)
    do_block3 &= ~esc_feb

    # escape: age limit (particle_loop.jl:285-291)
    esc_age = do_block3 & (sc.age_max > 0) & (state.acctime > sc.age_max)
    status = jnp.where(esc_age, FINISHED, status)
    reason = jnp.where(esc_age, st.R_AGE, reason)
    do_block3 &= ~esc_age

    # radiative losses for electrons (particle_loop.jl:301-334)
    if ss.do_rad_losses and ss.is_electron:
        b_cmb_loc = sc.b_cmbz * gef
        p_lost = radiation_loss(bmag**2 + b_cmb_loc**2, ptot,
                                state.t_step.astype(p_dtype), RAD_LOSS_FAC)
        dead = do_block3 & (p_lost <= 0.0)
        scale = jnp.where(do_block3,
                          p_lost / jnp.maximum(ptot, 1.0e-300), 1.0)
        pb = pb * scale
        pperp = pperp * scale
        ptot = jnp.hypot(pb, pperp)
        gamma_pf = jnp.hypot(ptot / mc, 1.0)
        status = jnp.where(dead, FINISHED, status)
        reason = jnp.where(dead, st.R_RADIATED, reason)
        do_block3 &= ~dead

    # pitch-angle scattering (particle_loop.jl:338-345); cos_max takes
    # one of two precomputed values (coarse/fine step counts)
    if not ss.dont_scatter:
        cmax_coarse = math.cos(math.sqrt(
            12.0 * math.pi / (ss.xn_per_coarse * ss.eta_mfp)))
        cmax_fine = math.cos(math.sqrt(
            12.0 * math.pi / (ss.xn_per_fine * ss.eta_mfp)))
        cos_max = jnp.where(state.xn_per == ss.xn_per_coarse,
                            cmax_coarse, cmax_fine).astype(p_dtype)
        if ss.frg_rg0_cm > 0.0:
            # custom MFP law: lambda = eta*r_g*(r_g/r_ref)^(alpha-1)
            # => cos_max per lane (only the f(r_g) factor changes the
            # formula; scattering.jl:46-60)
            p_scat = jnp.where(
                jnp.asarray(ss.is_electron) & (ptot < sc.pe_crit),
                sc.pe_crit, ptot)
            r_g_s = p_scat * c * gyro_denom
            f_frg = (r_g_s / ss.frg_rg0_cm) ** (ss.frg_alpha - 1.0)
            cos_max = jnp.cos(jnp.sqrt(
                12.0 * jnp.pi
                / (state.xn_per * ss.eta_mfp
                   * jnp.maximum(f_frg, 1e-30)))).astype(p_dtype)
        res = scattering(u[:, _U_SCAT1], u[:, _U_SCAT2], pb, pperp, phi,
                         ptot, gamma_pf, state.xn_per, gyro_denom,
                         jnp.asarray(ss.is_electron), sc.pe_crit,
                         sc.gamma_e_crit, ss.eta_mfp, mc, c,
                         cos_max=cos_max,
                         phase_adjust=not ss.parallel)
        pb = jnp.where(do_block3, res.pb, pb)
        pperp = jnp.where(do_block3, res.pperp, pperp)
        phi = jnp.where(do_block3, res.phi, phi)

    # fresh gyro period / time step (scattering.jl:39-45 electron mod)
    if ss.is_electron:
        low_e = ptot < sc.pe_crit
        g_eff = jnp.where(low_e, sc.gamma_e_crit, gamma_pf)
    else:
        g_eff = gamma_pf
    gyro_period = 2.0 * jnp.pi * g_eff * mc * gyro_denom

    # acceleration time + tcuts + pcut save-out, downstream lanes only
    # (particle_loop.jl:347-381); uses the previous step's dt
    adding_time = do_block3 & state.downstream
    acct = state.acctime + jnp.where(
        adding_time, (state.t_step * gef).astype(st.X_DTYPE), 0.0)
    tcut_idx = state.tcut
    if ss.do_tcuts:
        n_slots = grids.tcuts.shape[0]
        # idx < n_slots guard: the reference relies on age_max killing
        # lanes before the last tcut (mc_in.toml age 3.15e11 < tcut
        # 3e13); the explicit guard keeps the last slot from re-firing
        # when a config violates that ordering
        fire = adding_time & (tcut_idx < n_slots) & (acct >= grids.tcuts[
            jnp.clip(tcut_idx, 0, n_slots - 1)])
        ip_pf = psd_bin_momentum(ptot, ss.psd_mom_min, ss.bins_per_dec_mom,
                                 ss.n_mom)
        wv = jnp.where(fire, weight, 0.0).astype(jnp.float64)
        tallies = tallies._replace(
            weight_coupled=tallies.weight_coupled.at[
                jnp.clip(tcut_idx, 0, n_slots - 1)].add(wv),
            spectra_coupled=tallies.spectra_coupled.at[
                ip_pf, jnp.clip(tcut_idx, 0, n_slots - 1)].add(wv),
        )
        tcut_idx = jnp.where(fire, tcut_idx + 1, tcut_idx)

    save = adding_time & (ptot > sc.pcut)
    status = jnp.where(save, SAVED, status)
    # keep the lane inside its PRP for the next pcut
    # (particle_loop.jl:373)
    prp_x = jnp.where(save & (state.x >= state.prp_x),
                      state.x * 1.1, state.prp_x)
    do_block3 &= ~save

    # coarse/fine step switch (particle_loop.jl:385)
    r_g_tot = ptot * c * gyro_denom
    xn_per = jnp.where(norm & (status == ACTIVE),
                       jnp.where(state.x > r_g_tot,
                                 ss.xn_per_coarse, ss.xn_per_fine),
                       state.xn_per).astype(p_dtype)

    # ---- Code Block 2: movement (particle_loop.jl:392-451) -----------------
    moving = (status == ACTIVE) & ~state.retro
    t_step = (gyro_period / xn_per).astype(p_dtype)

    phi_old = phi
    x_old = state.x
    x_move = pb * t_step / (gamma_pf * m)
    r_g_perp = pperp * c * gyro_denom

    done_move = ~moving
    pb_m, phi_m = pb, phi
    x_new = x_old
    phi_fin = phi
    for k in range(_N_REFLECT_TRIES):
        phi_try = _mod2pi(phi_m + 2.0 * jnp.pi / xn_per)
        x_move = pb_m * t_step / (gamma_pf * m)
        if ss.parallel:
            # b_sin = 0: the gyro-phase excursion term vanishes
            dx = gsf * (x_move + ux * t_step)
        else:
            dx = gsf * (x_move * bcos
                        - r_g_perp * bsin
                        * (jnp.cos(phi_try) - jnp.cos(phi_old))
                        + ux * t_step)
        x_try = x_old + dx.astype(st.X_DTYPE)
        # reflection at the shock when DSA is off or the injection
        # test fails (no_DSA_loop, particle_loop.jl:510-571); inj_frac
        # is a dynamic scalar so the branch is always compiled and the
        # mask gates it off when inj_frac == 1 and DSA is on
        cross_up = ((x_try <= 0.0) & (x_old > 0.0) & ~state.inj
                    & (ss.dont_dsa | (sc.inj_frac < 1.0)))
        fail = (jnp.asarray(ss.dont_dsa)
                | (u[:, _U_REFL_INJ[k]] > sc.inj_frac))
        refl = ~done_move & cross_up & fail
        accept = ~done_move & ~refl
        x_new = jnp.where(accept, x_try, x_new)
        phi_fin = jnp.where(accept, phi_try, phi_fin)
        done_move |= accept
        neg = pb_m < 0.0
        pb_m = jnp.where(refl & neg, -pb_m, pb_m)
        phi_m = jnp.where(refl & ~neg,
                          (u[:, _U_REFL_PHI[k]] * 2.0 * jnp.pi
                           ).astype(p_dtype),
                          phi_m)
    # force remaining lanes through (reflection nearly always settles
    # in one retry; cap mirrors the bounded-loop design)
    phi_try = _mod2pi(phi_m + 2.0 * jnp.pi / xn_per)
    x_move = pb_m * t_step / (gamma_pf * m)
    if ss.parallel:
        dx = gsf * (x_move + ux * t_step)
    else:
        dx = gsf * (x_move * bcos
                    - r_g_perp * bsin
                    * (jnp.cos(phi_try) - jnp.cos(phi_old))
                    + ux * t_step)
    x_new = jnp.where(done_move, x_new, x_old + dx.astype(st.X_DTYPE))
    phi_fin = jnp.where(done_move, phi_fin, phi_try)
    pb = jnp.where(moving, pb_m, pb)
    phi = jnp.where(moving, phi_fin, phi)

    # first downstream crossing sets the PRP at >= one diffusion length
    # (particle_loop.jl:412-429)
    first_dw = moving & (x_old < 0.0) & (x_new >= 0.0)
    downstream = state.downstream | first_dw
    l_diff0 = (ss.eta_mfp / 3.0 * r_g_tot * ptot
               / (m * gamma_pf * sc.u2)).astype(st.X_DTYPE)
    prp_x = jnp.where(first_dw, jnp.maximum(prp_x, l_diff0), prp_x)

    # injection flag: back upstream after having been downstream
    inj = state.inj | (moving & downstream & (x_new < 0.0))

    # ---- all_flux: tallies + new zone (all_flux.jl:45-259) -----------------
    # branchless zone lookup: a [B, nb] compare + row-sum fuses into
    # one elementwise/reduce kernel (searchsorted would emit a gather
    # cascade with per-op launch overhead)
    ig_new = (jnp.sum(x_new[:, None] >= grids.x_grid[None, :],
                      axis=1).astype(jnp.int32) - 1)
    ig_new = jnp.clip(ig_new, 0, ss.nb - 2)
    ig_new = jnp.where(moving, ig_new, ig)

    if ss.parallel:
        from .transforms import ShockFrameMomentum
        pt_sk, px_sk, g_sk = transform_p_ps_parallel(
            pb, pperp, gamma_pf, ux, gsf, m, c)
        # p_z = p_perp cos(phi + pi/2) = -p_perp sin(phi); only the
        # (parallel-ignored) pxz diagnostic uses it
        pz_sk = -pperp * jnp.sin(phi)
        sk = ShockFrameMomentum(pt_sk, px_sk, jnp.zeros_like(px_sk),
                                pz_sk, g_sk)
    else:
        sk = transform_p_ps(pb, pperp, gamma_pf, phi, ux, uz, utot, gsf,
                            bcos, bsin, m, c)
    spike = sk.ptot_sk > jnp.abs(sk.px_sk) * ALL_FLUX_SPIKE_AWAY
    abs_inv_vx = jnp.where(
        spike,
        jnp.abs(ALL_FLUX_SPIKE_AWAY / ux),
        jnp.abs(sk.gamma_sk * m / jnp.where(sk.px_sk == 0.0, 1.0e-300,
                                            sk.px_sk)))
    rel = (sk.gamma_sk - 1.0) > E_REL_PT
    e_add = jnp.where(rel, (sk.gamma_sk - 1.0) * e0 * weight,
                      sk.ptot_sk**2 / (2.0 * m) * weight)

    moved_down = x_new > x_old
    lo = jnp.where(moved_down, ig + 1, ig_new + 1)
    hi = jnp.where(moved_down, ig_new, ig)
    # injected lanes moving upstream skip zones at/above the FEB
    # (F_stream!, all_flux.jl:223)
    lo = jnp.where(~moved_down & inj,
                   jnp.maximum(lo, ss.i_grid_feb + 1), lo)
    crossed = moving & (hi >= lo)
    lo_c = jnp.clip(lo, 0, ss.nb - 1)
    hi_c = jnp.clip(hi, 0, ss.nb - 1)

    sign_fac = jnp.where(moved_down, 1.0, -1.0).astype(p_dtype)
    g0u0 = sc.gamma0_u0
    on = crossed.astype(p_dtype)
    vals = jnp.stack([
        sign_fac * sk.px_sk * weight * g0u0 * on,
        jnp.abs(sk.pz_sk) * weight * g0u0 * on,
        sign_fac * e_add * g0u0 * on,
        (crossed & ~inj).astype(p_dtype),
    ])                                               # [4, B]

    ip_sk = psd_bin_momentum(sk.ptot_sk, ss.psd_mom_min,
                             ss.bins_per_dec_mom, ss.n_mom)
    jt_sk = psd_bin_angle(sk.px_sk, sk.ptot_sk, ss.cos_fine, ss.dcos,
                          ss.theta_min, ss.bins_per_dec_theta, ss.n_theta)
    psd_w = (weight * abs_inv_vx * crossed).astype(tallies.psd_diff.dtype)
    # CR and thermal histograms share one flat (ip, kind, jt) cell
    # axis; kind 0 = injected (CR), 1 = thermal.
    kind = (~inj).astype(jnp.int32)
    cell = (ip_sk * 2 + kind) * (ss.n_theta + 1) + jt_sk

    # record the step's crossings in ONE packed dynamic write; flush
    # every `chunk` steps (chunk = the buffer's static leading extent).
    # Index rows are stored exactly as floats (all values < 2^24).
    chunk = tallies.rec.shape[0]
    phase = jnp.mod(tallies.step_phase, chunk)
    rd = tallies.rec.dtype
    rec = jnp.concatenate([
        vals.astype(rd),
        psd_w.astype(rd)[None, :],
        lo_c.astype(rd)[None, :],
        hi_c.astype(rd)[None, :],
        cell.astype(rd)[None, :],
    ])                                                     # [8, B]
    tallies = tallies._replace(
        rec=tallies.rec.at[phase].set(rec),
        step_phase=tallies.step_phase + 1,
    )
    tallies = lax.cond(phase == chunk - 1,
                       lambda t: _flush_records(t, ss),
                       lambda t: t, tallies)

    # ---- ion <-> electron energy transfer (do_energy_transfer,
    # particle_loop.jl:652-723) ------------------------------------------
    # Applied on upstream pre-injection zone crossings.  Ions donate
    # energy set by the eps_target schedule into the pool (spread
    # uniformly over the crossed range — the reference splits over
    # eps>0 zones only; totals are identical and electrons integrate
    # the same range); electrons add the pooled energy scaled by the
    # per-MC-particle electron count.  The reference applies this one
    # step later (before the next move); statistically equivalent.
    if ss.do_energy_transfer:
        hi_t = jnp.minimum(hi_c, ss.i_shock)
        xfer = (crossed & ~inj & (x_old <= 0.0) & (hi_t >= lo_c)
                & (status == ACTIVE))
        gamma_now = jnp.hypot(jnp.hypot(pb, pperp) / mc, 1.0)
        if not ss.is_electron:
            eps_stop = grids.eps_target[jnp.clip(hi_t, 0, ss.nb - 1)]
            eps_start = grids.eps_target[ig]
            g_f = 1.0 + (gamma_now - 1.0) * (1.0 - eps_stop) \
                / jnp.maximum(1.0 - eps_start, 1e-30)
            donate = xfer & (eps_stop > 0.0)
            g_f = jnp.where(donate, jnp.maximum(g_f, 1.0), gamma_now)
            n_range = (hi_t - lo_c + 1).astype(p_dtype)
            inc = jnp.where(donate,
                            (gamma_now - g_f) * e0 * weight
                            / jnp.maximum(n_range, 1.0), 0.0)
            tallies = tallies._replace(
                pool_diff=tallies.pool_diff
                .at[jnp.clip(lo_c, 0, ss.nb)].add(inc.astype(jnp.float64))
                .at[jnp.clip(hi_t + 1, 0, ss.nb)]
                .add(-inc.astype(jnp.float64)))
        else:
            gain = (grids.recv_prefix[jnp.clip(hi_t + 1, 0, ss.nb)]
                    - grids.recv_prefix[jnp.clip(lo_c, 0, ss.nb)]
                    ).astype(p_dtype) * ss.electron_weight_fac
            g_f = jnp.where(xfer & (gain > 0.0),
                            gamma_now + gain / e0, gamma_now)
        scale = jnp.sqrt(jnp.maximum(g_f**2 - 1.0, 0.0)) \
            / jnp.maximum(jnp.sqrt(jnp.maximum(gamma_now**2 - 1.0, 0.0)),
                          1e-30)
        scale = jnp.where(xfer & (g_f != gamma_now), scale, 1.0)
        pb = pb * scale
        pperp = pperp * scale

    # escaping flux at the upstream FEB (all_flux.jl:153-159)
    esc_cross = moving & inj & (x_new < sc.feb_up) & (x_old >= sc.feb_up)
    tallies = tallies._replace(
        en_esc_up=tallies.en_esc_up + jnp.sum(
            jnp.where(esc_cross, e_add * g0u0, 0.0).astype(jnp.float64)),
        px_esc_up=tallies.px_esc_up - jnp.sum(
            jnp.where(esc_cross, sk.px_sk * weight * g0u0, 0.0)
            .astype(jnp.float64)),
    )

    # x_spec detector spectra (calculate_x_spec_spectra!,
    # all_flux.jl:164-190)
    if ss.n_xspec > 0:
        ip_pf2 = psd_bin_momentum(ptot, ss.psd_mom_min,
                                  ss.bins_per_dec_mom, ss.n_mom)
        pt_o_px_sk = jnp.where(spike, ALL_FLUX_SPIKE_AWAY,
                               sk.ptot_sk / jnp.where(sk.px_sk == 0.0,
                                                      1.0e-300, sk.px_sk))
        pt_o_px_pf = jnp.minimum(
            jnp.abs(ptot / jnp.where(pb == 0.0, 1.0e-300, pb)),
            ALL_FLUX_SPIKE_AWAY)
        f_weight = (jnp.abs(pb / jnp.where(sk.px_sk == 0.0, 1.0e-300,
                                           sk.px_sk))
                    * sk.gamma_sk / gamma_pf)
        for i in range(ss.n_xspec):
            xs = grids.x_spec[i]
            hit = moving & (((x_old < xs) & (x_new >= xs))
                            | ((x_new <= xs) & (x_old > xs)))
            tallies = tallies._replace(
                spectra_sf=tallies.spectra_sf.at[ip_sk, i].add(
                    jnp.where(hit, weight * pt_o_px_sk, 0.0)
                    .astype(jnp.float64)),
                spectra_pf=tallies.spectra_pf.at[ip_pf2, i].add(
                    jnp.where(hit, weight * pt_o_px_pf * f_weight, 0.0)
                    .astype(jnp.float64)),
            )

    # ---- downstream escape / return (particle_loop.jl:453-495) -------------
    (status, reason, prp_x, x_new, pb, pperp, phi, retro,
     just_ret) = _downstream_logic(
        moving, status, reason, x_old, x_new, prp_x, pb, pperp, phi,
        ptot, gamma_pf, u, sc, ss, gyro_denom, m, c, state)

    # downstream-escape pressure/KE accumulators
    # (particle_loop.jl:477-495); species density applied by the engine
    esc_dw = moving & (status == FINISHED) & (reason == st.R_DOWNSTREAM)
    vel = ptot / m
    vel = jnp.where((gamma_pf - 1.0) >= E_REL_PT, vel / gamma_pf, vel)
    tallies = tallies._replace(
        sum_p_dw=tallies.sum_p_dw + jnp.sum(
            jnp.where(esc_dw, ptot / 3.0 * vel * weight, 0.0)
            .astype(jnp.float64)),
        sum_ke_dw=tallies.sum_ke_dw + jnp.sum(
            jnp.where(esc_dw, (gamma_pf - 1.0) * e0 * weight, 0.0)
            .astype(jnp.float64)),
    )

    # ---- retro-time walk for lanes in retro mode ---------------------------
    if ss.do_retro:
        (status, reason, x_new, pb, pperp, phi, acct, tcut_idx, retro,
         just_ret, tallies) = _retro_step(
            act & state.retro, status, reason, state.x, prp_x, pb, pperp,
            phi, acct, tcut_idx, u, grids, sc, ss, m, c, tallies, weight,
            x_new, retro, just_ret)

    # helix cap (particle_loop.jl:162-165)
    nsteps = state.nsteps + (state.status == ACTIVE)
    capped = (status == ACTIVE) & (nsteps >= MAX_HELIX_STEPS)
    status = jnp.where(capped, FINISHED, status)
    reason = jnp.where(capped, st.R_DOWNSTREAM, reason)

    # pin carry dtypes (guards the f32 path against silent upcasts)
    return ParticleState(
        weight=weight.astype(p_dtype), pb=pb.astype(p_dtype),
        pperp=pperp.astype(p_dtype), phi=phi.astype(p_dtype), x=x_new,
        igrid=ig_new, ux_prev=ux_prev.astype(p_dtype),
        downstream=downstream, inj=inj,
        xn_per=xn_per.astype(p_dtype), prp_x=prp_x,
        acctime=acct, tcut=tcut_idx, status=status, reason=reason,
        retro=retro, just_returned=just_ret, key=state.key,
        nsteps=nsteps,
        t_step=jnp.where(moving, t_step, state.t_step).astype(p_dtype),
    ), tallies


def _flush_records(t: Tallies, ss: StepStatic) -> Tallies:
    """Flush the chunked crossing records into the tally arrays: one
    signed one-hot range contraction for the four flux channels and a
    flat scatter pair for the (p, theta, zone) histogram, per chunk of
    steps instead of per step."""
    lo = t.rec[:, 5, :].reshape(-1).astype(jnp.int32)
    hi = t.rec[:, 6, :].reshape(-1).astype(jnp.int32)
    cell = t.rec[:, 7, :].reshape(-1).astype(jnp.int32)
    dtype = t.rec.dtype
    range_oh = (jax.nn.one_hot(lo, ss.nb + 1, dtype=dtype)
                - jax.nn.one_hot(hi + 1, ss.nb + 1, dtype=dtype))
    vals = jnp.moveaxis(t.rec[:, :4, :], 1, 0).reshape(4, -1)
    # HIGHEST: the flux tallies feed the smoothing solve; a TF32
    # product would keep ~3 decimal digits of each record
    delta = jnp.einsum("cb,bn->cn", vals, range_oh,
                       preferred_element_type=dtype,
                       precision=lax.Precision.HIGHEST)
    flux_diff = t.flux_diff + delta.astype(jnp.float64)

    w = t.rec[:, 4, :].reshape(-1).astype(t.psd_diff.dtype)
    base = cell * (ss.nb + 1)
    psd_flat = t.psd_diff.reshape(-1)
    psd_flat = psd_flat.at[base + lo].add(w)
    psd_flat = psd_flat.at[base + hi + 1].add(-w)
    psd = psd_flat.reshape(t.psd_diff.shape)

    return t._replace(
        flux_diff=flux_diff,
        psd_diff=psd,
        rec=jnp.zeros_like(t.rec),
    )


def run_segment(state: ParticleState, tallies: Tallies,
                grids: SegmentGrids, sc: SegmentScalars,
                ss: StepStatic,
                compact_levels: int = 0,
                horizon=None
                ) -> tuple[ParticleState, Tallies]:
    """Advance all lanes until none are ACTIVE (one pcut segment).

    The helix cap inside `helix_step` bounds the loop at
    MAX_HELIX_STEPS, mirroring particle_loop.jl:162-165, so the
    while_loop always terminates.

    `horizon` (traced i32 scalar, optional) additionally stops the
    loop once every still-active lane has taken `horizon` steps this
    segment.  Because every ACTIVE lane steps on every while trip,
    all active lanes share one nsteps value, so this bounds the TRIP
    count of the device program — the host-chunked drain for deep
    helix caps.  Use run_segment_chunked for the host loop.

    compact_levels > 0 turns on live-lane compaction: lanes die at
    wildly different step counts (most thermal lanes escape within
    ~1e2 steps while a few accelerate for ~1e4), and a plain batched
    while_loop burns full-batch work until the LAST lane drains.
    The ladder runs the loop on a static window, and whenever the
    active population falls below the next half-size it partitions
    active lanes to the front (stable sort) and continues on the front
    half only — all static shapes, so the whole ladder stays inside
    one jitted program.  Per-lane trajectories are bitwise unchanged
    (counter RNG is keyed by lane key x nsteps); only the summation
    ORDER of the shared tallies changes, i.e. results differ from the
    uncompacted path at float-rounding level only.  Lanes return in
    their original order.
    """

    def cond_any(carry):
        s, _ = carry
        a = s.status == ACTIVE
        if horizon is not None:
            a &= s.nsteps < horizon
        return jnp.any(a)

    def body(carry):
        s, t = carry
        return helix_step(s, t, grids, sc, ss)

    b = state.weight.shape[0]
    sizes = [b]
    for _ in range(max(compact_levels, 0)):
        nxt = sizes[-1] // 2
        # keep windows 128-lane aligned and big enough to fill the
        # device
        if nxt < 512 or nxt % 128 != 0:
            break
        sizes.append(nxt)

    if len(sizes) == 1:
        state, tallies = lax.while_loop(cond_any, body, (state, tallies))
        # flush any residual partial chunk (buffers are zeroed at every
        # flush, so the leftover slots contribute exactly once)
        tallies = _flush_records(tallies, ss)
        return state, tallies

    chunk = tallies.rec.shape[0]
    rd = tallies.rec.dtype
    # the ladder gives every window its own record buffer: flush any
    # pending caller records first so none are dropped
    tallies = _flush_records(tallies, ss)
    # carry each lane's ORIGINAL slot inside the permuted tree (as a
    # sibling of the state) so the bookkeeping can never desynchronize
    # from the lane data
    orig = jnp.arange(b)
    full = (state, orig)
    for i, size in enumerate(sizes):
        last = i == len(sizes) - 1
        win_st, win_orig = jax.tree.map(lambda a: a[:size], full)
        win_tal = tallies._replace(
            rec=jnp.zeros((chunk, 8, size), rd),
            step_phase=jnp.zeros((), jnp.int32))

        if last:
            cond = cond_any
        else:
            nxt = sizes[i + 1]

            def cond(carry, _nxt=nxt):
                s, _ = carry
                a = s.status == ACTIVE
                live = a if horizon is None else a & (s.nsteps
                                                      < horizon)
                return jnp.any(live) & (jnp.sum(a) > _nxt)

        win_st, win_tal = lax.while_loop(cond, body, (win_st, win_tal))
        win_tal = _flush_records(win_tal, ss)
        tallies = win_tal._replace(rec=tallies.rec,
                                   step_phase=tallies.step_phase)

        if not last:
            # partition the (now <= next-size) active lanes to the
            # front of this window (stable: equal-status lanes keep
            # their relative order) so the next, halved window holds
            # every remaining active lane
            # optimization_barriers: without them XLA:CPU miscompiles
            # the argsort -> gather -> dynamic_update_slice chain
            # between while_loops (lane payloads and the orig
            # bookkeeping end up permuted INCONSISTENTLY; reproduced on
            # jax 0.8, 2-level ladder — adding debug outputs makes the
            # corruption vanish, the classic fusion-bug signature).
            order = lax.optimization_barrier(
                jnp.argsort(win_st.status != ACTIVE, stable=True))
            win_st = jax.tree.map(lambda a: a[order], win_st)
            win_orig = win_orig[order]
            win_st, win_orig = lax.optimization_barrier(
                (win_st, win_orig))

        full = jax.tree.map(
            lambda fa, wa: lax.dynamic_update_slice_in_dim(
                fa, wa, 0, axis=0), full, (win_st, win_orig))

    # restore original lane order: lane in slot i belongs at orig[i]
    state_out, orig = full
    inv = jnp.zeros_like(orig).at[orig].set(jnp.arange(b))
    state_out = jax.tree.map(lambda a: a[inv], state_out)
    # every window flushed its own rec buffer; hand back a clean one
    tallies = tallies._replace(rec=jnp.zeros_like(tallies.rec),
                               step_phase=jnp.zeros((), jnp.int32))
    return state_out, tallies


run_segment_jit = jax.jit(run_segment, static_argnums=(4, 5),
                          donate_argnums=(0, 1))

# bounded variant: the horizon rides as a TRACED scalar so raising it
# between host dispatches does not recompile
run_segment_hjit = jax.jit(run_segment, static_argnums=(4, 5),
                           donate_argnums=(0, 1))


def xla_steps_per_prog() -> int:
    """Per-program trip budget for the host-chunked drains (0 disables
    chunking).  Engaged when MAX_HELIX_STEPS exceeds it, so a deep-cap
    segment runs as a sequence of bounded device programs."""
    return int(os.environ.get("MCS_XLA_STEPS_PER_PROG", "25000"))


def chunked_drain() -> bool:
    """Whether segment drains run host-chunked at the current cap."""
    return 0 < xla_steps_per_prog() < MAX_HELIX_STEPS


def run_segment_chunked(state: ParticleState, tallies: Tallies,
                        grids: SegmentGrids, sc: SegmentScalars,
                        ss: StepStatic, compact_levels: int = 0,
                        budget: int = 0
                        ) -> tuple[ParticleState, Tallies]:
    """Host-chunked drain for the XLA engine: re-dispatch
    run_segment with a rising step horizon until no lane is ACTIVE,
    so no single device program exceeds `budget` while-trips.

    Per-lane trajectories are bitwise identical to the monolithic
    run_segment (the RNG counter is the per-lane step count).  Tally
    sums can differ at float-rounding order across chunk boundaries:
    the record buffer flushes its partial chunk at each program exit,
    and the compaction ladder restarts from the full batch on
    re-entry (tests/test_chunked_drain.py pins compact_levels=0
    tallies to float tolerance and the state exactly)."""
    budget = budget or xla_steps_per_prog()
    if budget <= 0 or MAX_HELIX_STEPS <= budget:
        return run_segment_jit(state, tallies, grids, sc, ss,
                               compact_levels)
    horizon = budget
    while True:
        state, tallies = run_segment_hjit(
            state, tallies, grids, sc, ss, compact_levels,
            jnp.int32(horizon))
        if horizon >= MAX_HELIX_STEPS or not bool(
                jnp.any(state.status == ACTIVE)):
            break
        horizon += budget
    return state, tallies


def _downstream_logic(moving, status, reason, x_old, x_new, prp_x,
                      pb, pperp, phi, ptot, gamma_pf, u, sc, ss,
                      gyro_denom, m, c, state):
    """downstream_test + prob_return (particle_loop.jl:595-637,
    prob_return.jl:36-173) as masked updates."""
    p_dtype = pb.dtype
    retro = state.retro
    just_ret = jnp.zeros_like(state.just_returned)

    # L_diff with the electron constant-MFP regime
    # (downstream_test, particle_loop.jl:609-633)
    if ss.is_electron:
        low_e = ptot < sc.pe_crit
        v_fac = jnp.where(
            low_e,
            (sc.pe_crit * c * gyro_denom) * sc.pe_crit
            / (m * sc.gamma_e_crit * sc.u2),
            (ptot * c * gyro_denom) * ptot / (m * gamma_pf * sc.u2))
    else:
        v_fac = (ptot * c * gyro_denom) * ptot / (m * gamma_pf * sc.u2)
    l_diff = (ss.eta_mfp / 3.0 * v_fac).astype(st.X_DTYPE)

    # hard downstream FEB
    esc_feb_dw = moving & (sc.feb_dw > 0.0) & (x_new > sc.feb_dw)
    # way past the PRP: cull without the return test
    esc_far = (moving & ~esc_feb_dw & (x_new > 1.1 * prp_x)
               & (x_new > 6.91 * l_diff))
    do_ret = moving & ~esc_feb_dw & ~esc_far

    # prob_return branch structure (prob_return.jl:54-167)
    past_end = do_ret & (x_new >= sc.x_grid_stop)
    just_crossed_end = past_end & (x_old < sc.x_grid_stop)
    # PRP placement three diffusion lengths past the current position,
    # using the downstream field (prob_return.jl:59-85)
    gyro_tmp = jnp.ones_like(ptot)
    if ss.use_custom_eps_b:
        gyro_tmp = jnp.sqrt(sc.x_grid_stop
                            / jnp.maximum(x_new, sc.x_grid_stop)
                            ).astype(p_dtype)
    r_g2 = ptot * c * gyro_tmp / (sc.abs_charge * sc.bmag2)
    l_diff2 = (ss.eta_mfp / 3.0 * r_g2 * ptot
               / (m * gamma_pf * sc.u2)).astype(st.X_DTYPE)
    prp_x = jnp.where(just_crossed_end, x_new + 3.0 * l_diff2, prp_x)

    # PRP crossing: the Jones & Ellison (1991) return probability
    crossed_prp = past_end & ~just_crossed_end & (x_old < prp_x) \
        & (x_new >= prp_x)
    vt = ptot / (gamma_pf * m)
    p_ret = ((vt - sc.u2) / (vt + sc.u2)) ** 2
    no_return = crossed_prp & ((vt < sc.u2) | (u[:, _U_PRET] > p_ret))
    status = jnp.where(no_return, FINISHED, status)
    reason = jnp.where(no_return, st.R_DOWNSTREAM, reason)

    returns = crossed_prp & ~no_return
    if ss.do_retro:
        # enter the explicit backward walk at the PRP with a fresh
        # phase (retro_time, prob_return.jl:249-252)
        retro = retro | returns
        x_new = jnp.where(returns, prp_x, x_new)
        phi = jnp.where(returns,
                        (u[:, _U_RET_PHI] * 2.0 * jnp.pi).astype(p_dtype),
                        phi)
    else:
        # Analytic return at the PRP.  The reference never implemented
        # this path (prob_return.jl:130-138 errors); we place the
        # particle back on the plane with a flux-weighted inward pitch:
        # P(mu) d mu ~ |v mu - u2| for v mu < u2 (the EBJ-1996
        # Appendix A3 construction), sampled by inverse transform.
        vmu_min = -vt                         # most inward-moving
        span = sc.u2 - vmu_min                # flux-weight support
        vmu = sc.u2 - span * jnp.sqrt(u[:, _U_RET_MU])
        mu = jnp.clip(vmu / jnp.maximum(vt, 1.0e-300), -1.0, 1.0)
        pb_ret = (ptot * mu).astype(p_dtype)
        pperp_ret = jnp.sqrt(jnp.maximum(ptot**2 - pb_ret**2, 0.0))
        pb = jnp.where(returns, pb_ret, pb)
        pperp = jnp.where(returns, pperp_ret, pperp)
        phi = jnp.where(returns,
                        (u[:, _U_RET_PHI] * 2.0 * jnp.pi).astype(p_dtype),
                        phi)
        x_new = jnp.where(returns, prp_x, x_new)
        just_ret = just_ret | returns

    # electron PRP shrink heuristics (prob_return.jl:142-164)
    if ss.is_electron:
        idle = past_end & ~just_crossed_end & ~crossed_prp
        check = (idle & (ptot < sc.pcut_prev)
                 & (jnp.mod(state.nsteps, 1000) == 0))
        r_g = ptot * c * gyro_denom
        l_d = (ss.eta_mfp / 3.0 * r_g * ptot
               / (m * gamma_pf * sc.u2)).astype(st.X_DTYPE)
        far = x_new > 2.0e3 * l_d
        shrink = jnp.where(
            far, 0.8 * x_new,
            jnp.minimum(prp_x, sc.x_grid_stop + l_d
                        * (sc.pcut_prev
                           / jnp.maximum(ptot, 1.0e-300)) ** 5))
        prp_x = jnp.where(check, shrink, prp_x)

    esc = esc_feb_dw | esc_far
    status = jnp.where(esc, FINISHED, status)
    reason = jnp.where(esc, st.R_DOWNSTREAM, reason)
    return (status, reason, prp_x, x_new, pb, pperp, phi, retro, just_ret)


def _retro_step(in_retro, status, reason, x, prp_x, pb, pperp, phi,
                acct, tcut_idx, u, grids, sc, ss, m, c, tallies, weight,
                x_new_out, retro, just_ret):
    """One step of the backward 'retrodictive' walk
    (retro_time, prob_return.jl:217-344): reversed downstream flow,
    large-angle scattering, radiative losses, tcut tracking."""
    p_dtype = pb.dtype
    nb = ss.nb
    xn_per_retro = 10.0

    b2 = grids.btot[nb - 2]
    if ss.use_custom_eps_b:
        b2 = b2 * jnp.sqrt(sc.x_grid_stop
                           / jnp.maximum(x, sc.x_grid_stop)).astype(p_dtype)
    gden = 1.0 / (sc.abs_charge * b2)
    gsf = grids.gamma_sf[nb - 2]
    gef = grids.gamma_ef[nb - 2]
    bcos = grids.b_cos[nb - 2]
    bsin = grids.b_sin[nb - 2]
    u_back = -grids.ux[nb - 2]
    b_cmb_loc = sc.b_cmbz * gef

    ptot = jnp.hypot(pb, pperp)
    gamma_pf = jnp.hypot(ptot / (m * c), 1.0)
    t_fac = 2.0 * jnp.pi * m * c * gden / xn_per_retro
    t_step = t_fac * gamma_pf

    phi_old = phi
    phi_new = _mod2pi(phi + 2.0 * jnp.pi / xn_per_retro)
    x_move = pb * t_fac / m
    r_g = pperp * c * gden
    if ss.parallel:
        dx = gsf * (x_move + u_back * t_step)
    else:
        dx = gsf * (x_move * bcos
                    - r_g * bsin * (jnp.cos(phi_new) - jnp.cos(phi_old))
                    + u_back * t_step)
    x_try = x + dx.astype(st.X_DTYPE)

    acct_new = acct + (t_step * gef).astype(st.X_DTYPE)

    # tcut tracking continues during the replay (prob_return.jl:297-304)
    if ss.do_tcuts:
        n_slots = grids.tcuts.shape[0]
        slot = jnp.clip(tcut_idx, 0, n_slots - 1)
        fire = (in_retro & (tcut_idx < n_slots)
                & (acct_new >= grids.tcuts[slot]))
        ip_pf = psd_bin_momentum(ptot, ss.psd_mom_min, ss.bins_per_dec_mom,
                                 ss.n_mom)
        wv = jnp.where(fire, weight, 0.0).astype(jnp.float64)
        tallies = tallies._replace(
            weight_coupled=tallies.weight_coupled.at[slot].add(wv),
            spectra_coupled=tallies.spectra_coupled.at[ip_pf, slot].add(wv),
        )
        tcut_new = jnp.where(fire, tcut_idx + 1, tcut_idx)
    else:
        tcut_new = tcut_idx

    # large-angle scattering: full randomization (prob_return.jl:306-311)
    phi_las = (2.0 * jnp.pi * u[:, _U_RETRO_PHI]).astype(p_dtype)
    mu_las = 2.0 * u[:, _U_RETRO_MU] - 1.0

    # radiative losses during the walk (prob_return.jl:316-318)
    p_new = ptot
    if ss.do_rad_losses and ss.is_electron:
        p_new = radiation_loss(b2**2 + b_cmb_loc**2, ptot,
                               t_step.astype(p_dtype), RAD_LOSS_FAC)
    dead = in_retro & (p_new <= 0.0)
    pb_new = (p_new * mu_las).astype(p_dtype)
    pperp_new = jnp.sqrt(jnp.maximum(p_new**2 - pb_new**2, 0.0))

    returned = in_retro & ~dead & (x_try < prp_x)

    # commit
    apply = in_retro
    x_out = jnp.where(apply, jnp.where(returned, prp_x, x_try), x_new_out)
    pb = jnp.where(apply, pb_new, pb)
    pperp = jnp.where(apply, pperp_new, pperp)
    phi = jnp.where(apply, phi_las, phi)
    acct = jnp.where(apply, acct_new, acct)
    status = jnp.where(dead, FINISHED, status)
    reason = jnp.where(dead, st.R_RADIATED, reason)
    retro = jnp.where(returned | dead, False, retro)
    just_ret = just_ret | returned
    return (status, reason, x_out, pb, pperp, phi, acct, tcut_new,
            retro, just_ret, tallies)
