"""Emission driver: per-shell/zone photon production + SED summation.

Re-derives photon_calcs.jl:10-161 and get_summed_emission.jl:37-415
with a pure array dataflow — the reference's scratch-file round trip
(photon_*_grid.dat re-reads) is replaced by in-memory per-zone grids,
which is what SURVEY.md section 7 prescribes (the reference's emission
file plumbing is non-functional Fortran transliteration; the physics
kernels are the spec).

Frames: pion and synchrotron spectra are computed in the local plasma
frame and Doppler-shifted into the ISM frame here; IC is computed
directly in the ISM frame (photon_calcs.jl:148-158 note).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ...utils.constants import C_CGS, KPC_CM, ME_C2, MEV_ERG, MPC_CM
from .inverse_compton import ic_emission, ic_photon_energy_grid
from .pion import pion_emission
from .synchrotron import photon_energy_grid, synch_emission

# photon grid constants (photon_calcs.jl:10-19), energies in MeV
EG_MIN_MEV = 1.0e-13
EG_MAX_MEV = 1.0e12
BINS_PER_DEC_PHOTON = 10
EG_PION_MIN_MEV = 1.0
EG_SYNCH_MIN_MEV = EG_MIN_MEV
EG_SYNCH_MAX_MEV = 1.0e5
EG_IC_MIN_MEV = 1.0e-2

N_COS_BINS = 180   # Doppler-shift angle resolution (get_summed:111)


def jnp_f64(a):
    """Device array in f64 (emission runs in full IEEE f64 precision:
    the CGS magnitudes reach ~1e118, beyond f32's exponent range, and
    parity with the NumPy oracle matters more than f32 speed)."""
    import jax.numpy as jnp
    return jnp.asarray(np.asarray(a), jnp.float64)


def _n_photon(emin, emax):
    return int(math.log10(emax / emin) * BINS_PER_DEC_PHOTON)


@dataclass
class EmissionResult:
    """Per-zone and summed photon spectra.

    Grids are dP/d(lnE) energy flux at Earth [erg/(cm^2 s)]; energies
    in erg.
    """

    e_pion: np.ndarray          # [n_pion]
    e_synch: np.ndarray
    e_ic: np.ndarray
    pion_grid: np.ndarray       # [n_pion, nb] per-zone (plasma frame)
    synch_grid: np.ndarray
    ic_grid: np.ndarray         # (ISM frame)
    pion_shell: np.ndarray      # [n_pion, n_shells] ISM frame
    synch_shell: np.ndarray
    ic_shell: np.ndarray
    e_tot: np.ndarray           # merged grid [n_tot]
    tot_shell: np.ndarray       # [n_tot, n_shells]
    tot: np.ndarray             # [n_tot]
    # synchrotron self-Compton (None unless calculate-ssc): computed
    # off each zone's own synchrotron photon field — the cooling loop
    # the reference scoped but never finished (synch_emission.jl:78-105)
    ssc_grid: np.ndarray = None     # [n_ic, nb] ISM frame
    ssc_shell: np.ndarray = None    # [n_ic, n_shells]

    def synch_photon_rate(self) -> np.ndarray:
        """Per-zone synchrotron photon production rate d2N/(dE dt)
        [photons / (erg s)] — the quantity the reference stashes in
        its SSC scratch file (synch_emission.jl:78-105) for future
        synchrotron-self-Compton cooling.  Computed from the stored
        dP/d(lnE) grid by dividing twice by photon energy."""
        return self.synch_grid / self.e_synch[:, None] ** 2


def doppler_shift_to_ism(grid: np.ndarray, e_gamma: np.ndarray,
                         beta_ef: np.ndarray, gamma_ef: np.ndarray
                         ) -> np.ndarray:
    """Shift per-zone plasma-frame spectra into the ISM frame
    (get_summed_emission.jl:91-200): isotropic emission split over
    N_COS_BINS angular slices, each Doppler-shifted by
    E' = E * gamma * sqrt((1 - b c_l)(1 - b c_{l+1})) (the minus sign
    because cos = -1 points at the observer), re-binned on the same log
    grid, with gamma^3 for beaming + time dilation.
    """
    n_g, nb = grid.shape
    log_e = np.log(e_gamma)
    dlog = log_e[1] - log_e[0]
    cosb = np.linspace(-1.0, 1.0, N_COS_BINS + 1)
    dimless = np.sqrt((1.0 - np.outer(beta_ef, cosb[:-1]))
                      * (1.0 - np.outer(beta_ef, cosb[1:])))  # [nb, nc]
    out = np.zeros_like(grid)
    frac = 1.0 / N_COS_BINS
    counts = grid / e_gamma[:, None]     # photon flux per lnE ~ counts
    for i in range(nb):
        if counts[:, i].max() <= 1e-90:
            continue
        g = gamma_ef[i]
        shift = np.log(g * dimless[i])             # [nc]
        # target bin for each (photon bin, angle)
        # +1e-9 guards the exact-on-edge case (shift = 0 must map a bin
        # onto itself)
        idx = np.floor((log_e[:, None] + shift[None, :] - log_e[0])
                       / dlog + 1.0e-9).astype(int)
        np.clip(idx, 0, n_g - 1, out=idx)
        e_new = e_gamma[:, None] * g * dimless[i][None, :]
        contrib = counts[:, i][:, None] * frac * g**3 * e_new
        np.add.at(out[:, i], idx.ravel(), contrib.ravel())
    return out


def sum_shells(grid: np.ndarray, n_shell_endpoints: np.ndarray
               ) -> np.ndarray:
    """Sum per-zone spectra into emission shells
    (get_summed_emission.jl:789-806)."""
    n_shells = len(n_shell_endpoints) - 1
    out = np.zeros((grid.shape[0], n_shells))
    for k in range(n_shells):
        a, b = n_shell_endpoints[k], n_shell_endpoints[k + 1]
        out[:, k] = grid[:, a:b].sum(axis=1)
    return out


def merge_total(pion_shell, synch_shell, ic_shell) -> tuple[np.ndarray,
                                                            np.ndarray]:
    """Merge the three processes onto the master photon grid
    (get_summed_emission.jl:249-310)."""
    n_tot = _n_photon(EG_MIN_MEV, EG_MAX_MEV)
    e_tot = 10.0 ** (math.log10(EG_MIN_MEV * MEV_ERG)
                     + np.arange(n_tot) / BINS_PER_DEC_PHOTON)
    n_shells = pion_shell.shape[1]
    tot = np.zeros((n_tot, n_shells))

    def off(emin):
        return int(round(math.log10(emin / EG_MIN_MEV)
                         * BINS_PER_DEC_PHOTON))

    for arr, emin in ((pion_shell, EG_PION_MIN_MEV),
                      (synch_shell, EG_SYNCH_MIN_MEV),
                      (ic_shell, EG_IC_MIN_MEV)):
        o = off(emin)
        n = min(arr.shape[0], n_tot - o)
        tot[o:o + n] += np.where(arr[:n] > 1e-90, arr[:n], 0.0)
    return e_tot, tot


def photon_calcs(setup, prof, ion_finals, i_iter: int = 0
                 ) -> EmissionResult:
    """Full emission pass for one iteration (photon_calcs.jl:27-161)."""
    cfg, bins = setup.cfg, setup.bins
    nb = setup.nb
    dist_lum = cfg.jet_dist_mpc * (1.0 + setup.redshift) * MPC_CM
    if cfg.jet_dist_mpc <= 0:
        raise ValueError("photon production requires jet-distance > 0")

    n_pion = _n_photon(EG_PION_MIN_MEV, EG_MAX_MEV)
    n_synch = _n_photon(EG_SYNCH_MIN_MEV, EG_SYNCH_MAX_MEV)
    n_ic = _n_photon(EG_IC_MIN_MEV, EG_MAX_MEV)

    e_pion = 10.0 ** (math.log10(EG_PION_MIN_MEV * MEV_ERG)
                      + np.arange(n_pion) / BINS_PER_DEC_PHOTON)
    e_synch = photon_energy_grid(EG_SYNCH_MIN_MEV, n_synch,
                                 BINS_PER_DEC_PHOTON)
    alpha_ic = ic_photon_energy_grid(EG_IC_MIN_MEV, n_ic,
                                     BINS_PER_DEC_PHOTON)
    e_ic = alpha_ic * ME_C2

    pion_grid = np.full((n_pion, nb), 1e-99)
    synch_grid = np.full((n_synch, nb), 1e-99)
    ic_grid = np.full((n_ic, nb), 1e-99)
    ssc_grid = np.full((n_ic, nb), 1e-99) if cfg.do_ssc else None
    if cfg.do_ssc:
        from ...ops.reduce import shell_surface_areas
        surf = shell_surface_areas(setup.x_grid_cm, setup.i_shock,
                                   cfg.gamma0, cfg.jet_rad_pc,
                                   cfg.jet_sph_frac)
        dlne = math.log(10.0) / BINS_PER_DEC_PHOTON
        a1_synch = e_synch / ME_C2

    dp = np.diff(bins.mom_edges)
    p_edges = bins.mom_edges
    cos_bounds = bins.cos_bounds()
    flux_fac = 1.0 / (4.0 * math.pi * dist_lum**2)

    ends = setup.n_shell_endpoints
    zones = range(int(ends[0]), int(ends[-1]))
    aa_ion = [s.aa for s in cfg.species]
    n0_ion = [s.number_density for s in cfg.species]

    import os as _os
    use_device = _os.environ.get("MCS_EMISSION_DEVICE", "1") == "1"
    if use_device:
        # Device path (SURVEY §7 "vmapped spectral integral kernels"):
        # the (particle-bin x photon-bin) kernels are zone-independent
        # for pion and IC, so each process is one batched matmul over
        # all zones (models/emission/device.py); the NumPy loop below
        # is the oracle (tests/test_device_emission.py).
        from .device import (cone_cut_counts, doppler_shift_device,
                             ic_grid_device, pion_grid_device,
                             synch_grid_device)
        from .inverse_compton import cmb_photon_field
        from .pion import heavy_nuclei_scaling
        zs = slice(int(ends[0]), int(ends[-1]))
        nz = zs.stop - zs.start
        gb_loc = np.sqrt(np.maximum(prof.gamma_sf[zs] ** 2 - 1.0,
                                    1e-30))
        target_z = n0_ion[0] * cfg.gamma0 * cfg.beta0 / gb_loc
        for i_ion, fi in enumerate(ion_finals):
            s = cfg.species[i_ion]
            counts_z = ((fi.dndp_therm[:, zs, 1] + fi.dndp_cr[:, zs, 1])
                        * dp[:, None]).T              # [nz, n_p]
            if s.aa >= 1:
                scaling = heavy_nuclei_scaling(s.aa, aa_ion, n0_ion)
                emis = np.asarray(pion_grid_device(
                    counts_z, p_edges, e_pion, target_z, s.aa, s.mc,
                    scaling))
                pion_grid[:, zs] = (np.maximum(pion_grid[:, zs], 0.0)
                                    + emis * flux_fac)
            else:
                emis = np.asarray(synch_grid_device(
                    jnp_f64(counts_z), jnp_f64(prof.btot[zs]),
                    jnp_f64(p_edges), jnp_f64(e_synch)))
                synch_grid[:, zs] += emis * flux_fac
                if fi.d2n_ef is not None:
                    d2n_z = fi.d2n_ef[:, :, zs] * dp[:, None, None]
                    ne_z = cone_cut_counts(d2n_z, cos_bounds,
                                           cfg.jet_sph_frac)
                    a1, n_ph = cmb_photon_field(setup.redshift)
                    ic_grid[:, zs] += np.asarray(ic_grid_device(
                        jnp_f64(ne_z), jnp_f64(p_edges),
                        jnp_f64(alpha_ic),
                        (jnp_f64(a1), jnp_f64(n_ph)), s.mc,
                        cfg.jet_sph_frac, dist_lum))
                    if cfg.do_ssc:
                        # SSC seeds differ per zone: keep the oracle
                        # per-zone kernel for this optional pass
                        for k, n in enumerate(range(zs.start, zs.stop)):
                            if emis[:, k].max() <= 1e-90:
                                continue
                            d2n_counts = fi.d2n_ef[:, :, n] * dp[:, None]
                            if d2n_counts.max() <= 1e-90:
                                continue
                            n_ph_z = (np.maximum(emis[:, k], 0.0)
                                      / e_synch * dlne
                                      / (surf[n] * C_CGS))
                            ssc_grid[:, n] += ic_emission(
                                d2n_counts, p_edges, cos_bounds,
                                alpha_ic, setup.redshift,
                                cfg.jet_sph_frac, dist_lum, s.mc,
                                seed=(a1_synch, n_ph_z))
        pion_ism = np.asarray(doppler_shift_device(
            jnp_f64(pion_grid), jnp_f64(e_pion),
            jnp_f64(prof.beta_ef), jnp_f64(prof.gamma_ef)))
        synch_ism = np.asarray(doppler_shift_device(
            jnp_f64(synch_grid), jnp_f64(e_synch),
            jnp_f64(prof.beta_ef), jnp_f64(prof.gamma_ef)))
        pion_shell = sum_shells(pion_ism, ends)
        synch_shell = sum_shells(synch_ism, ends)
        ic_shell = sum_shells(ic_grid, ends)
        ssc_shell = None
        if cfg.do_ssc:
            ssc_shell = sum_shells(ssc_grid, ends)
            ic_shell = ic_shell + np.maximum(ssc_shell, 0.0)
        e_tot, tot_shell = merge_total(pion_shell, synch_shell,
                                       ic_shell)
        return EmissionResult(
            e_pion=e_pion, e_synch=e_synch, e_ic=e_ic,
            pion_grid=pion_grid, synch_grid=synch_grid,
            ic_grid=ic_grid, pion_shell=pion_shell,
            synch_shell=synch_shell, ic_shell=ic_shell, e_tot=e_tot,
            tot_shell=tot_shell, tot=tot_shell.sum(axis=1),
            ssc_grid=ssc_grid, ssc_shell=ssc_shell)

    for i_ion, fi in enumerate(ion_finals):
        s = cfg.species[i_ion]
        for n in zones:
            counts = (fi.dndp_therm[:, n, 1] + fi.dndp_cr[:, n, 1]) * dp
            if s.aa >= 1:
                if counts.max() <= 1e-90:
                    continue
                gb_loc = math.sqrt(max(prof.gamma_sf[n] ** 2 - 1.0,
                                       1e-30))
                target = (n0_ion[0] * cfg.gamma0 * cfg.beta0 / gb_loc)
                emis = pion_emission(counts, p_edges, e_pion, target,
                                     s.aa, s.mc, aa_ion, n0_ion)
                pion_grid[:, n] = np.maximum(
                    pion_grid[:, n], 0.0) + emis * flux_fac
            else:
                emis = None
                if counts.max() > 1e-90:
                    emis = synch_emission(counts, p_edges, prof.btot[n],
                                          e_synch)
                    synch_grid[:, n] += emis * flux_fac
                if fi.d2n_ef is not None:
                    d2n_counts = fi.d2n_ef[:, :, n] * dp[:, None]
                    if d2n_counts.max() > 1e-90:
                        ic_grid[:, n] += ic_emission(
                            d2n_counts, p_edges, cos_bounds, alpha_ic,
                            setup.redshift, cfg.jet_sph_frac, dist_lum,
                            s.mc)
                        if cfg.do_ssc and emis is not None:
                            # seed field: the zone's own synchrotron
                            # photons.  Production rate per bin
                            # emis/E * dlnE [photons/s per shock-face
                            # area], escape time dx/c over volume
                            # surf*dx -> density / (surf * c)
                            n_ph = (np.maximum(emis, 0.0) / e_synch
                                    * dlne / (surf[n] * C_CGS))
                            ssc_grid[:, n] += ic_emission(
                                d2n_counts, p_edges, cos_bounds,
                                alpha_ic, setup.redshift,
                                cfg.jet_sph_frac, dist_lum, s.mc,
                                seed=(a1_synch, n_ph))

    # plasma -> ISM Doppler shift for pion + synchrotron
    pion_ism = doppler_shift_to_ism(pion_grid, e_pion, prof.beta_ef,
                                    prof.gamma_ef)
    synch_ism = doppler_shift_to_ism(synch_grid, e_synch, prof.beta_ef,
                                     prof.gamma_ef)

    pion_shell = sum_shells(pion_ism, ends)
    synch_shell = sum_shells(synch_ism, ends)
    ic_shell = sum_shells(ic_grid, ends)
    ssc_shell = None
    if cfg.do_ssc:
        ssc_shell = sum_shells(ssc_grid, ends)
        # SSC shares the IC outgoing grid; fold it into the IC channel
        # of the master merge
        ic_shell = ic_shell + np.maximum(ssc_shell, 0.0)
    e_tot, tot_shell = merge_total(pion_shell, synch_shell, ic_shell)

    return EmissionResult(
        e_pion=e_pion, e_synch=e_synch, e_ic=e_ic,
        pion_grid=pion_grid, synch_grid=synch_grid, ic_grid=ic_grid,
        pion_shell=pion_shell, synch_shell=synch_shell,
        ic_shell=ic_shell, e_tot=e_tot, tot_shell=tot_shell,
        tot=tot_shell.sum(axis=1),
        ssc_grid=ssc_grid, ssc_shell=ssc_shell)
