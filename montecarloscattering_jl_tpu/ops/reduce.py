"""Reduction layer: PSD -> spectra, zone populations, pressures.

Array re-design of the reference's reduction stack:
  * transform_psd_corners + identify_corners + get_transform_dN
    (transformers.jl:29-312,634-682; identify_corners.jl:30-245)
    become one dense rebinning: each PSD cell's four transformed
    corners are sorted, giving (p_lo, p_peak, p_hi) for the scalene
    triangular weight distribution (i_approx = 2, the reference's
    production choice, particle_counter.jl:72), and the per-bin
    fractions come from the analytic triangle CDF evaluated at all
    target bin edges at once — no per-cell control flow.
  * get_dNdp_cr (particle_counter.jl:29-306): dN/dp per zone in shock /
    plasma / ISM frames.
  * thermal crossings: the reference keeps a crossing list + scratch
    file and histograms it later (all_flux.jl:238-256,
    thermo_calcs.jl:84-163); the transport kernel already histogrammed
    them into `therm_psd` with the same (p, theta, zone) bins, so the
    thermal reductions reuse the CR machinery.  This also makes
    get_dNdp_therm real instead of the reference's debugging stub
    (particle_counter.jl:991-992).
  * get_normalized_dNdp (particle_counter.jl:674-934): zone populations
    from flux x area x dwell time, then dN/dp normalization.
  * thermo_calcs (thermo_calcs.jl:29-352): anisotropic pressure and
    kinetic-energy density from center-point rebinned d2N.
  * get_dNdp_2D (particle_counter.jl:343-613): ISM-frame d2N/(dp dcos)
    for electron inverse-Compton.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.psd_bins import PsdBins, psd_bin_angle, psd_bin_momentum
from ..utils.constants import C_CGS, KB_CGS, PC_CM
from .transforms import boost_x

# f32 products at full f32 precision (no TF32 operand rounding)
_HIGHEST = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# corner-transform rebinning (CR dN/dp)
# ---------------------------------------------------------------------------

def corner_logp(gamma, e0: float, mom_edges: np.ndarray,
                cos_bounds: np.ndarray):
    """Transformed corner log10-momenta [n_mom+2, n_theta+2]
    (transform_psd_corners, transformers.jl:634-682).

    `mom_edges` are linear momenta (10**bounds); `cos_bounds` the true
    pitch-cosine bounds from PsdBins.cos_bounds().
    """
    beta = jnp.where(gamma >= 1.000001,
                     jnp.sqrt(jnp.maximum(1.0 - 1.0 / gamma**2, 0.0)), 0.0)
    pt = mom_edges[:, None]
    ct = cos_bounds[None, :]
    px = pt * ct
    etot = jnp.hypot(pt * C_CGS, e0)
    px_t = gamma * (px - beta * etot / C_CGS)
    pt_t = jnp.sqrt(jnp.maximum(pt**2 + px_t**2 - px**2, 1.0e-300))
    return jnp.log10(pt_t)


def _triangle_cdf(x, lo, peak, hi):
    """CDF of the triangular distribution on [lo, hi] peaked at `peak`,
    robust to degenerate (point-like) cells."""
    width = hi - lo
    tinyw = width <= 1.0e-12
    d1 = jnp.maximum((peak - lo) * width, 1.0e-30)
    d2 = jnp.maximum((hi - peak) * width, 1.0e-30)
    up = (x - lo) ** 2 / d1
    down = 1.0 - (hi - x) ** 2 / d2
    cdf = jnp.where(x <= peak, up, down)
    cdf = jnp.where(x <= lo, 0.0, jnp.where(x >= hi, 1.0, cdf))
    return jnp.where(tinyw, (x >= lo).astype(x.dtype), cdf)


def _uniform_cdf(x, lo, hi):
    """CDF of a uniform distribution on [lo, hi] (i_approx = 0,
    uniform_cell_distribution!, transformers.jl:177-202)."""
    width = hi - lo
    tinyw = width <= 1.0e-12
    cdf = jnp.clip((x - lo) / jnp.maximum(width, 1.0e-30), 0.0, 1.0)
    return jnp.where(tinyw, (x >= lo).astype(x.dtype), cdf)


def _trapezoid_cdf(x, lo, b1, b2):
    """CDF of alpha + beta*u + gamma*v for (u, v) uniform on the unit
    square — the sum of two independent uniforms, i.e. a trapezoidal
    distribution on [lo, lo+b1+b2] with plateau [lo+m, lo+M],
    m = min(b1, b2), M = max(b1, b2).  Robust to degenerate spans."""
    m = jnp.minimum(b1, b2)
    big = jnp.maximum(b1, b2)
    tot = m + big
    tiny = tot <= 1.0e-12
    s = x - lo
    m_s = jnp.maximum(m, 1.0e-30)
    big_s = jnp.maximum(big, 1.0e-30)
    ramp_up = s * s / (2.0 * m_s * big_s)
    plateau = (2.0 * s - m) / (2.0 * big_s)
    ramp_dn = 1.0 - (tot - s) ** 2 / (2.0 * m_s * big_s)
    cdf = jnp.where(s <= m, ramp_up, jnp.where(s <= big, plateau, ramp_dn))
    cdf = jnp.where(s <= 0.0, 0.0, jnp.where(s >= tot, 1.0, cdf))
    return jnp.where(tiny, (s >= 0.0).astype(x.dtype), cdf)


_EXACT_SUBDIV = 4   # i_approx = 3 bilinear subdivision per cell axis


def _exact_cdf(c00, c10, c01, c11, e):
    """i_approx = 3: EXACT-overlap CDF of the transformed cell.

    The reference reserves i_approx = 3 for exact rebinning but errors
    on it (transformers.jl:132-134); this implements the intent.  The
    cell's log-p surface is the bilinear interpolation of its four
    transformed corners over the (u, v) unit square; the cell is
    subdivided _EXACT_SUBDIV^2-fold and each subcell's restriction —
    linear up to the residual cross term delta*du^2*uv,
    delta = c00-c10-c01+c11, negligible for the near-planar cells the
    corner transform produces — gets the exact trapezoidal CDF of a
    linear function over a square.  Exact in the subdivision limit;
    with k = 4 the residual is |delta|/16 in log10-p.

    c** are [n_cells] corner log-p columns; `e` is [1, n_edges].
    Returns the weight-fraction CDF [n_cells, n_edges].
    """
    k = _EXACT_SUBDIV
    beta_full = c10 - c00
    gamma_full = c01 - c00
    delta = c11 - c10 - c01 + c00
    cdf = 0.0
    for r in range(k):
        for s in range(k):
            u0 = r / k
            v0 = s / k
            # corner value + edge slopes of the bilinear restricted to
            # the subcell, then linearized (cross term dropped)
            alpha = (c00 + beta_full * u0 + gamma_full * v0
                     + delta * u0 * v0)
            beta = (beta_full + delta * v0) / k
            gamma = (gamma_full + delta * u0) / k
            lo = alpha + jnp.minimum(beta, 0.0) + jnp.minimum(gamma, 0.0)
            cdf = cdf + _trapezoid_cdf(e, lo, jnp.abs(beta),
                                       jnp.abs(gamma))
    return cdf / (k * k)


def _rebin_matrix(corner_lp, edges_log, i_approx: int = 2):
    """[n_cells, n_bins] fraction matrix from the cell corner log-p grid.

    Cells (i, j) own corners {(i,j),(i+1,j),(i,j+1),(i+1,j+1)}; sorting
    them yields p_lo/p_hi, and cell weight is spread by i_approx
    (get_transform_dN, transformers.jl:106-148):
      0  uniform on [p_lo, p_hi]
      1  isosceles triangle peaked at the midpoint
      2  scalene triangle peaked at the mean of the two middle corners
         (the reference's production choice, particle_counter.jl:72)
      3  exact bilinear-cell overlap (the mode the reference reserves
         but errors on, transformers.jl:132-134; see _exact_cdf)
    """
    c00 = corner_lp[:-1, :-1]
    c10 = corner_lp[1:, :-1]
    c01 = corner_lp[:-1, 1:]
    c11 = corner_lp[1:, 1:]
    # extend the last bin to +inf so overflow lands there, matching the
    # reference's clamp-to-top-bin warnings (transformers.jl:68-92)
    e = jnp.concatenate([edges_log[:-1], jnp.asarray([1.0e9])])
    if i_approx == 3:
        cdf = _exact_cdf(c00.reshape(-1, 1), c10.reshape(-1, 1),
                         c01.reshape(-1, 1), c11.reshape(-1, 1),
                         e[None, :])
        return cdf[:, 1:] - cdf[:, :-1]
    stack = jnp.stack([c00, c10, c01, c11], axis=-1)
    lo = jnp.min(stack, axis=-1)
    hi = jnp.max(stack, axis=-1)
    if i_approx == 1:
        peak = (lo + hi) / 2.0
    else:
        peak = (jnp.sum(stack, axis=-1) - lo - hi) / 2.0
    lo = lo.reshape(-1, 1)
    hi = hi.reshape(-1, 1)
    peak = peak.reshape(-1, 1)
    if i_approx == 0:
        cdf = _uniform_cdf(e[None, :], lo, hi)
    else:
        cdf = _triangle_cdf(e[None, :], lo, peak, hi)
    return cdf[:, 1:] - cdf[:, :-1]


@partial(jax.jit, static_argnames=("n_mom", "n_theta", "i_approx"))
def _dn_transformed(psd_zone, gamma, e0, mom_edges, cos_bounds, edges_log,
                    n_mom: int, n_theta: int, i_approx: int = 2):
    """dN(p) of one zone's PSD slice in the frame reached by boosting
    with `gamma` (get_transform_dN, transformers.jl:29-170)."""
    clp = corner_logp(gamma, e0, mom_edges, cos_bounds)
    m = _rebin_matrix(clp, edges_log, i_approx)
    w = (psd_zone / gamma).reshape(-1)
    return jnp.matmul(w, m, precision=_HIGHEST)


def dndp_cr(psd, bins: PsdBins, e0: float, gamma_sf_grid, gamma0: float,
            i_approx: int = 2):
    """dN/dp [n_mom+1, nb, 3] in (shock, plasma, ISM) frames
    (get_dNdp_cr, particle_counter.jl:29-306).

    `psd` is [n_mom+1, n_theta+1, nb].
    """
    mom_edges = jnp.asarray(bins.mom_edges)
    cos_bounds = jnp.asarray(bins.cos_bounds())
    edges_log = jnp.asarray(bins.mom_bounds_log)
    nb = psd.shape[-1]

    dn_sf = psd.sum(axis=1)                       # [n_mom+1, nb]

    def per_zone(args):
        psd_z, g = args
        return _dn_transformed(psd_z, g, e0, mom_edges, cos_bounds,
                               edges_log, bins.n_mom, bins.n_theta,
                               i_approx)

    psd_t = jnp.moveaxis(psd, -1, 0)              # [nb, n_mom+1, n_theta+1]
    dn_pf = jax.lax.map(per_zone, (psd_t, jnp.asarray(gamma_sf_grid))).T
    dn_ef = jax.lax.map(
        per_zone, (psd_t, jnp.full(nb, gamma0))).T

    dn = jnp.stack([dn_sf, dn_pf, dn_ef], axis=-1)
    dp = jnp.diff(mom_edges)[:, None, None]
    return dn / dp


# ---------------------------------------------------------------------------
# fused per-ion device reduction (one program, one dispatch)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=(
    "psd_mom_min", "bins_per_dec_mom", "bins_per_dec_theta", "cos_fine",
    "dcos", "theta_min", "n_mom", "n_theta", "i_approx", "want_ef"))
def _ion_reduce_prog(psd, therm, gamma_sf, betas, e0, gamma0,
                     mom_edges, cos_bounds, edges_log, mom_centers,
                     cos_cents, psd_mom_min, bins_per_dec_mom,
                     bins_per_dec_theta, cos_fine, dcos, theta_min,
                     n_mom, n_theta, i_approx, want_ef):
    """All of ion_finalize's device work as ONE XLA program.

    Every host<->device fetch synchronizes the stream, so the program
    replaces the split dndp_cr / dndp_cr(therm) / d2n_boosted /
    d2n_boosted(ISM) calls (4 programs, 4 fetches) with one dispatch
    and one fetch.  It also shares the per-zone rebin matrix between
    the CR and thermal PSDs (it depends only on the zone boost) and
    uses a single matrix for the ISM frame (constant boost over zones).
    """
    nb = psd.shape[-1]
    dp = jnp.diff(mom_edges)[:, None]

    dn_sf_cr = psd.sum(axis=1)                       # [n_mom+1, nb]
    dn_sf_th = therm.sum(axis=1)
    psd_t = jnp.moveaxis(psd, -1, 0)                 # [nb, nm+1, nt+1]
    th_t = jnp.moveaxis(therm, -1, 0)

    def rebin_zone(args):
        psd_z, th_z, g = args
        clp = corner_logp(g, e0, mom_edges, cos_bounds)
        m = _rebin_matrix(clp, edges_log, i_approx)
        return (jnp.matmul((psd_z / g).reshape(-1), m, precision=_HIGHEST),
                jnp.matmul((th_z / g).reshape(-1), m, precision=_HIGHEST))

    dn_pf_cr, dn_pf_th = jax.lax.map(rebin_zone, (psd_t, th_t, gamma_sf))
    clp0 = corner_logp(gamma0, e0, mom_edges, cos_bounds)
    m0 = _rebin_matrix(clp0, edges_log, i_approx)
    dn_ef_cr = jnp.matmul(psd_t.reshape(nb, -1) / gamma0, m0,
                          precision=_HIGHEST)
    dn_ef_th = jnp.matmul(th_t.reshape(nb, -1) / gamma0, m0,
                          precision=_HIGHEST)

    dn_cr = jnp.stack([dn_sf_cr, dn_pf_cr.T, dn_ef_cr.T],
                      axis=-1) / dp[..., None]
    dn_th = jnp.stack([dn_sf_th, dn_pf_th.T, dn_ef_th.T],
                      axis=-1) / dp[..., None]

    # center-point boosted d2N (thermo_calcs.jl:179-208)
    pt = mom_centers[:, None] * jnp.ones_like(cos_cents)[None, :]
    px = mom_centers[:, None] * cos_cents[None, :]

    def boost_zone(args):
        w, g, b = args
        pt_t, px_t = boost_x(pt, px, g, b, e0, C_CGS)
        ip = psd_bin_momentum(pt_t, psd_mom_min, bins_per_dec_mom, n_mom)
        jt = psd_bin_angle(px_t, pt_t, cos_fine, dcos, theta_min,
                           bins_per_dec_theta, n_theta)
        return jnp.zeros_like(w).at[ip, jt].add(w)

    total_t = psd_t + th_t
    d2n_tot = jnp.moveaxis(
        jax.lax.map(boost_zone, (total_t, gamma_sf, betas)), 0, -1)

    d2n_ef = None
    if want_ef:
        # ISM-frame boost of the RAW (un-normalized) CR+thermal total:
        # the zone-population normalization (~1e50 in CGS — overflows
        # f32) is applied by the caller on the host; it commutes with
        # the boost because boost_zone maps each zone independently
        beta0 = jnp.sqrt(1.0 - 1.0 / gamma0**2)
        d2n_ef = jnp.moveaxis(
            jax.lax.map(boost_zone,
                        (total_t, jnp.full(nb, gamma0),
                         jnp.full(nb, beta0))), 0, -1)
        d2n_ef = d2n_ef / dp[..., None]
    return dn_cr, dn_th, d2n_tot, d2n_ef


def ion_reduce_device(psd, therm_psd, bins: PsdBins, e0: float,
                      gamma_sf_grid, ux_sk_grid, gamma0: float,
                      i_approx: int = 2, want_ef: bool = False,
                      fetch: bool = True):
    """One-dispatch fused reduction: (dn_cr, dn_th, d2n_tot, d2n_ef).

    dn_cr / dn_th are the UN-normalized dN/dp [n_mom+1, nb, 3]
    (shock, plasma, ISM frames; == dndp_cr applied to each input);
    d2n_tot is the plasma-frame center-point boosted CR+thermal d2N
    for thermo_calcs; d2n_ef (when want_ef) is the ISM-frame d2N/dp of
    the RAW CR+thermal total for the electron IC path — the caller
    multiplies by `ef_zone_norm` (zone populations are ~1e50 in CGS
    and would overflow the f32 device program).

    The program runs in f32 on the device: the inputs are MC tallies
    with percent-level statistical noise, and an f32 rebin can flip a
    corner between adjacent log-p bins only when it sits within ~1e-7
    relative of the edge.  Its matrix products are pinned to HIGHEST
    precision so the GPU does not round the f32 operands to TF32
    (10 mantissa bits, ~1e-3 relative — far above that edge budget).
    """
    f32 = jnp.float32
    betas = np.asarray(ux_sk_grid) / C_CGS
    out = _ion_reduce_prog(
        jnp.asarray(psd, f32), jnp.asarray(therm_psd, f32),
        jnp.asarray(gamma_sf_grid, f32),
        jnp.asarray(betas, f32), e0, gamma0,
        jnp.asarray(bins.mom_edges, f32),
        jnp.asarray(bins.cos_bounds(), f32),
        jnp.asarray(bins.mom_bounds_log, f32),
        jnp.asarray(bins.mom_centers, f32),
        jnp.asarray(bins.cos_centers(), f32), bins.psd_mom_min,
        bins.bins_per_dec_mom, bins.bins_per_dec_theta, bins.cos_fine,
        bins.dcos, bins.theta_min, bins.n_mom, bins.n_theta,
        i_approx, want_ef)
    if not fetch:
        # deferred-fetch mode (engine.driver's overlapped reductions):
        # the dispatch is async — the caller device_gets later, while
        # the next species' transport occupies the chip
        return out
    dn_cr, dn_th, d2n_tot, d2n_ef = jax.device_get(out)
    return (np.asarray(dn_cr), np.asarray(dn_th), np.asarray(d2n_tot),
            None if d2n_ef is None else np.asarray(d2n_ef))


# ---------------------------------------------------------------------------
# zone populations (set_grid_volumes!, particle_counter.jl:1466-1524)
# ---------------------------------------------------------------------------

def shell_surface_areas(x_grid_cm: np.ndarray, i_shock: int,
                        gamma0: float, jet_rad_pc: float,
                        jet_sph_frac: float) -> np.ndarray:
    """Spherical-cap shell surface area per zone [cm^2] from the jet
    geometry (set_grid_volumes!, particle_counter.jl:1476-1505); unit
    area when no jet radius is configured."""
    nb = len(x_grid_cm)
    dx = np.diff(x_grid_cm)
    surf = np.ones(nb)
    if jet_rad_pc > 0:
        jet_rad_cm = jet_rad_pc * PC_CM
        rad_min = jet_rad_cm - x_grid_cm[i_shock]
        for i in range(i_shock - 1, 0, -1):
            rad_max = rad_min + dx[i] / gamma0
            surf[i] = math.pi * (rad_max + rad_min) ** 2 * jet_sph_frac
            rad_min = rad_max
        rad_max = jet_rad_cm - x_grid_cm[i_shock]
        for i in range(i_shock, nb - 1):
            rad_min = rad_max - dx[i] / gamma0
            surf[i] = math.pi * (rad_max + rad_min) ** 2 * jet_sph_frac
            rad_max = rad_min
    return surf


def zone_populations(x_grid_cm: np.ndarray, i_shock: int, n0_ion: float,
                     beta0: float, gamma0: float, jet_rad_pc: float,
                     jet_sph_frac: float, ux_sk_grid: np.ndarray,
                     gamma_sf_grid: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(zone_pop, zone_vol) per boundary index (length nb).

    zone_pop = upstream particle flux x shell surface area x dwell
    time.  With no jet geometry configured (jet_rad = 0) the area
    factor degenerates to unit area, giving populations per cm^2 of
    shock face — the normalization cancels wherever zone_pop is used
    against tallies with the same convention.
    """
    nb = len(x_grid_cm)
    dx = np.diff(x_grid_cm)
    surf = shell_surface_areas(x_grid_cm, i_shock, gamma0, jet_rad_pc,
                               jet_sph_frac)

    zone_pop = np.zeros(nb)
    zone_vol = np.zeros(nb)
    f_up = gamma0 * n0_ion * beta0 * C_CGS
    for i in range(1, nb - 1):
        dwell = dx[i] / ux_sk_grid[i]
        zone_pop[i] = f_up * surf[i] * dwell
        density_pf = gamma0 * ux_sk_grid[1] / (gamma_sf_grid[i]
                                               * ux_sk_grid[i])
        zone_vol[i] = zone_pop[i] / max(density_pf, 1e-300)
    return zone_pop, zone_vol


def normalize_dndp(dndp_cr_arr, dndp_therm_arr, mom_edges, zone_pop,
                   n0_ion: float, gamma0: float, ux_sk_grid,
                   gamma_sf_grid):
    """Normalize thermal + CR dN/dp so each zone integrates to its
    population (get_normalized_dNdp, particle_counter.jl:730-778).

    Arrays are [n_mom+1, nb, 3]; returns the pair normalized in place
    (as new arrays).
    """
    dp = np.diff(np.asarray(mom_edges))[:, None, None]
    area_therm = (np.asarray(dndp_therm_arr) * dp).sum(axis=0)   # [nb, 3]
    area_cr = (np.asarray(dndp_cr_arr) * dp).sum(axis=0)
    # fast-push zones with no thermal crossings approximate the thermal
    # area by the compressed density / local speed
    # (particle_counter.jl:756-758)
    density_pf = (gamma0 * np.asarray(ux_sk_grid)[1]
                  / (np.asarray(gamma_sf_grid) * np.asarray(ux_sk_grid)))
    area_tot = np.where((area_therm == 0) & (area_cr > 0),
                        (n0_ion * density_pf[:, None]
                         / np.asarray(ux_sk_grid)[:, None]) + area_cr,
                        area_therm + area_cr)
    ok = area_tot > 0
    norm = np.zeros_like(area_tot)
    np.divide(np.broadcast_to(np.asarray(zone_pop)[:, None],
                              area_tot.shape),
              area_tot, out=norm, where=ok)
    return (np.asarray(dndp_therm_arr) * norm[None, :, :],
            np.asarray(dndp_cr_arr) * norm[None, :, :])


# ---------------------------------------------------------------------------
# center-point rebinned d2N + pressures (thermo_calcs.jl, get_dNdp_2D)
# ---------------------------------------------------------------------------

def d2n_boosted(psd_total, gammas, betas, e0, bins: PsdBins):
    """Boost the combined (CR + thermal) shock-frame d2N histogram into
    per-zone frames by center-point rebinning
    (thermo_calcs.jl:179-208, get_dNdp_2D's m=1 branch).

    psd_total: [n_mom+1, n_theta+1, nb]; gammas/betas: [nb].
    Returns d2N in the boosted frame, same shape.
    """
    p_cent = jnp.asarray(bins.mom_centers)          # [n_mom+1]
    cos_cent = jnp.asarray(bins.cos_centers())      # [n_theta+1]
    pt = p_cent[:, None] * jnp.ones_like(cos_cent)[None, :]
    px = p_cent[:, None] * cos_cent[None, :]

    def one_zone(args):
        w, g, b = args
        pt_t, px_t = boost_x(pt, px, g, b, e0, C_CGS)
        ip = psd_bin_momentum(pt_t, bins.psd_mom_min, bins.bins_per_dec_mom,
                              bins.n_mom)
        jt = psd_bin_angle(px_t, pt_t, bins.cos_fine, bins.dcos,
                           bins.theta_min, bins.bins_per_dec_theta,
                           bins.n_theta)
        out = jnp.zeros_like(w)
        return out.at[ip, jt].add(w)

    psd_t = jnp.moveaxis(psd_total, -1, 0)
    out = jax.lax.map(one_zone, (psd_t, jnp.asarray(gammas),
                                 jnp.asarray(betas)))
    return jnp.moveaxis(out, 0, -1)


def thermo_calcs(psd, therm_psd, bins: PsdBins, m_ion: float,
                 zone_pop, num_crossings, n0_ion: float, t0_ion: float,
                 zz_ion: float, beta0: float, gamma0: float,
                 ux_sk_grid, gamma_sf_grid, d2n=None):
    """Anisotropic pressure + kinetic-energy density per zone
    (thermo_calcs.jl:29-352).

    Returns (P_par, P_perp, energy_density) arrays of length nb.
    `d2n` may carry the precomputed plasma-frame center-point boosted
    CR+thermal histogram (ion_reduce_device's d2n_tot).
    """
    e0 = m_ion * C_CGS**2
    mc = m_ion * C_CGS
    nb = psd.shape[-1]
    gam = np.asarray(gamma_sf_grid)
    bet = np.asarray(ux_sk_grid) / C_CGS

    if d2n is None:
        d2n = np.asarray(d2n_boosted(jnp.asarray(psd + therm_psd),
                                     gam, bet, e0, bins))

    p_cent = bins.mom_centers
    cos_cent = bins.cos_centers()
    vel = p_cent * C_CGS / (mc * np.hypot(1.0, p_cent / mc))
    g_cent = np.hypot(1.0, p_cent / mc)

    p_par = np.zeros(nb)
    p_perp = np.zeros(nb)
    e_dens = np.zeros(nb)
    ncross = np.asarray(num_crossings)
    zpop = np.asarray(zone_pop)

    for i in range(1, nb - 1):
        density_loc = (gamma0 * beta0 * n0_ion
                       / max(math.sqrt(max(gam[i] ** 2 - 1.0, 1e-300)),
                             1e-300))
        has_parts = d2n[:, :, i].max() > 0
        if (not has_parts) and ncross[i] == 0:
            # case 1: untracked thermal plasma only — analytic adiabatic
            # pressure (thermo_calcs.jl:258-279)
            pres = density_loc ** (5.0 / 3.0) * KB_CGS * t0_ion
            p_par[i] = pres / 3.0
            p_perp[i] = 2.0 * pres / 3.0
            e_dens[i] = 1.5 * pres
            continue
        if ncross[i] == 0:
            # case 2: CRs only; thermal part analytic, scaled by the
            # untracked fraction (thermo_calcs.jl:281-306)
            pres = density_loc ** (5.0 / 3.0) * KB_CGS * t0_ion
            d2n_pop = d2n[:, :, i].sum()
            pres *= max(1.0 - d2n_pop / max(zpop[i], 1e-300), 0.0)
            p_par[i] = pres / 3.0
            p_perp[i] = 2.0 * pres / 3.0
            e_dens[i] = 1.5 * pres
        norm = density_loc / max(zpop[i], 1e-300)
        w = d2n[:, :, i] * norm
        pf = (p_cent * vel / 3.0)[:, None]
        mu2 = (cos_cent ** 2)[None, :]
        p_par[i] += float((w * pf * mu2).sum())
        p_perp[i] += float((w * pf * (1.0 - mu2)).sum())
        e_dens[i] += float((w * ((g_cent - 1.0) * e0)[:, None]).sum())

    return p_par, p_perp, e_dens


def pitch_histograms(psd, bins: PsdBins, decades_per_group: int = 1
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Normalized pitch-cosine distributions per momentum decade and
    zone — the working form of the reference's dormant
    track_pitch_angles (transformers.jl:319-401): the PSD already IS a
    (p, theta, zone) histogram, so the pitch distributions are a
    grouped sum over the momentum axis divided by the cosine bin
    widths.

    Returns (cos_centers [n_theta+1], hist [n_groups, n_theta+1, nb])
    with each nonempty (group, zone) column normalized to unit sum.
    """
    cos_b = bins.cos_bounds()
    dcos = np.abs(np.diff(cos_b))                    # [n_theta+1]
    n_per_group = bins.bins_per_dec_mom * decades_per_group
    n_groups = (psd.shape[0] + n_per_group - 1) // n_per_group
    nb = psd.shape[-1]
    out = np.zeros((n_groups, bins.n_theta + 1, nb))
    p = np.asarray(psd)
    for g in range(n_groups):
        sl = slice(g * n_per_group, (g + 1) * n_per_group)
        out[g] = p[sl].sum(axis=0) / dcos[:, None]
    tot = out.sum(axis=1, keepdims=True)
    out = np.divide(out, tot, out=np.zeros_like(out), where=tot > 0)
    return bins.cos_centers(), out


def dndp_2d_ef(psd, therm_psd, bins: PsdBins, m_ion: float, zone_pop,
               num_crossings, n0_ion: float, beta0: float, gamma0: float):
    """ISM-frame d2N/(dp dcos) for the electron IC calculation
    (get_dNdp_2D, particle_counter.jl:343-613).

    Combines CR + thermal shock-frame histograms, normalizes each zone
    to its population, boosts cell centers into the ISM frame, and
    returns d2N/dp (per-dp, split by angle bin) [n_mom+1, n_theta+1, nb].
    """
    e0 = m_ion * C_CGS**2
    nb = psd.shape[-1]
    total = normalized_total_ef(psd, therm_psd, zone_pop,
                                num_crossings, n0_ion)
    dp = np.diff(bins.mom_edges)

    out = np.asarray(d2n_boosted(
        jnp.asarray(total), np.full(nb, gamma0), np.full(nb, beta0),
        e0, bins))
    return out / dp[:, None, None]


def ef_zone_norm(psd, therm_psd, zone_pop, num_crossings,
                 n0_ion: float) -> np.ndarray:
    """Per-zone population normalization factor [nb] for the ISM-frame
    d2N (particle_counter.jl:480-518).  Kept in f64 on the host: zone
    populations are ~1e50 in CGS and overflow f32 (the explicit cast
    matters — the PSD inputs may be device-resident f32 arrays)."""
    total = np.asarray(psd + therm_psd, np.float64)
    density_tot = total.sum(axis=(0, 1))
    density_tot = np.where((np.asarray(num_crossings) == 0)
                           & (density_tot > 0),
                           density_tot + n0_ion, density_tot)
    norm = np.zeros_like(density_tot)
    np.divide(np.asarray(zone_pop), density_tot, out=norm,
              where=density_tot > 0)
    return norm


def normalized_total_ef(psd, therm_psd, zone_pop, num_crossings,
                        n0_ion: float) -> np.ndarray:
    """CR+thermal histogram normalized to zone populations
    (particle_counter.jl:480-518) — the input to the ISM-frame boost."""
    norm = ef_zone_norm(psd, therm_psd, zone_pop, num_crossings, n0_ion)
    return np.asarray(psd + therm_psd) * norm[None, None, :]
