"""Structure-of-arrays particle state and tally pytrees.

The reference tracks twelve per-particle properties through its helix
loop (main_loops.jl:207-226); here they are [B]-shaped arrays advanced
in lock-step by the masked transport kernel (ops/step.py).  Tallies
replace the reference's mutable shared arrays + "omp critical" sections
(all_flux.jl:154,241) with difference-array accumulators: a particle
crossing the boundary range [lo, hi] adds +v at lo and -v at hi+1, and
a single prefix sum at segment end recovers the per-boundary totals.
This makes every step O(1) scatters per lane regardless of how many
zones were hopped (the "crossed-range histogramming trick" of
SURVEY.md section 7).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Position/PRP/time dtype.  float64 by contract (the grid spans 14
# decades with 1e30 sentinels; x += dx accumulates ~1e4 fine steps);
# this knob exists to measure the cost of f64 positions and for
# short-grid runs that tolerate f32.
X_DTYPE = (jnp.float32 if os.environ.get("MCS_X_DTYPE", "f64") == "f32"
           else jnp.float64)

# status codes
ACTIVE = 0
SAVED = 1      # hit the pcut splitting momentum (particle_loop.jl:360-380)
FINISHED = 2   # left the system; `reason` holds i_reason 1..4

# reason codes (particle_finish.jl:80-105)
R_DOWNSTREAM = 1
R_UPSTREAM_PMAX = 2
R_AGE = 3
R_RADIATED = 4


class ParticleState(NamedTuple):
    """Per-lane particle state ([B] arrays)."""

    weight: jnp.ndarray      # fraction of far-upstream density
    pb: jnp.ndarray          # plasma-frame p parallel to B [g cm/s]
    pperp: jnp.ndarray       # plasma-frame p perpendicular to B
    phi: jnp.ndarray         # gyro phase [rad]
    x: jnp.ndarray           # position [cm], float64
    igrid: jnp.ndarray       # current boundary index, int32
    ux_prev: jnp.ndarray     # zone flow speed seen last step [cm/s]
    downstream: jnp.ndarray  # has been downstream (bool)
    inj: jnp.ndarray         # has returned upstream after being downstream
    xn_per: jnp.ndarray      # steps per gyroperiod
    prp_x: jnp.ndarray       # probability-of-return plane [cm], float64
    acctime: jnp.ndarray     # acceleration time [s], float64
    tcut: jnp.ndarray        # next tcut slot, int32
    status: jnp.ndarray      # ACTIVE / SAVED / FINISHED, int32
    reason: jnp.ndarray      # i_reason when FINISHED, int32
    retro: jnp.ndarray       # in retro-time replay mode (bool)
    just_returned: jnp.ndarray  # returned from retro last step (bool)
    key: jnp.ndarray         # per-lane PRNG key (jax typed key array)
    nsteps: jnp.ndarray      # per-lane helix step count, int32
    t_step: jnp.ndarray      # last movement time step [s] (for losses
    #                          and acctime, particle_loop.jl:141,400)

    @property
    def ptot(self) -> jnp.ndarray:
        """Total plasma-frame momentum; hypot avoids the cancellation
        the reference guards in perpendicular_momentum
        (particle_loop.jl:639-650)."""
        return jnp.hypot(self.pb, self.pperp)

    @property
    def active(self) -> jnp.ndarray:
        return self.status == ACTIVE


class Tallies(NamedTuple):
    """Per-segment accumulators.

    *_diff arrays are difference-form over the boundary axis (length
    nb + 1); `finalize_tallies` prefix-sums them.  Tallies are packed
    so one flush updates them all:
      * flux_diff [4, nb+1]: (pxx, pxz, energy, n_crossings) — all four
        share crossing indices and accumulate via ONE one-hot range
        contraction per flush.
      * psd_diff [(n_mom+1)*2*(n_theta+1), nb+1]: the CR and thermal
        histograms share one flat cell axis ordered (ip, kind, jt)
        with kind 0 = injected (CR), 1 = thermal (lanes are exclusively
        one or the other), so one scatter pair updates both.
    """

    flux_diff: jnp.ndarray      # [4, nb+1] float64
    psd_diff: jnp.ndarray       # [(n_mom+1)*2*(n_theta+1), nb+1]
    pool_diff: jnp.ndarray      # [nb+1] donated ion energy [erg]
    # chunked tally record buffer: per-step crossing records
    # accumulate here with ONE dynamic write per step and flush once
    # per `chunk` steps (ops/step._flush_records), so the scatters run
    # once per chunk instead of once per step.  Rows: 4 flux
    # channels, psd weight, then lo/hi/psd-base indices stored exactly
    # as floats (all < 2^24).
    rec: jnp.ndarray            # [chunk, 8, B]
    step_phase: jnp.ndarray     # scalar int32 step counter
    px_esc_up: jnp.ndarray      # scalar: escaping momentum flux at FEB
    en_esc_up: jnp.ndarray      # scalar: escaping energy flux at FEB
    sum_p_dw: jnp.ndarray       # scalar: downstream-escape pressure sum
    sum_ke_dw: jnp.ndarray      # scalar: downstream-escape KE density sum
    spectra_sf: jnp.ndarray     # x_spec detector spectra [n_mom+1, nx]
    spectra_pf: jnp.ndarray
    weight_coupled: jnp.ndarray     # [n_tcut_slots]
    spectra_coupled: jnp.ndarray    # [n_mom+1, n_tcut_slots]


def make_tallies(nb: int, n_mom: int, n_theta: int, n_xspec: int,
                 n_tcut_slots: int, psd_dtype=jnp.float32,
                 batch: int = 1, chunk: int = 1,
                 p_dtype=jnp.float64) -> Tallies:
    f64 = jnp.float64
    z = jnp.zeros
    return Tallies(
        flux_diff=z((4, nb + 1), f64),
        psd_diff=z(((n_mom + 1) * 2 * (n_theta + 1), nb + 1), psd_dtype),
        pool_diff=z(nb + 1, f64),
        rec=z((chunk, 8, batch), p_dtype),
        step_phase=jnp.zeros((), jnp.int32),
        px_esc_up=jnp.zeros((), f64), en_esc_up=jnp.zeros((), f64),
        sum_p_dw=jnp.zeros((), f64), sum_ke_dw=jnp.zeros((), f64),
        spectra_sf=z((n_mom + 1, max(n_xspec, 1)), f64),
        spectra_pf=z((n_mom + 1, max(n_xspec, 1)), f64),
        weight_coupled=z(max(n_tcut_slots, 1), f64),
        spectra_coupled=z((n_mom + 1, max(n_tcut_slots, 1)), f64),
    )


class FinalTallies(NamedTuple):
    """Prefix-summed (per-boundary) tallies."""

    pxx_flux: jnp.ndarray     # [nb]
    pxz_flux: jnp.ndarray
    energy_flux: jnp.ndarray
    num_crossings: jnp.ndarray
    psd: jnp.ndarray          # [n_mom+1, n_theta+1, nb]
    therm_psd: jnp.ndarray
    px_esc_up: jnp.ndarray
    en_esc_up: jnp.ndarray
    sum_p_dw: jnp.ndarray
    sum_ke_dw: jnp.ndarray
    spectra_sf: jnp.ndarray
    spectra_pf: jnp.ndarray
    weight_coupled: jnp.ndarray
    spectra_coupled: jnp.ndarray
    energy_pool: jnp.ndarray


def finalize_tallies(t: Tallies) -> FinalTallies:
    """Prefix-sum the difference-form accumulators into per-boundary
    totals (the deferred equivalent of F_stream!'s per-boundary loop,
    all_flux.jl:219-257)."""
    flux = jnp.cumsum(t.flux_diff, axis=-1)[:, :-1]
    # un-flatten the (ip, kind, jt) cell axis; every dim is recoverable
    # from sibling tally shapes, so the signature stays dimension-free
    nmp1 = t.spectra_sf.shape[0]
    ntp1 = t.psd_diff.shape[0] // (2 * nmp1)
    psd4 = t.psd_diff.reshape(nmp1, 2, ntp1, -1).transpose(1, 0, 2, 3)
    psd = jnp.cumsum(psd4, axis=-1)[..., :-1]
    return FinalTallies(
        pxx_flux=flux[0],
        pxz_flux=flux[1],
        energy_flux=flux[2],
        num_crossings=flux[3],
        psd=psd[0],
        therm_psd=psd[1],
        px_esc_up=t.px_esc_up, en_esc_up=t.en_esc_up,
        sum_p_dw=t.sum_p_dw, sum_ke_dw=t.sum_ke_dw,
        spectra_sf=t.spectra_sf, spectra_pf=t.spectra_pf,
        weight_coupled=t.weight_coupled,
        spectra_coupled=t.spectra_coupled,
        energy_pool=jnp.cumsum(t.pool_diff)[:-1],
    )


def init_state(weight, ptot_pf, pb_pf, x_cm, igrid, ux_of_igrid,
               xn_per_fine: float, prp_x0, seg_key,
               phi=None, downstream=None, inj=None, acctime=None,
               tcut=None, xn_per=None,
               p_dtype=jnp.float64) -> ParticleState:
    """Build a [B] state from an injected (or split) population.

    Mirrors assign_particle_properties_to_population!
    (ion_init.jl:29-53): fresh particles start not-downstream,
    not-injected, with the fine time step, PRP at the grid end, and a
    random phase.  Lanes may be padding (weight 0): they start FINISHED.
    """
    b = len(weight)
    weight = jnp.asarray(weight, p_dtype)
    ptot = jnp.asarray(ptot_pf, p_dtype)
    pb = jnp.asarray(pb_pf, p_dtype)
    pperp = jnp.sqrt(jnp.maximum(ptot**2 - pb**2, 0.0))

    lane_keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        seg_key, jnp.arange(b, dtype=jnp.uint32))
    if phi is None:
        phi = (2.0 * jnp.pi *
               jax.vmap(lambda k: jax.random.uniform(k))(
                   jax.vmap(jax.random.fold_in,
                            in_axes=(0, None))(lane_keys, jnp.uint32(0))))
    pad = weight <= 0.0
    return ParticleState(
        weight=weight, pb=pb, pperp=pperp,
        phi=jnp.asarray(phi, p_dtype),
        x=jnp.asarray(x_cm, X_DTYPE),
        igrid=jnp.asarray(igrid, jnp.int32),
        ux_prev=jnp.asarray(ux_of_igrid, p_dtype),
        downstream=(jnp.zeros(b, bool) if downstream is None
                    else jnp.asarray(downstream, bool)),
        inj=jnp.zeros(b, bool) if inj is None else jnp.asarray(inj, bool),
        xn_per=(jnp.full(b, xn_per_fine, p_dtype) if xn_per is None
                else jnp.asarray(xn_per, p_dtype)),
        prp_x=jnp.asarray(prp_x0, X_DTYPE) * jnp.ones(b, X_DTYPE),
        acctime=(jnp.zeros(b, X_DTYPE) if acctime is None
                 else jnp.asarray(acctime, X_DTYPE)),
        tcut=(jnp.zeros(b, jnp.int32) if tcut is None
              else jnp.asarray(tcut, jnp.int32)),
        status=jnp.where(pad, FINISHED, ACTIVE).astype(jnp.int32),
        reason=jnp.zeros(b, jnp.int32),
        retro=jnp.zeros(b, bool),
        just_returned=jnp.zeros(b, bool),
        key=lane_keys,
        nsteps=jnp.zeros(b, jnp.int32),
        t_step=jnp.zeros(b, p_dtype),
    )


def pad_population(arrays: dict, b_target: int) -> dict:
    """Pad host-side population arrays to a fixed batch size with
    zero-weight lanes (static shapes for XLA)."""
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        n = len(v)
        if n > b_target:
            raise ValueError(f"population {n} exceeds batch {b_target}")
        pad = b_target - n
        out[k] = np.concatenate([v, np.zeros(pad, v.dtype)])
    return out
