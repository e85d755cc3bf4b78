"""Relativistic smoothing against recorded gamma0=5 tallies.

tests/data/smooth_gamma5/ holds the exact solver inputs (pxx_flux,
energy_flux, Gamma_grid, PSD pressures, profile) captured via
MCS_SMOOTH_DUMP from the 4x-statistics gamma0=5 --dsa science run
whose iterations 4-5 tripped the round-7
degenerate-solve guard and froze the profile.

Root cause (round 5): the far-downstream flux tallies are structurally
starved — the PRP culls all but the highest-energy particles well
before the last grid zones (pxx_flux/F_px falls to ~4e-3 at x=+10rg) —
so those zones solve to u ~ u0, and smooth_profile_inplace's monotone
sweep (y[i-1] = max(y[i-1], y[i]), smoothers.jl:585-589) propagated
that garbage UPSTREAM, flattening the whole profile (span -> 0).
The fix pins x >= 0 to u2 BEFORE the sweep (the reference applies the
same constraint after rescaling, smoothers.jl:441-443); these tests
pin the fixed behavior on the real failing inputs.
"""

import glob
import os

import numpy as np
import pytest

from montecarloscattering_jl_tpu.models import smoothing as sm
from montecarloscattering_jl_tpu.utils.constants import MP_CGS

DATA = os.path.join(os.path.dirname(__file__), "data", "smooth_gamma5")


def _solve(d):
    n0 = float(d["rho0"]) / MP_CGS
    ptot = d["p_psd_par"] + d["p_psd_perp"]
    return sm.new_velocity_profile(
        True, n0, float(d["u0"]), float(d["beta0"]),
        float(d["gamma0"]), float(d["u2"]), d["pxx_flux"],
        d["energy_flux"], float(d["q_esc_px_avg"]),
        float(d["q_esc_en_avg"]), d["x_grid_rg"], d["ux_sk"],
        d["gamma_sf"], d["gamma_grid"], d["btot"], d["theta"],
        float(d["omega"]), ptot, float(d["f_px_up"]),
        float(d["f_en_up"]), float(d["smooth_mom_energy_fac"]))


class TestGamma5RecordedIterations:
    @pytest.mark.parametrize("path", sorted(
        glob.glob(os.path.join(DATA, "smooth_inputs_iter*.npz"))))
    def test_every_recorded_iteration_solves(self, path):
        """No recorded iteration — including the two that froze the
        round-7 run — may trip the degenerate guard, and each must
        produce a physical precursor: monotone into the shock,
        boundary conditions (u0 upstream, u2 downstream) honored."""
        d = np.load(path)
        ux = _solve(d)
        assert ux is not None, f"{path}: degenerate solve"
        u0, u2 = float(d["u0"]), float(d["u2"])
        x = d["x_grid_rg"]
        nb = len(x)
        # downstream pinned to u2 exactly
        dw = (x >= 0.0) & (np.arange(nb) >= 1) & (np.arange(nb) <= nb - 2)
        np.testing.assert_allclose(ux[dw], u2, rtol=1e-12)
        # far upstream at u0
        assert abs(ux[1] - u0) < 1e-3 * u0
        # precursor monotone non-increasing toward the shock
        up = np.where((x < 0.0) & (np.abs(x) < 1e29))[0]
        pre = ux[up]
        assert (np.diff(pre) <= 1e-9 * u0).all()
        # a real precursor dip: the zone just upstream of the shock
        # is decelerated, but never below u2
        assert u2 <= pre[-1] < 0.9 * u0

    def test_starved_iteration_relaxes_not_deepens(self):
        """The starved-tally iterations (3-4) must yield a SHALLOWER
        precursor than the well-fed iteration 2 — the tallies say the
        CR pressure is not there, so the profile must relax toward
        the step function, not evaporate the shock."""
        d2 = np.load(os.path.join(DATA, "smooth_inputs_iter02.npz"))
        d3 = np.load(os.path.join(DATA, "smooth_inputs_iter03.npz"))
        u2_, u3_ = _solve(d2), _solve(d3)
        x = d2["x_grid_rg"]
        # the last 3 zones before the subshock carry the bulk of the
        # deceleration; mid-precursor differences are noise-level
        i_pre = np.where((x < 0.0) & (np.abs(x) < 1e29))[0][-3:]
        assert (u3_[i_pre] >= u2_[i_pre] - 1e-6 * float(d2["u0"])).all()
