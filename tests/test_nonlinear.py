"""Nonlinear loop + reductions + outputs tests (SURVEY.md section 7
stage 4)."""

import os

import numpy as np
import pytest

from montecarloscattering_jl_tpu.engine import run
from montecarloscattering_jl_tpu.models.smoothing import (
    set_gamma_adiab_grid, smooth_profile_inplace)
from montecarloscattering_jl_tpu.ops import reduce as red
from montecarloscattering_jl_tpu.utils import constants as K
from montecarloscattering_jl_tpu.utils import load_config


class TestReductions:
    def test_triangle_cdf_conserves_weight(self):
        import jax.numpy as jnp
        from montecarloscattering_jl_tpu.ops.reduce import _triangle_cdf
        lo, peak, hi = 1.0, 1.6, 2.4
        edges = jnp.linspace(0.0, 4.0, 80)
        cdf = _triangle_cdf(edges, lo, peak, hi)
        frac = np.diff(np.asarray(cdf))
        assert frac.sum() == pytest.approx(1.0, abs=1e-12)
        assert np.all(frac >= -1e-15)
        # center of mass near (lo + peak + hi)/3 mean of triangle
        centers = 0.5 * (np.asarray(edges[:-1]) + np.asarray(edges[1:]))
        mean = (frac * centers).sum()
        assert mean == pytest.approx((lo + peak + hi) / 3.0, abs=0.05)

    def test_dndp_cr_identity_frame(self):
        """With gamma = 1 the rebinned dN/dp equals the direct
        angle-sum over the PSD."""
        import jax.numpy as jnp
        from montecarloscattering_jl_tpu.models.psd_bins import build_psd_bins
        from montecarloscattering_jl_tpu.utils.species import Species
        sp = [Species(K.MP_CGS, K.QE_CGS, 1e6, 1.0)]
        bins = build_psd_bins(sp, 1, 0.0, 0.01, 0.0, 0.0, 100 * K.MP_C,
                              1.001, 10, 10, 30, 2)
        rng = np.random.default_rng(0)
        nb = 8
        psd = np.zeros((bins.n_mom + 1, bins.n_theta + 1, nb))
        psd[rng.integers(1, bins.n_mom, 60),
            rng.integers(1, bins.n_theta, 60),
            rng.integers(0, nb, 60)] = rng.random(60)
        dn = np.asarray(red.dndp_cr(jnp.asarray(psd), bins, K.MP_C2,
                                    np.ones(nb), 1.0))
        dp = np.diff(bins.mom_edges)
        direct = psd.sum(axis=1) / dp[:, None]
        # shock frame exact
        assert np.allclose(dn[:, :, 0], direct, rtol=1e-12)
        # gamma=1 frames: weight conserved, bins shifted by at most one
        for m in (1, 2):
            assert (dn[:, :, m] * dp[:, None]).sum() == pytest.approx(
                psd.sum(), rel=1e-6)

    def test_ion_reduce_device_matches_split_oracles(self):
        """The fused one-dispatch reduction program returns exactly
        what the separate dndp_cr / d2n_boosted / dndp_2d_ef calls
        produce (it only restructures the dataflow)."""
        import jax.numpy as jnp
        from montecarloscattering_jl_tpu.models.psd_bins import build_psd_bins
        from montecarloscattering_jl_tpu.utils.species import Species
        sp = [Species(K.MP_CGS, K.QE_CGS, 1e6, 1.0)]
        bins = build_psd_bins(sp, 1, 0.0, 0.01, 0.0, 0.0, 100 * K.MP_C,
                              1.001, 10, 10, 30, 2)
        rng = np.random.default_rng(1)
        nb = 8
        shape = (bins.n_mom + 1, bins.n_theta + 1, nb)
        psd = rng.random(shape) * (rng.random(shape) < 0.05)
        therm = rng.random(shape) * (rng.random(shape) < 0.05)
        gamma0 = 2.5
        beta0 = np.sqrt(1 - 1 / gamma0**2)
        gam = np.linspace(gamma0, 1.1, nb)
        ux = np.linspace(beta0, 0.2, nb) * K.C_CGS
        zone_pop = rng.random(nb) + 0.5
        ncross = np.array([0.0, 1, 0, 2, 3, 0, 1, 4])
        e0 = K.MP_C2
        dn_cr, dn_th, d2n_tot, d2n_ef = red.ion_reduce_device(
            psd, therm, bins, e0, gam, ux, gamma0, want_ef=True)
        ef_norm = red.ef_zone_norm(psd, therm, zone_pop, ncross, 1.0)
        d2n_ef = np.asarray(d2n_ef, np.float64) * ef_norm[None, None, :]
        # the fused program runs in f32 on the device; compare
        # against the split oracles on the SAME f32 inputs, with
        # tolerance for f32 summation order
        want_cr = np.asarray(red.dndp_cr(
            jnp.asarray(psd, jnp.float32), bins, e0, gam, gamma0))
        want_th = np.asarray(red.dndp_cr(
            jnp.asarray(therm, jnp.float32), bins, e0, gam, gamma0))
        want_d2n = np.asarray(red.d2n_boosted(
            jnp.asarray(psd + therm, jnp.float32), gam, ux / K.C_CGS,
            e0, bins))
        want_ef = red.dndp_2d_ef(psd, therm, bins, K.MP_CGS, zone_pop,
                                 ncross, 1.0, beta0, gamma0)
        atol_cr = 1e-6 * np.abs(want_cr).max()
        np.testing.assert_allclose(dn_cr, want_cr, rtol=2e-4,
                                   atol=atol_cr)
        np.testing.assert_allclose(dn_th, want_th, rtol=2e-4,
                                   atol=atol_cr)

        def assert_d2n_close(got, want):
            # the f32 program can flip a boosted CELL CENTER into the
            # neighboring bin when it lands within f32 ulp of a bin
            # edge; require conservation + almost-everywhere equality
            got, want = np.asarray(got), np.asarray(want)
            np.testing.assert_allclose(
                got.sum(axis=(0, 1)), want.sum(axis=(0, 1)),
                rtol=1e-5, atol=1e-6 * np.abs(want).max())
            bad = ~np.isclose(got, want, rtol=2e-4,
                              atol=1e-6 * np.abs(want).max())
            assert bad.mean() < 1e-3, f"{bad.sum()} flipped cells"

        assert_d2n_close(d2n_tot, want_d2n)
        assert_d2n_close(d2n_ef, want_ef)

    def test_zone_populations_scaling(self):
        x = np.array([-1e30, -100.0, -1.0, 0.0, 1.0, 100.0, 1e30])
        ux = np.full(7, 1e8)
        g = np.ones(7)
        pop, vol = red.zone_populations(x, 3, 2.0, 0.01, 1.0, 0.0, 0.0,
                                        ux, g)
        # pop = flux * dwell = (gamma0 n0 beta0 c) * dx / ux
        expect = 1.0 * 2.0 * 0.01 * K.C_CGS * 99.0 / 1e8
        assert pop[1] == pytest.approx(expect, rel=1e-12)

    def test_smooth_profile_monotone(self):
        y = np.array([0.0, 9.0, 7.0, 8.0, 5.0, 6.0, 3.0, 1.0, 0.0])
        smooth_profile_inplace(y, 1, 7)
        assert np.all(np.diff(y[1:8]) <= 1e-12)

    def test_gamma_adiab_grid(self):
        nb = 10
        g = np.zeros((nb, 2))
        x = np.linspace(-5, 4, nb)
        par = np.full(nb, 1.0)
        perp = np.full(nb, 2.0)
        ed = np.full(nb, 4.5)
        out = set_gamma_adiab_grid(g, 0, x, 1.4, par, perp, ed)
        assert np.all(out[x[:nb] <= 0, 0] == pytest.approx(5 / 3))
        assert np.all(out[x[:nb] > 0, 0] == pytest.approx(1.4))
        assert np.all(out[:, 1] == pytest.approx(1 + 3.0 / 4.5))


class TestNonlinearRun:
    @pytest.fixture(scope="class")
    def result(self, tmp_path_factory):
        cfg = load_config("tests/data/dsa_nonrel.toml")
        cfg.n_itrs = 2
        cfg.do_smoothing = True
        cfg.n_pts_inj = 60
        cfg.n_pts_pcut = 80
        cfg.n_pts_pcut_hi = 80
        out = tmp_path_factory.mktemp("mcs_out")
        return run(cfg, out_dir=str(out)), out

    def test_smoothing_builds_precursor(self, result):
        res, _ = result
        setup = res.setup
        prof = res.iterations[-1].profile_after
        cfg = setup.cfg
        # far upstream unchanged (to MC noise: a single high-E particle
        # reaching the first zone shifts the flux solve by ~1e-4);
        # near-shock slowed below u0; downstream pinned at u2
        assert prof.ux_sk[1] == pytest.approx(cfg.u0, rel=1e-3)
        assert prof.ux_sk[setup.i_shock - 1] < 0.95 * cfg.u0
        assert prof.ux_sk[setup.nb - 2] == pytest.approx(setup.u2,
                                                         rel=1e-6)
        # monotone deceleration through the precursor (MC-noise slack)
        sl = prof.ux_sk[1:setup.nb - 1]
        assert np.all(np.diff(sl) <= 1e-3 * cfg.u0)

    def test_downstream_adiabatic_index(self, result):
        res, _ = result
        for itr in res.iterations:
            # nonrelativistic escapes: P/KE = 2/3 => Gamma -> 5/3
            assert itr.gamma_downstream == pytest.approx(5 / 3, abs=0.05)

    def test_pressures_positive_downstream(self, result):
        res, _ = result
        fi = res.iterations[-1].ion_finals[0]
        setup = res.setup
        dw = slice(setup.i_shock + 1, setup.nb - 1)
        assert np.all(fi.p_psd_par[dw] > 0)
        assert np.all(fi.p_psd_perp[dw] > 0)
        assert np.all(fi.energy_density_psd[dw] > 0)
        # rough isotropy downstream: 2 P_par / P_perp within a factor 2
        aniso = 2 * fi.p_psd_par[dw] / fi.p_psd_perp[dw]
        assert 0.3 < np.median(aniso) < 3.0

    def test_normalized_dndp_integrates_to_population(self, result):
        res, _ = result
        fi = res.iterations[-1].ion_finals[0]
        setup = res.setup
        dp = np.diff(setup.bins.mom_edges)
        for zone in (setup.i_shock + 3, setup.i_shock + 8):
            tot = ((fi.dndp_cr[:, zone, 1] + fi.dndp_therm[:, zone, 1])
                   * dp).sum()
            if tot > 0:
                assert tot == pytest.approx(fi.zone_pop[zone], rel=1e-6)

    def test_output_files(self, result):
        res, out = result
        names = sorted(os.listdir(out))
        assert "mc_out.dat" in names
        assert "mc_grid.dat" in names
        assert "mc_dNdp_grid_CR.dat" in names
        assert "mc_dNdp_grid_therm.dat" in names
        grid = open(os.path.join(out, "mc_grid.dat")).readlines()
        assert grid[0].startswith("#")
        # 2 iterations x 99 zones rows + the plot-vals footer
        assert len(grid) == 1 + 2 * res.setup.n_grid + 1
        # each row has 34 columns (i_iter i + 33 quantities... header
        # names the 33-column layout of smoothers.jl:234-272)
        assert len(grid[1].split()) == len(grid[-2].split()) >= 34
        # 36-column plot footer (print_plot_vals, io.jl:204-251):
        # sentinel pair, 36 values + n_ions, 4 per species
        foot = grid[-1].split()
        assert foot[:2] == ["3333", "333"]
        n_ions = len(res.setup.cfg.species)
        assert len(foot) == 2 + 37 + 4 * n_ions
        assert float(foot[2 + 2]) == pytest.approx(res.setup.r_comp)
        assert float(foot[2 + 23]) == res.setup.cfg.eta_mfp
