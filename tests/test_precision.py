"""Mixed-precision path: the float32 momentum kernel must reproduce the
float64 physics (positions/times stay float64 in both)."""

import jax.numpy as jnp
import numpy as np
import pytest

from montecarloscattering_jl_tpu.engine.run import TransportEngine
from montecarloscattering_jl_tpu.engine.setup import build_setup
from montecarloscattering_jl_tpu.utils import constants as K
from montecarloscattering_jl_tpu.utils import load_config


class TestF32Path:
    def test_dsa_power_law_f32(self):
        """The f32 kernel gives the same DSA power law as f64 within
        MC tolerance (trajectories diverge chaotically; the spectrum
        is the invariant)."""
        cfg = load_config("tests/data/dsa_nonrel.toml")
        cfg.n_pts_inj = 100
        cfg.n_pts_pcut = 150
        cfg.n_pts_pcut_hi = 150
        setup = build_setup(cfg)
        slopes = {}
        for name, dt in (("f64", jnp.float64), ("f32", jnp.float32)):
            eng = TransportEngine(setup, p_dtype=dt)
            it = eng.new_iteration_tallies()
            res = eng.run_ion(0, 0, setup.profile, it)
            p_cent = setup.bins.mom_centers
            dp = np.diff(setup.bins.mom_edges)
            dndp = res.psd[:, :, 75].sum(axis=1) / dp
            sel = ((p_cent > 0.018 * K.MP_C) & (p_cent < 0.12 * K.MP_C)
                   & (dndp > 0))
            slopes[name] = np.polyfit(np.log10(p_cent[sel]),
                                      np.log10(dndp[sel]), 1)[0]
            # flux conservation unaffected by precision
            pxx_norm = it.pxx_flux[60:64] / setup.f_px_upstream
            assert np.all(pxx_norm > 0.8), name
        assert slopes["f32"] == pytest.approx(slopes["f64"], abs=0.4)

    def test_f32_state_dtypes_stable(self):
        """One helix step keeps the f32 carry dtypes (no silent
        upcasts that would break the while_loop)."""
        from montecarloscattering_jl_tpu.models.injection import init_pop
        from montecarloscattering_jl_tpu.ops import state as stt
        from montecarloscattering_jl_tpu.ops import step as stp
        import jax

        cfg = load_config("tests/data/dsa_nonrel.toml")
        setup = build_setup(cfg)
        eng = TransportEngine(setup, p_dtype=jnp.float32)
        prof = setup.profile
        grids = eng.segment_grids(prof)
        sc = eng.segment_scalars(0, 0, prof.bmag2)
        ss = eng.step_static(0)
        rng = np.random.default_rng(0)
        pop = init_pop(rng, cfg.species, 0, 1, cfg.energy_inj, True, 64,
                       setup.x_grid_start, cfg.rg0, 1.0, True, -1.0,
                       cfg.beta0, cfg.gamma0, cfg.u0, setup.x_grid_rg,
                       prof.ux_sk, prof.gamma_sf)
        state = stt.init_state(pop.weight, pop.ptot_pf, pop.pb_pf,
                               pop.x_cm, pop.i_grid,
                               prof.ux_sk[pop.i_grid], cfg.xn_per_fine,
                               setup.x_grid_stop, jax.random.key(0),
                               p_dtype=jnp.float32)
        tal = stt.make_tallies(setup.nb, setup.bins.n_mom,
                               setup.bins.n_theta, 0, 1,
                               batch=len(pop.ptot_pf), chunk=4,
                               p_dtype=jnp.float32)
        s2, _ = stp.helix_step(state, tal, grids, sc, ss)
        assert s2.pb.dtype == jnp.float32
        assert s2.pperp.dtype == jnp.float32
        assert s2.phi.dtype == jnp.float32
        assert s2.x.dtype == jnp.float64
        assert s2.acctime.dtype == jnp.float64
        assert s2.prp_x.dtype == jnp.float64


def _dot_generals(jaxpr):
    """Every dot_general equation in a (closed) jaxpr, sub-jaxprs of
    scans, conds, while loops and nested jits included."""
    import jax

    found = []

    def walk(j):
        for eqn in j.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn)
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    return found


def _is_highest(eqn):
    from jax import lax
    prec = eqn.params["precision"]
    if isinstance(prec, tuple):
        return all(p == lax.Precision.HIGHEST for p in prec)
    return prec == lax.Precision.HIGHEST


def _step_inputs(p_dtype=jnp.float32, batch=64):
    import __graft_entry__ as ge
    return ge._build(batch=batch, p_dtype=p_dtype)


def _case_step_zone_gather():
    import jax
    from montecarloscattering_jl_tpu.ops import step as stp
    setup, state, tal, grids, sc, ss = _step_inputs()
    return jax.make_jaxpr(
        lambda st, tl: stp.helix_step(st, tl, grids, sc, ss))(state, tal)


def _case_flush_range_contraction():
    import jax
    from montecarloscattering_jl_tpu.ops import step as stp
    setup, state, tal, grids, sc, ss = _step_inputs()
    return jax.make_jaxpr(lambda tl: stp._flush_records(tl, ss))(tal)


def _bins_and_profile():
    setup = build_setup(load_config("tests/data/dsa_nonrel.toml"))
    return setup, setup.bins, setup.profile


def _case_reduce_dn_transformed():
    import jax
    from montecarloscattering_jl_tpu.ops import reduce as red
    setup, bins, _ = _bins_and_profile()
    psd_z = jnp.ones((bins.n_mom + 1, bins.n_theta + 1), jnp.float32)
    return jax.make_jaxpr(
        lambda p: red._dn_transformed(
            p, jnp.float32(1.5), K.MP_C2, jnp.asarray(bins.mom_edges),
            jnp.asarray(bins.cos_bounds()),
            jnp.asarray(bins.mom_bounds_log), bins.n_mom, bins.n_theta))(
        psd_z)


def _case_reduce_ion_prog():
    import jax
    from montecarloscattering_jl_tpu.ops import reduce as red
    setup, bins, prof = _bins_and_profile()
    psd = jnp.ones((bins.n_mom + 1, bins.n_theta + 1, setup.nb),
                   jnp.float32)
    return jax.make_jaxpr(
        lambda p, t: red.ion_reduce_device(
            p, t, bins, K.MP_C2, prof.gamma_sf, prof.ux_sk,
            setup.cfg.gamma0, want_ef=True, fetch=False))(psd, psd)


def _case_emission_ic():
    import jax
    from montecarloscattering_jl_tpu.models.emission.device import (
        ic_grid_device)
    from montecarloscattering_jl_tpu.models.emission.inverse_compton \
        import cmb_photon_field
    p_edges = jnp.asarray(np.logspace(-20, -14, 21))
    alpha = jnp.asarray(np.logspace(-12, -3, 16))
    a1, n_ph = cmb_photon_field(0.1)
    ne = jnp.ones((5, 20), jnp.float64)
    return jax.make_jaxpr(
        lambda n: ic_grid_device(n, p_edges, alpha,
                                 (jnp.asarray(a1), jnp.asarray(n_ph)),
                                 K.ME_CGS * K.C_CGS, 1.0, 1.0))(ne)


def _case_emission_pion():
    import jax
    from montecarloscattering_jl_tpu.models.emission.device import (
        pion_grid_device)
    p_edges = np.logspace(-15, -11, 21)
    e_gamma = np.logspace(-6, 1, 12)
    counts = jnp.ones((5, 20), jnp.float64)
    return jax.make_jaxpr(
        lambda c: pion_grid_device(c, p_edges, e_gamma, np.ones(5), 1.0,
                                   K.MP_C, 1.0))(counts)


MAIN_PATH_MATMULS = {
    "step_zone_gather": _case_step_zone_gather,
    "flush_range_contraction": _case_flush_range_contraction,
    "reduce_dn_transformed": _case_reduce_dn_transformed,
    "reduce_ion_prog": _case_reduce_ion_prog,
    "emission_ic": _case_emission_ic,
    "emission_pion": _case_emission_pion,
}


class TestMatmulPrecisionPin:
    """Every matrix product on the main path asks for HIGHEST
    precision, so a GPU never runs it with TF32 operands (10 mantissa
    bits).  The jaxpr carries the request to XLA on every backend."""

    @pytest.mark.parametrize("case", list(MAIN_PATH_MATMULS))
    def test_dot_generals_pinned_highest(self, case):
        dots = _dot_generals(MAIN_PATH_MATMULS[case]())
        assert dots, f"{case}: no matrix product traced"
        loose = [str(e.params["precision"]) for e in dots
                 if not _is_highest(e)]
        assert not loose, f"{case}: unpinned products {loose}"
