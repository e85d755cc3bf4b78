"""Multi-chip semantics on the 8-device virtual CPU mesh: sharded
transport equals single-device transport; checkpoint round-trips."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarloscattering_jl_tpu.engine.run import TransportEngine
from montecarloscattering_jl_tpu.engine.setup import build_setup
from montecarloscattering_jl_tpu.parallel import (
    load_checkpoint, make_mesh, pad_to_devices, save_checkpoint)
from montecarloscattering_jl_tpu.utils import load_config


def _small_cfg():
    cfg = load_config("tests/data/dsa_nonrel.toml")
    cfg.n_pts_inj = 48
    cfg.n_pts_pcut = 64
    cfg.n_pts_pcut_hi = 64
    cfg.pcuts = cfg.pcuts[:3]
    return cfg


class TestShardedTransport:
    def test_mesh_has_8_devices(self):
        mesh = make_mesh()
        assert mesh.size == 8

    def test_sharded_matches_single_device(self):
        """The same ion run on 1 device and on the 8-device mesh must
        produce identical tallies (counter-based RNG keyed by global
        lane index makes results mesh-shape independent)."""
        cfg = _small_cfg()
        setup = build_setup(cfg)

        # fused=False: the mesh path splits on the host, so the
        # single-device side must too for bitwise comparison (the fused
        # on-device splitter differs at float rounding — see
        # tests/test_fused.py for its equivalence check)
        eng1 = TransportEngine(setup, fused=False)
        it1 = eng1.new_iteration_tallies()
        res1 = eng1.run_ion(0, 0, setup.profile, it1)

        eng8 = TransportEngine(setup, mesh=make_mesh())
        assert eng8.batch_size % 8 == 0
        it8 = eng8.new_iteration_tallies()
        res8 = eng8.run_ion(0, 0, setup.profile, it8)

        # batch sizes may differ (padding), but live lanes are keyed by
        # index, so physics tallies must match exactly
        np.testing.assert_allclose(res8.psd, res1.psd, rtol=1e-12)
        np.testing.assert_allclose(res8.therm_psd, res1.therm_psd,
                                   rtol=1e-12)
        np.testing.assert_allclose(it8.pxx_flux, it1.pxx_flux, rtol=1e-12)
        np.testing.assert_allclose(it8.energy_flux, it1.energy_flux,
                                   rtol=1e-12)
        assert float(res8.esc.esc_flux) == pytest.approx(
            float(res1.esc.esc_flux), rel=1e-12)

    @pytest.mark.parametrize("n_devices", [2, 4, 8])
    def test_mesh_ladder_matches_single_device(self, n_devices):
        """The ladder users get with --devices N — the host-split pcut
        loop over sharded_run_segment — at several mesh sizes: shards
        on distinct devices, trajectories and pushes exact, tallies to
        summation order."""
        cfg = _small_cfg()
        setup = build_setup(cfg)
        eng1 = TransportEngine(setup, fused=False)
        it1 = eng1.new_iteration_tallies()
        res1 = eng1.run_ion(0, 0, setup.profile, it1)

        mesh = make_mesh(n_devices)
        assert len({d.id for d in mesh.devices.flat}) == n_devices
        eng = TransportEngine(setup, mesh=mesh)
        assert eng.ladder_path() == "host"
        assert eng.batch_size % n_devices == 0
        it = eng.new_iteration_tallies()
        res = eng.run_ion(0, 0, setup.profile, it)

        assert res.n_trajectories == res1.n_trajectories > 0
        assert res.n_pushes == res1.n_pushes > 0
        np.testing.assert_allclose(res.psd, res1.psd, rtol=1e-12)
        np.testing.assert_allclose(it.pxx_flux, it1.pxx_flux, rtol=1e-12)
        np.testing.assert_allclose(it.energy_flux, it1.energy_flux,
                                   rtol=1e-12)

    def test_pad_to_devices(self):
        assert pad_to_devices(1, 8, 32) == 256
        assert pad_to_devices(1000, 8, 128) == 1024


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        cfg = _small_cfg()
        setup = build_setup(cfg)
        path = str(tmp_path / "ckpt.npz")
        gg = np.random.default_rng(0).random((setup.nb, 2))
        save_checkpoint(
            path, i_iter=3, profile=setup.profile, gamma_grid=gg,
            q_px_hist=np.arange(5.0), q_en_hist=np.arange(5.0) * 2,
            px_esc_hist=np.zeros(5), en_esc_hist=np.zeros(5),
            gamma_dw_hist=np.full(5, 1.5), prof_weight_fac=2.5,
            random_seed=cfg.random_seed, meta={"config": "dsa_nonrel"})
        ck = load_checkpoint(path)
        assert ck["i_iter"] == 3
        np.testing.assert_array_equal(ck["profile"].ux_sk,
                                      setup.profile.ux_sk)
        np.testing.assert_array_equal(ck["gamma_grid"], gg)
        assert ck["prof_weight_fac"] == 2.5
        assert ck["meta"]["config"] == "dsa_nonrel"
        assert ck["profile"].bmag2 == setup.profile.bmag2


class TestGraftEntry:
    def test_entry_compiles(self):
        import __graft_entry__ as ge
        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out)
        state, tallies = out
        assert state.x.shape == (256,)

    def test_dryrun_multichip(self):
        # Run in a fresh interpreter: the dry run pins a small helix
        # cap (MCS_MAX_HELIX_STEPS), which must land before the
        # process's first utils.params import.
        import subprocess
        import sys

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        r = subprocess.run(
            [sys.executable, "__graft_entry__.py", "multichip", "8"],
            cwd=repo, env=env, capture_output=True, text=True,
            timeout=1200)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
        assert "dryrun_multichip OK" in r.stdout
        assert "mesh-ladder OK" in r.stdout
