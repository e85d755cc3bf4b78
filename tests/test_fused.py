"""Fused pcut ladder (ops/fused_ion.py) vs the host splitting loop.

Both paths key lane RNG identically — fold_in(fold_in(ion_key,
i_pcut + 1), lane) — and both lay the split population out interleaved
(lane j replays saved lane j // i_mult with weight / i_mult, matching
new_pcut, cuts.jl:34-98), so a whole nonlinear run must agree to
float rounding: the only difference is the host path re-deriving
pperp from (ptot, pb) between segments.
"""

import numpy as np
import pytest

from montecarloscattering_jl_tpu.engine import run
from montecarloscattering_jl_tpu.utils import load_config


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    def go(fused, tag):
        cfg = load_config("tests/data/dsa_nonrel.toml")
        cfg.n_itrs = 1
        cfg.n_pts_inj = 40
        cfg.n_pts_pcut = 60
        cfg.n_pts_pcut_hi = 60
        out = tmp_path_factory.mktemp(tag)
        return run(cfg, out_dir=str(out), fused=fused)

    return go(True, "fused"), go(False, "host")


class TestFusedEquivalence:
    def test_trajectory_and_push_counts_match(self, pair):
        f, h = pair
        assert f.n_trajectories == h.n_trajectories
        assert f.n_pushes == h.n_pushes

    def test_spectra_match(self, pair):
        f, h = pair
        a = f.iterations[-1].ion_finals[0].dndp_cr
        b = h.iterations[-1].ion_finals[0].dndp_cr
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)

    def test_profile_match(self, pair):
        f, h = pair
        np.testing.assert_allclose(
            f.iterations[-1].profile_after.ux_sk,
            h.iterations[-1].profile_after.ux_sk, rtol=1e-6)

    def test_escapes_match(self, pair):
        f, h = pair
        fe = f.iterations[-1].ion_finals[0]
        he = h.iterations[-1].ion_finals[0]
        np.testing.assert_allclose(fe.esc.esc_flux, he.esc.esc_flux,
                                   rtol=1e-6)
        np.testing.assert_allclose(fe.esc.esc_psd_up.sum(),
                                   he.esc.esc_psd_up.sum(), rtol=1e-6)


class TestXlaHybridLadder:
    """run_ion_xla_hybrid (per-segment device programs, async
    dispatch) vs run_ion_fused (one lax.scan program): same
    split_on_device, same keys — counts exact, tallies to rounding.
    A dead mid-ladder level checks the async driver's no-op /
    dead-tail reporting (chain death at a segment index not divisible
    by MCS_HYBRID_SYNC_EVERY, so over-dispatched segments must leave
    no trace)."""

    @pytest.fixture(scope="class")
    def hybrid_pair(self):
        import jax
        import jax.numpy as jnp

        import __graft_entry__ as ge
        from montecarloscattering_jl_tpu.ops import fused_ion as fi
        from montecarloscattering_jl_tpu.ops import state as stt
        from montecarloscattering_jl_tpu.ops.finish import EscapeTallies

        B = 512
        setup, state, tal, grids, sc, ss = ge._build(
            batch=B, p_dtype=jnp.float32)
        pcut0 = float(sc.pcut)
        dead = pcut0 * 1e6   # nothing ever reaches: kills the chain
        pcuts = np.asarray([pcut0, pcut0 * 3.0, dead, dead * 3.0,
                            dead * 9.0])
        prevs = np.concatenate([[0.0], pcuts[:-1]])
        n_seg = len(pcuts)
        targets = np.full(n_seg, B, np.int64)
        keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
            jax.random.key(7), jnp.arange(1, n_seg + 1,
                                          dtype=jnp.uint32))

        def fresh():
            _, st, tl, *_ = ge._build(batch=B, p_dtype=jnp.float32)
            es = EscapeTallies.zeros(setup.bins.n_mom,
                                     setup.bins.n_theta)
            return st, tl, es

        st, tl, es = fresh()
        scan = fi.run_ion_fused(
            st, tl, es, grids, sc, ss,
            jnp.asarray(pcuts, jnp.float32),
            jnp.asarray(prevs, jnp.float32),
            jnp.asarray(targets, jnp.int32), keys, 0)
        st, tl, es = fresh()
        hyb = fi.run_ion_xla_hybrid(
            st, tl, es, grids, sc, ss, pcuts, prevs, targets, keys, 0)
        return scan, hyb

    def test_counts_exact(self, hybrid_pair):
        (_, _, _, n1, s1), (_, _, _, n2, s2) = hybrid_pair
        np.testing.assert_array_equal(np.asarray(n1), np.asarray(n2))
        np.testing.assert_array_equal(
            np.asarray(s1, np.uint64), np.asarray(s2, np.uint64))

    def test_dead_tail_zeroed(self, hybrid_pair):
        (_, _, _, n1, _), (_, _, _, n2, _) = hybrid_pair
        n1, n2 = np.asarray(n1), np.asarray(n2)
        assert n1[0] > 0 and n1[1] > 0   # live levels split
        assert (n1[2:] == 0).all() and (n2[2:] == 0).all()

    def test_tallies_match(self, hybrid_pair):
        from montecarloscattering_jl_tpu.ops import state as stt
        (_, t1, _, _, _), (_, t2, _, _, _) = hybrid_pair
        f1, f2 = stt.finalize_tallies(t1), stt.finalize_tallies(t2)
        for name in ("psd", "therm_psd", "pxx_flux", "energy_flux",
                     "num_crossings"):
            np.testing.assert_allclose(
                np.asarray(getattr(f2, name), np.float64),
                np.asarray(getattr(f1, name), np.float64),
                rtol=1e-5, atol=1e-30, err_msg=name)


class TestFailFast:
    def test_ladder_checks_at_sync_points(self, monkeypatch):
        """drive_ladder_async must call check at every sync point so
        an overflow raises within MCS_HYBRID_SYNC_EVERY segments."""
        import jax.numpy as jnp

        from montecarloscattering_jl_tpu.ops import fused_ion as fi

        monkeypatch.setenv("MCS_HYBRID_SYNC_EVERY", "2")
        calls = []

        def dispatch(i):
            return jnp.asarray(1, jnp.int32), jnp.asarray(10, jnp.int32)

        def check(i):
            calls.append(i)
            if i >= 3:
                raise RuntimeError(f"overflow by segment {i}")

        with pytest.raises(RuntimeError, match="segment 3"):
            fi.drive_ladder_async(dispatch, 16, check=check)
        assert calls == [1, 3]   # sync points, not every segment

    def test_dead_chain_still_checked_then_breaks(self, monkeypatch):
        import jax.numpy as jnp

        from montecarloscattering_jl_tpu.ops import fused_ion as fi

        monkeypatch.setenv("MCS_HYBRID_SYNC_EVERY", "2")
        calls = []

        def dispatch(i):
            return jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32)

        n_new, _ = fi.drive_ladder_async(
            dispatch, 8, check=calls.append)
        assert calls == [1]      # checked once, then early-broke
        assert (n_new == 0).all()
