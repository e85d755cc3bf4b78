"""Host-chunked drains == monolithic drains.

Deep helix caps run as a sequence of bounded device programs
(MCS_XLA_STEPS_PER_PROG while-trips each, ops/step.run_segment_chunked)
re-dispatched until the population drains.  These tests pin the
chunked paths to their monolithic twins:

* run_segment: state bitwise (counter RNG is the per-lane step
  count), tallies to float tolerance (the record buffer flushes its
  partial chunk at each program exit);
* the per-segment XLA ladder (ops/fused_ion.run_ion_xla_hybrid), whose
  segments drain chunked above the budget: split counts and pushes
  exact, state bitwise, tallies and escapes to float tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.slow


def _state_tuple(st):
    return [np.asarray(x) for x in jax.tree.leaves(
        jax.tree.map(lambda a: a, st._replace(
            key=jax.random.key_data(st.key))))]


def _copy(tree):
    """Deep-copy a pytree so donation in one run cannot invalidate
    the shared fixture for the next."""
    def cp(a):
        if hasattr(a, "dtype") and jax.dtypes.issubdtype(
                a.dtype, jax.dtypes.prng_key):
            return jax.random.wrap_key_data(
                jnp.copy(jax.random.key_data(a)), impl="threefry2x32")
        return jnp.copy(a)
    return jax.tree.map(cp, tree)


@pytest.fixture(scope="module")
def built():
    import __graft_entry__ as ge
    return ge._build(batch=256, p_dtype=jnp.float32)


class TestHybridLadderChunked:
    def _ladder(self, built, budget, monkeypatch):
        from montecarloscattering_jl_tpu.ops import fused_ion as fi
        from montecarloscattering_jl_tpu.ops import state as stt
        from montecarloscattering_jl_tpu.ops.finish import EscapeTallies

        monkeypatch.setenv("MCS_XLA_STEPS_PER_PROG", budget)
        setup, state, tal, grids, sc, ss = built
        state, tal = _copy(state), _copy(tal)
        pcut0 = float(sc.pcut)
        pcuts = np.asarray([pcut0, pcut0 * 3.0, pcut0 * 9.0])
        prevs = np.asarray([0.0, pcut0, pcut0 * 3.0])
        targets = np.full(3, 256, np.int64)
        keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
            jax.random.key(7), jnp.arange(1, 4, dtype=jnp.uint32))
        esc = EscapeTallies.zeros(setup.bins.n_mom, setup.bins.n_theta)
        st, tl, es, n_new, nsteps = fi.run_ion_xla_hybrid(
            state, tal, esc, grids, sc, ss, pcuts, prevs, targets, keys,
            0)
        return (st, stt.finalize_tallies(tl), es, np.asarray(n_new),
                np.asarray(nsteps))

    def test_ladder_chunked_matches_monolithic(self, built, low_cap,
                                               monkeypatch):
        s1, f1, e1, n1, ns1 = self._ladder(built, "0", monkeypatch)
        s2, f2, e2, n2, ns2 = self._ladder(built, "100", monkeypatch)
        np.testing.assert_array_equal(n1, n2)
        np.testing.assert_array_equal(ns1, ns2)
        for a, b in zip(_state_tuple(s1), _state_tuple(s2)):
            np.testing.assert_array_equal(a, b)
        for name in f1._fields:
            np.testing.assert_allclose(
                np.asarray(getattr(f1, name), np.float64),
                np.asarray(getattr(f2, name), np.float64),
                rtol=2e-5, atol=1e-30, err_msg=name)
        for a, b in zip(jax.tree.leaves(e1), jax.tree.leaves(e2)):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=1e-9, atol=1e-30)


class TestXlaChunked:
    def test_state_bitwise_tallies_close(self, built, low_cap):
        from montecarloscattering_jl_tpu.ops import state as stt
        from montecarloscattering_jl_tpu.ops import step as stp

        setup, state, tal, grids, sc, ss = built
        s1, t1 = stp.run_segment_jit(_copy(state), _copy(tal), grids,
                                     sc, ss, 0)
        f1 = stt.finalize_tallies(t1)
        s2, t2 = stp.run_segment_chunked(_copy(state), _copy(tal),
                                         grids, sc, ss, 0, budget=100)
        f2 = stt.finalize_tallies(t2)
        for a, b in zip(_state_tuple(s1), _state_tuple(s2)):
            np.testing.assert_array_equal(a, b)
        # tally grouping differs at chunk boundaries (partial record
        # flushes): float-rounding-order differences only
        for name in f1._fields:
            a = np.asarray(getattr(f1, name), np.float64)
            b = np.asarray(getattr(f2, name), np.float64)
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-30,
                                       err_msg=name)


if __name__ == "__main__":
    pytest.main([__file__, "-v"])
