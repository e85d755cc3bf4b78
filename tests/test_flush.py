"""The crossing-record flush (ops/step._flush_records) against float64
NumPy references.

The flush is the tally update of the transport step (the reference's
per-crossing ``psd[i_pt, jθ, i] += w·|1/vx|`` and the flux sums,
all_flux.jl:219-257, in difference-array form):

  * the (p, θ, zone) histogram is a flat scatter pair (``+w`` at
    ``cell * nzc + lo``, ``-w`` at ``cell * nzc + hi + 1``), checked
    against ``np.add.at`` over record layouts that stress index
    handling, accumulation and precision;
  * the four flux channels are one signed one-hot range contraction,
    checked channel by channel against a NumPy segment sum.

Each case runs with float32 and float64 records and PSD.  Tolerances
are set from the dtype: an f32 cell that accumulates n records carries
up to ~n/2 ulp of rounding (n <= a few hundred here), an f64 one
~1e-13 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from montecarloscattering_jl_tpu.ops import state as stt
from montecarloscattering_jl_tpu.ops import step as stp

N_MOM, N_THETA = 99, 9
N_CELLS = (N_MOM + 1) * 2 * (N_THETA + 1)    # 2000 cells
NB = 49
NZC = NB + 1
OLD_BAND = 1536          # widest cell window one flush once assumed

TOL = {"f32": 1e-5, "f64": 1e-12}
DTYPES = {"f32": jnp.float32, "f64": jnp.float64}


def _static(nb=NB, n_mom=N_MOM, n_theta=N_THETA):
    return stp.StepStatic(
        eta_mfp=1.0, xn_per_coarse=50.0, xn_per_fine=100.0,
        dont_scatter=False, dont_dsa=False, do_rad_losses=False,
        do_retro=False, do_tcuts=False, use_custom_eps_b=False,
        is_electron=False, do_energy_transfer=False,
        electron_weight_fac=0.0, n_xspec=0, i_grid_feb=0,
        i_shock=3, nb=nb, psd_mom_min=1e-22, bins_per_dec_mom=10,
        n_mom=n_mom, cos_fine=0.5, dcos=0.01, theta_min=1e-4,
        bins_per_dec_theta=10, n_theta=n_theta)


def _records(r, rng, cell_lo, cell_hi, rate=0.3, max_span=3):
    cell = rng.integers(cell_lo, cell_hi, r).astype(np.int32)
    lo = rng.integers(0, NZC - max_span - 1, r).astype(np.int32)
    hi = lo + rng.integers(0, max_span, r).astype(np.int32)
    w = (rng.random(r, np.float32) + 0.1) * (
        rng.random(r) < rate).astype(np.float32)
    return cell, lo, hi, w


def _flush(cell, lo, hi, w, dtype, psd0=None, vals=None, chunk=4):
    """Pack records into a [chunk, 8, B] buffer and flush it."""
    r = len(cell)
    assert r % chunk == 0
    b = r // chunk
    tal = stt.make_tallies(NB, N_MOM, N_THETA, 0, 0, dtype, batch=b,
                           chunk=chunk, p_dtype=dtype)
    if psd0 is not None:
        tal = tal._replace(psd_diff=jnp.asarray(psd0, dtype))
    rows = np.zeros((8, r))
    if vals is not None:
        rows[:4] = vals
    rows[4], rows[5], rows[6], rows[7] = w, lo, hi, cell
    rec = rows.reshape(8, chunk, b).transpose(1, 0, 2)
    tal = tal._replace(rec=jnp.asarray(rec, dtype))
    return stp._flush_records(tal, _static())


def _psd_ref(psd0, cell, lo, hi, w):
    out = np.asarray(psd0, np.float64).copy()
    flat = out.reshape(-1)
    base = np.asarray(cell, np.int64) * NZC
    w64 = np.asarray(w, np.float32).astype(np.float64)
    np.add.at(flat, base + np.asarray(lo), w64)
    np.add.at(flat, base + np.asarray(hi) + 1, -w64)
    return out


# -- the histogram scenarios ------------------------------------------------

def _dense_window(rng):
    return _records(4096, rng, 30, 30 + 255) + (None,)


def _accumulate_existing(rng):
    return _records(4096, rng, 10, 90) + (
        rng.random((N_CELLS, NZC)).astype(np.float32),)


def _row_padding(rng):
    # 4353 records: not a multiple of any lane or tile width
    return _records(4353, rng, 0, 255) + (None,)


def _wider_than_old_band(rng):
    cell, lo, hi, w = _records(4096, rng, 0, N_CELLS)
    assert cell.max() - cell.min() >= OLD_BAND
    return cell, lo, hi, w, None


def _full_mantissa_weights(rng):
    # 1.001 is not bf16-representable: a bf16 tally rounds it to 1.0;
    # the f32/f64 scatter must keep every mantissa bit of each record
    r = 4096
    z3 = np.full(r, 3, np.int32)
    return (np.full(r, 5, np.int32), z3, z3,
            np.full(r, 1.001, np.float32), None)


def _all_padding(rng):
    z = np.zeros(4096, np.int32)
    return z, z, z, np.zeros(4096, np.float32), None


def _zero_weight_wild_cells(rng):
    cell, lo, hi, w = _records(4096, rng, 44, N_CELLS)
    # non-crossing rows point at cell 0 (the layout padding lanes get)
    cell = np.where(w == 0, np.int32(0), cell)
    return cell, lo, hi, w, None


def _sparse_window(rng):
    # low crossing rate (the production regime, mean ~0.17)
    return _records(8192, rng, 30, 30 + 255, rate=0.08) + (None,)


def _wide_zone_spans(rng):
    # multi-zone hops spanning up to the whole zone axis
    return _records(4096, rng, 0, 255, rate=0.08,
                    max_span=NZC - 2) + (None,)


def _mixed_density(rng):
    c1, l1, h1, w1 = _records(4096, rng, 10, 265, rate=0.9)
    c2, l2, h2, w2 = _records(4096, rng, 10, 265, rate=0.05)
    return (np.concatenate([c1, c2]), np.concatenate([l1, l2]),
            np.concatenate([h1, h2]), np.concatenate([w1, w2]), None)


SCENARIOS = {
    "dense_window": _dense_window,
    "accumulate_existing": _accumulate_existing,
    "row_padding": _row_padding,
    "wider_than_old_band": _wider_than_old_band,
    "full_mantissa_weights": _full_mantissa_weights,
    "all_padding": _all_padding,
    "zero_weight_wild_cells": _zero_weight_wild_cells,
    "sparse_window": _sparse_window,
    "wide_zone_spans": _wide_zone_spans,
    "mixed_density": _mixed_density,
}


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_psd_scatter_matches_numpy(scenario, dt):
    rng = np.random.default_rng(sorted(SCENARIOS).index(scenario))
    cell, lo, hi, w, psd0 = SCENARIOS[scenario](rng)
    chunk = 1 if len(cell) % 4 else 4
    out = _flush(cell, lo, hi, w, DTYPES[dt], psd0=psd0, chunk=chunk)
    assert out.psd_diff.dtype == DTYPES[dt]
    got = np.asarray(out.psd_diff, np.float64)
    base = np.zeros((N_CELLS, NZC)) if psd0 is None else psd0
    want = _psd_ref(base, cell, lo, hi, w)
    if not np.asarray(w).any() and psd0 is None:
        assert (got == 0).all()
        return
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=TOL[dt],
                               atol=TOL[dt] * scale)
    # the flush consumes its records: the buffer comes back zeroed
    assert not np.asarray(out.rec).any()


# -- the four flux channels ---------------------------------------------------

CHANNELS = ["pxx", "pxz", "energy", "n_crossings"]


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("channel", CHANNELS)
def test_flux_range_contraction_matches_segment_sum(channel, dt):
    rng = np.random.default_rng(40 + CHANNELS.index(channel))
    r = 4096
    cell, lo, hi, w = _records(r, rng, 0, N_CELLS, max_span=NZC - 2)
    crossed = w > 0
    sign = np.where(rng.random(r) < 0.5, 1.0, -1.0)
    mag = rng.lognormal(0.0, 2.0, r)      # values spanning decades
    vals = np.zeros((4, r))
    vals[0] = sign * mag * crossed        # signed momentum flux
    vals[1] = mag * crossed               # |p_z| flux
    vals[2] = sign * mag ** 2 * crossed   # signed energy flux
    vals[3] = crossed                     # crossing count
    c = CHANNELS.index(channel)
    vals = vals.astype(DTYPES[dt])        # the buffer's precision
    out = _flush(cell, lo, hi, w, DTYPES[dt], vals=vals)
    got = np.asarray(out.flux_diff[c], np.float64)

    v = np.asarray(vals[c], np.float64)
    want = np.zeros(NZC)
    np.add.at(want, lo, v)
    np.add.at(want, hi + 1, -v)
    # compare the prefix-summed per-boundary totals too: a lost or
    # shifted record changes every boundary past it
    scale = np.abs(v).sum()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=TOL[dt],
                               atol=TOL[dt] * scale)
    np.testing.assert_allclose(np.cumsum(got), np.cumsum(want),
                               rtol=TOL[dt], atol=TOL[dt] * scale)


class TestFlushLayout:
    """The (ip, kind, jt) flat layout round-trips through
    _flush_records + finalize_tallies."""

    def test_flush_and_finalize(self):
        from montecarloscattering_jl_tpu.ops import state as stt
        from montecarloscattering_jl_tpu.ops import step as stp

        nb, n_mom, n_theta = 7, 5, 3
        nzc = nb + 1
        b = 16
        ss = stp.StepStatic(
            eta_mfp=1.0, xn_per_coarse=50.0, xn_per_fine=100.0,
            dont_scatter=False, dont_dsa=False, do_rad_losses=False,
            do_retro=False, do_tcuts=False, use_custom_eps_b=False,
            is_electron=False, do_energy_transfer=False,
            electron_weight_fac=0.0, n_xspec=0, i_grid_feb=0,
            i_shock=3, nb=nb, psd_mom_min=1e-22, bins_per_dec_mom=10,
            n_mom=n_mom, cos_fine=0.5, dcos=0.01, theta_min=1e-4,
            bins_per_dec_theta=10, n_theta=n_theta)
        tal = stt.make_tallies(nb, n_mom, n_theta, 0, 0, jnp.float32,
                               batch=b, chunk=1)
        rng = np.random.default_rng(5)
        ip = rng.integers(0, n_mom + 1, b)
        kind = rng.integers(0, 2, b)
        jt = rng.integers(0, n_theta + 1, b)
        cell = (ip * 2 + kind) * (n_theta + 1) + jt
        lo = rng.integers(0, nb - 2, b)
        hi = lo + rng.integers(0, 2, b)
        w = rng.random(b, np.float32)
        rec = np.zeros((1, 8, b), np.float64)
        rec[0, 4] = w
        rec[0, 5] = lo
        rec[0, 6] = hi
        rec[0, 7] = cell
        tal = tal._replace(rec=jnp.asarray(rec))
        fin = stt.finalize_tallies(stp._flush_records(tal, ss))

        want = np.zeros((2, n_mom + 1, n_theta + 1, nzc))
        for i in range(b):
            want[kind[i], ip[i], jt[i], lo[i]] += w[i]
            want[kind[i], ip[i], jt[i], hi[i] + 1] -= w[i]
        want = np.cumsum(want, axis=-1)[..., :-1]
        np.testing.assert_allclose(np.asarray(fin.psd), want[0],
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(fin.therm_psd), want[1],
                                   rtol=1e-6)


if __name__ == "__main__":
    pytest.main([__file__, "-v"])
