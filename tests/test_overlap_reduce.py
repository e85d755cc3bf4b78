"""Overlapped per-species reductions (engine/driver.py) must be
bitwise identical to the synchronous order.

Species i's reduction finish() — device fetch +
f64 host normalization — runs on a worker thread while species i+1's
transport dispatches.  Same math, same inputs, same f64 host order,
so every reduction product must match the MCS_OVERLAP_REDUCE=0 run
exactly (the device reduce program is dispatched identically in both
modes; only the host-side scheduling differs).
"""

import numpy as np
import pytest

from montecarloscattering_jl_tpu.engine.driver import run
from montecarloscattering_jl_tpu.utils import load_config

pytestmark = pytest.mark.slow


def _small_run(monkeypatch, overlap: str):
    monkeypatch.setenv("MCS_OVERLAP_REDUCE", overlap)
    cfg = load_config("tests/data/dsa_nonrel.toml")
    cfg.n_itrs = 2
    return run(cfg)


def test_overlap_bitwise(monkeypatch):
    r0 = _small_run(monkeypatch, "0")
    r1 = _small_run(monkeypatch, "1")
    for it0, it1 in zip(r0.iterations, r1.iterations):
        for f0, f1 in zip(it0.ion_finals, it1.ion_finals):
            for name in ("dndp_therm", "dndp_cr", "zone_pop",
                         "p_psd_par", "p_psd_perp",
                         "energy_density_psd", "psd", "therm_psd"):
                a, b = getattr(f0, name), getattr(f1, name)
                assert np.array_equal(np.asarray(a), np.asarray(b),
                                      equal_nan=True), name
        assert it0.gamma_downstream == it1.gamma_downstream
        assert np.array_equal(it0.diag.pxx_norm, it1.diag.pxx_norm)


if __name__ == "__main__":
    pytest.main([__file__, "-v"])
