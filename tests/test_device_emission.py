"""Device-side emission kernels (models/emission/device.py) vs the
NumPy oracle, bin for bin, on a real electron+photon run's
distributions.
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def emission_pair():
    from montecarloscattering_jl_tpu.engine import run
    from montecarloscattering_jl_tpu.models.emission.driver import (
        photon_calcs)
    from montecarloscattering_jl_tpu.utils import load_config

    cfg = load_config("tests/data/electron_photon.toml")
    res = run(cfg)
    setup = res.setup
    prof = res.iterations[-1].profile_after
    finals = res.iterations[-1].ion_finals

    old = os.environ.get("MCS_EMISSION_DEVICE")
    try:
        os.environ["MCS_EMISSION_DEVICE"] = "0"
        em_np = photon_calcs(setup, prof, finals)
        os.environ["MCS_EMISSION_DEVICE"] = "1"
        em_dev = photon_calcs(setup, prof, finals)
    finally:
        if old is None:
            os.environ.pop("MCS_EMISSION_DEVICE", None)
        else:
            os.environ["MCS_EMISSION_DEVICE"] = old
    return em_np, em_dev


FIELDS = ["pion_grid", "synch_grid", "ic_grid", "pion_shell",
          "synch_shell", "ic_shell", "tot"]


class TestDeviceEmission:
    @pytest.mark.parametrize("field", FIELDS)
    def test_bin_for_bin(self, emission_pair, field):
        em_np, em_dev = emission_pair
        a = np.asarray(getattr(em_np, field), np.float64)
        b = np.asarray(getattr(em_dev, field), np.float64)
        assert a.shape == b.shape
        # identical support and values; the 1e-99 floors differ at the
        # absolute-zero level only (skipped zones vs computed-empty),
        # so compare above a floor well below any physical bin
        fa = np.maximum(a, 1e-80)
        fb = np.maximum(b, 1e-80)
        np.testing.assert_allclose(fb, fa, rtol=1e-5, atol=0.0,
                                   err_msg=field)

    def test_nontrivial(self, emission_pair):
        em_np, _ = emission_pair
        assert np.asarray(em_np.tot).max() > 1e-90


if __name__ == "__main__":
    pytest.main([__file__, "-v"])
