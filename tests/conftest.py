"""Test harness bootstrap.

Tests run on an 8-device virtual CPU mesh so multi-device semantics
are exercised without accelerator hardware (SURVEY.md section 4).  The
platform is forced through jax.config before any backend initializes.

Tiers (pyproject markers):
  * default — fast CPU-mesh tests (CI gate)
  * slow    — heavy statistical / e2e CPU tests
              (run with `-m slow` or no marker filter)

The checks that need the GPU itself are the phases of chip_smoke.py.
"""

import os

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture()
def low_cap(monkeypatch):
    """Cap the helix at 1024 steps for drain-equivalence tests (the
    10k default makes a full chunked-vs-monolithic comparison slow on
    the CPU).  The cap is a trace-time constant, so every segment
    cache and jit trace is cleared around the patch."""
    from montecarloscattering_jl_tpu.ops import fused_ion as fi
    from montecarloscattering_jl_tpu.ops import step as stp

    def clear():
        fi._XLA_HYBRID_CACHE.clear()
        stp.run_segment_jit.clear_cache()
        stp.run_segment_hjit.clear_cache()

    monkeypatch.setattr(stp, "MAX_HELIX_STEPS", 1024)
    clear()
    yield
    clear()
