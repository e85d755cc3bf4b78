"""Transport kernels: batched helix stepping, tallies, reductions."""

from . import scattering, state, step, transforms  # noqa: F401
