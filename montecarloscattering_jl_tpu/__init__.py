"""Accelerator Monte Carlo diffusive-shock-acceleration framework.

A from-scratch JAX/XLA re-design of the capabilities of
abhro/MonteCarloScattering.jl (nonlinear DSA at 1-D parallel shocks
with nonthermal photon emission): structure-of-arrays particle batches,
masked-lane transport kernels, scatter-add phase-space tallies, and a
host-level nonlinear fixed point — not a translation of the serial
per-particle reference.

Subpackages
-----------
utils     constants, parameters, species, config, small solvers
models    grid / jump conditions / profile / injection / emission physics
ops       batched transport kernels and reductions
parallel  device-mesh sharding, collectives, checkpointing
engine    run orchestration (iterations, species, pcuts) and outputs
"""

__version__ = "0.1.0"
