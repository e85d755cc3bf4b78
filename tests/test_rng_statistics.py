"""Statistical validation of the 16-bit-uniform hot-path RNG.

The step kernel derives 8 uniforms per lane per step from the 16-bit
halves of 4 threefry words ((h + 0.5) / 2^16, resolution 1.5e-5 —
ops/step._lane_uniforms).  Round 1 argued this is far below any
physical sensitivity; these tests pin the claim against a 32-bit
control:

  * marginal uniformity of every slot (chi^2 over 64 bins),
  * scattering isotropy after repeated small-angle deflections
    (chi^2 on the pitch-cosine histogram, 16-bit vs 32-bit control),
  * P_ret acceptance rate at the Jones & Ellison (1991) return
    probability (binomial agreement with the exact value and with the
    32-bit control).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

from montecarloscattering_jl_tpu.ops.scattering import scattering
from montecarloscattering_jl_tpu.ops.step import _N_UNIFORM, _lane_uniforms

B = 4096
N_STEPS = 64


def _stream16(seed=0):
    """[steps, B, 8] uniforms exactly as the kernel draws them."""
    lane_keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.key(seed), jnp.arange(B, dtype=jnp.uint32))

    def at_step(n):
        st = SimpleNamespace(key=lane_keys,
                             nsteps=jnp.full(B, n, jnp.int32))
        return _lane_uniforms(st)

    return np.asarray(jax.vmap(at_step)(jnp.arange(N_STEPS)))


def _stream32(seed=0):
    """Control: full-precision uniforms from the same key discipline."""
    lane_keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.key(seed), jnp.arange(B, dtype=jnp.uint32))

    def at_step(n):
        keys = jax.vmap(jax.random.fold_in)(
            lane_keys, jnp.full(B, n, jnp.uint32))
        return jax.vmap(lambda k: jax.random.uniform(
            k, (_N_UNIFORM,), jnp.float32))(keys)

    return np.asarray(jax.vmap(at_step)(jnp.arange(N_STEPS)))


def _chi2_uniform(samples, nbins):
    """chi^2 statistic of samples in [0,1) against uniform."""
    counts, _ = np.histogram(samples, bins=nbins, range=(0.0, 1.0))
    exp = len(samples) / nbins
    return float(((counts - exp) ** 2 / exp).sum())


class TestUniforms16Bit:
    def test_marginal_uniformity_all_slots(self):
        u = _stream16()
        n = B * N_STEPS
        nbins = 64
        # chi^2_{63} has mean 63, sd ~11.2; 5 sigma ~ 119
        for slot in range(_N_UNIFORM):
            chi2 = _chi2_uniform(u[:, :, slot].ravel(), nbins)
            assert chi2 < 63 + 5 * np.sqrt(2 * 63), (slot, chi2)

    def test_scattering_isotropy_matches_32bit_control(self):
        """Repeated small-angle scattering isotropizes the pitch; the
        16-bit draws must produce a cos-theta histogram as uniform as
        the 32-bit control."""
        def isotropize(u_all):
            mc = 1.0
            ptot = jnp.ones(B)
            pb = ptot * 0.999          # start nearly field-aligned
            pperp = jnp.sqrt(ptot**2 - pb**2)
            phi = jnp.zeros(B)
            for n in range(N_STEPS):
                u = jnp.asarray(u_all[n])
                res = scattering(
                    u[:, 0], u[:, 1], pb, pperp, phi, ptot,
                    jnp.ones(B), jnp.full(B, 2000.0), jnp.ones(B),
                    jnp.asarray(False), 0.0, 1.0, 1.0, mc, 1.0,
                    cos_max=jnp.cos(jnp.sqrt(12 * jnp.pi / 20.0)))
                pb, pperp, phi = res.pb, res.pperp, res.phi
            return np.asarray(pb / ptot)

        chi2 = {}
        for name, stream in (("16bit", _stream16(7)),
                             ("32bit", _stream32(7))):
            mu = isotropize(stream)
            counts, _ = np.histogram(mu, bins=16, range=(-1.0, 1.0))
            exp = B / 16
            chi2[name] = ((counts - exp) ** 2 / exp).sum()
        # both must be consistent with isotropy (chi^2_15: 5 sigma ~ 42)
        assert chi2["16bit"] < 15 + 5 * np.sqrt(30), chi2
        assert chi2["32bit"] < 15 + 5 * np.sqrt(30), chi2

    def test_pret_acceptance_rate(self):
        """Acceptance of the return test u > P_ret must match the
        exact probability to binomial error, for both streams, down to
        a P_ret in the resolution-sensitive tail."""
        from montecarloscattering_jl_tpu.ops.step import _U_PRET
        for p_ret in (0.417, 0.9993):
            rates = {}
            for name, stream in (("16bit", _stream16(11)),
                                 ("32bit", _stream32(11))):
                u = stream[:, :, _U_PRET].ravel()
                rates[name] = float((u > p_ret).mean())
            n = B * N_STEPS
            exact = 1.0 - p_ret
            sigma = np.sqrt(exact * (1 - exact) / n)
            assert abs(rates["16bit"] - exact) < 5 * sigma, (p_ret, rates)
            assert abs(rates["32bit"] - exact) < 5 * sigma, (p_ret, rates)
            assert abs(rates["16bit"] - rates["32bit"]) < 7 * sigma, rates
