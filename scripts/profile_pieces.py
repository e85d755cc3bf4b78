"""Micro-profile of the helix-step cost pieces at production batch.

Times each structural piece of ops/step.helix_step standalone (256
fori iterations at 1M lanes, f32 momenta / f64 positions) so the
HBM-traffic budget is attributed with data instead of guesses.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

from montecarloscattering_jl_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import __graft_entry__ as ge  # noqa: E402
from montecarloscattering_jl_tpu.ops import state as stt  # noqa: E402
from montecarloscattering_jl_tpu.ops import step as stp  # noqa: E402

B = int(os.environ.get("MCS_PROF_BATCH", 1 << 20))
N = int(os.environ.get("MCS_PROF_STEPS", 256))


def timeit(name, fn, *args):
    f = jax.jit(fn)
    out = f(*args)
    jax.block_until_ready(out)
    best = np.inf
    for _ in range(3):
        t0 = time.time()
        out = f(*args)
        jax.block_until_ready(out)
        best = min(best, time.time() - t0)
    per_push = best / (B * N) * 1e9
    print(f"{name:34s} {best*1e3:8.1f} ms  {per_push:6.2f} ns/lane-step",
          flush=True)
    return best


def main():
    setup, state, tal, grids, sc, ss = ge._build(batch=B,
                                                 p_dtype=jnp.float32)

    def loop(body, carry):
        return lax_fori(body, carry)

    from jax import lax

    def fori(body, carry):
        return lax.fori_loop(0, N, body, carry)

    # 0. full step (reference)
    def full(c):
        def body(i, c):
            s, t = c
            return stp.helix_step(s, t, grids, sc, ss)
        return fori(body, c)
    timeit("full helix_step", full, (state, tal))

    # 1. RNG only
    def rng_only(s):
        def body(i, s):
            u = stp._lane_uniforms(s)
            return s._replace(pb=s.pb + u[:, 0].astype(s.pb.dtype),
                              nsteps=s.nsteps + 1)
        return fori(body, s)
    timeit("lane uniforms (threefry)", rng_only, state)

    # 2. zone one-hot gather only
    zstack = jnp.stack([grids.ux, grids.uz, grids.utot, grids.gamma_sf,
                        grids.gamma_ef, grids.btot, grids.b_cos,
                        grids.b_sin], axis=1)

    def gather_only(s):
        def body(i, s):
            oh = jax.nn.one_hot(s.igrid, ss.nb, dtype=zstack.dtype)
            zf = jnp.einsum("bn,nf->bf", oh, zstack,
                            preferred_element_type=zstack.dtype)
            return s._replace(pb=s.pb + zf[:, 0], nsteps=s.nsteps + 1)
        return fori(body, s)
    timeit("zone one-hot gather", gather_only, state)

    # 3. zone compare lookup only
    def lookup_only(s):
        def body(i, s):
            ig = (jnp.sum(s.x[:, None] >= grids.x_grid[None, :],
                          axis=1).astype(jnp.int32) - 1)
            return s._replace(igrid=jnp.clip(ig, 0, ss.nb - 2),
                              x=s.x + 1.0, nsteps=s.nsteps + 1)
        return fori(body, s)
    timeit("zone compare lookup (f64 x)", lookup_only, state)

    # 4. record write + flush cadence only
    def rec_only(c):
        s, t = c
        def body(i, c):
            s, t = c
            chunk = t.rec.shape[0]
            phase = jnp.mod(t.step_phase, chunk)
            rec = jnp.stack([s.pb.astype(t.rec.dtype)] * 8)
            t = t._replace(rec=t.rec.at[phase].set(rec),
                           step_phase=t.step_phase + 1)
            t = lax.cond(phase == chunk - 1,
                         lambda t: stp._flush_records(t, ss),
                         lambda t: t, t)
            return (s._replace(nsteps=s.nsteps + 1), t)
        return fori(body, c)
    timeit("rec write + flush", rec_only, (state, tal))

    # 5. elementwise movement+scatter shaped math only
    def math_only(s):
        def body(i, s):
            pb, pperp, phi, x = s.pb, s.pperp, s.phi, s.x
            ptot = jnp.hypot(pb, pperp)
            g = jnp.hypot(ptot / (sc.m * 3e10), 1.0)
            cn = pb / jnp.maximum(ptot, 1e-30) * 0.99
            sn = jnp.sqrt(jnp.maximum(1 - cn * cn, 0.0))
            pb = ptot * cn
            pperp = ptot * sn
            phi = jnp.mod(phi + 0.1, 2 * jnp.pi)
            dx = (pb / (g * sc.m) * 1e-4 + jnp.cos(phi)).astype(jnp.float64)
            return s._replace(pb=pb, pperp=pperp, phi=phi, x=x + dx,
                              nsteps=s.nsteps + 1)
        return fori(body, s)
    timeit("elementwise physics proxy", math_only, state)


if __name__ == "__main__":
    main()


def flush_variants():
    """Finer attribution inside the flush + candidate replacements."""
    from jax import lax
    setup, state, tal, grids, sc, ss = ge._build(batch=B,
                                                 p_dtype=jnp.float32)
    chunk = tal.rec.shape[0]
    rec = jnp.ones((chunk, 8, B), tal.rec.dtype)
    nzc = ss.nb + 1

    # (a) rec write only, no flush
    def rec_write(c):
        s, t = c
        def body(i, c):
            s, t = c
            phase = jnp.mod(t.step_phase, chunk)
            r = jnp.stack([s.pb.astype(t.rec.dtype)] * 8)
            t = t._replace(rec=t.rec.at[phase].set(r),
                           step_phase=t.step_phase + 1)
            return (s._replace(nsteps=s.nsteps + 1), t)
        return lax.fori_loop(0, N, body, c)
    timeit("rec write only", rec_write, (state, tal))

    # (b) flux one-hot contraction per flush (amortized)
    def flux_onehot(t):
        def body(i, t):
            lo = t.rec[:, 5, :].reshape(-1).astype(jnp.int32)
            hi = t.rec[:, 6, :].reshape(-1).astype(jnp.int32)
            dt_ = t.rec.dtype
            oh = (jax.nn.one_hot(lo, nzc, dtype=dt_)
                  - jax.nn.one_hot(hi + 1, nzc, dtype=dt_))
            vals = jnp.moveaxis(t.rec[:, :4, :], 1, 0).reshape(4, -1)
            delta = jnp.einsum("cb,bn->cn", vals, oh,
                               preferred_element_type=dt_)
            return t._replace(
                flux_diff=t.flux_diff + delta.astype(jnp.float64))
        return lax.fori_loop(0, N // chunk, body, t)
    timeit("flux one-hot f32 (per flush)", flux_onehot,
           tal._replace(rec=rec))

    # (c) same in bf16
    def flux_onehot_bf16(t):
        def body(i, t):
            lo = t.rec[:, 5, :].reshape(-1).astype(jnp.int32)
            hi = t.rec[:, 6, :].reshape(-1).astype(jnp.int32)
            oh = (jax.nn.one_hot(lo, nzc, dtype=jnp.bfloat16)
                  - jax.nn.one_hot(hi + 1, nzc, dtype=jnp.bfloat16))
            vals = jnp.moveaxis(t.rec[:, :4, :], 1, 0).reshape(
                4, -1).astype(jnp.bfloat16)
            delta = jnp.einsum("cb,bn->cn", vals, oh,
                               preferred_element_type=jnp.float32)
            return t._replace(
                flux_diff=t.flux_diff + delta.astype(jnp.float64))
        return lax.fori_loop(0, N // chunk, body, t)
    timeit("flux one-hot bf16 (per flush)", flux_onehot_bf16,
           tal._replace(rec=rec))

    # (d) scatter-add instead of one-hot
    def flux_scatter(t):
        def body(i, t):
            lo = t.rec[:, 5, :].reshape(-1).astype(jnp.int32)
            hi = t.rec[:, 6, :].reshape(-1).astype(jnp.int32)
            vals = jnp.moveaxis(t.rec[:, :4, :], 1, 0).reshape(4, -1)
            fd = t.flux_diff
            fd = fd.at[:, lo].add(vals.astype(jnp.float64))
            fd = fd.at[:, hi + 1].add(-vals.astype(jnp.float64))
            return t._replace(flux_diff=fd)
        return lax.fori_loop(0, N // chunk, body, t)
    timeit("flux scatter-add (per flush)", flux_scatter,
           tal._replace(rec=rec))

    # (e) psd flattened scatter per flush
    psd_flat0 = tal.psd_diff.reshape(-1)
    def psd_scatter(t):
        def body(i, carry):
            pf = carry
            lo = t.rec[:, 5, :].reshape(-1).astype(jnp.int32)
            hi = t.rec[:, 6, :].reshape(-1).astype(jnp.int32)
            base = t.rec[:, 7, :].reshape(-1).astype(jnp.int32)
            w = t.rec[:, 4, :].reshape(-1).astype(pf.dtype)
            pf = pf.at[base + lo].add(w)
            pf = pf.at[base + hi + 1].add(-w)
            return pf
        return lax.fori_loop(0, N // chunk, body, psd_flat0)
    timeit("psd scatter (per flush)", psd_scatter,
           tal._replace(rec=rec))


if __name__ == "__main__" and os.environ.get("MCS_PROF_FLUSH"):
    flush_variants()
