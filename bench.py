"""Transport throughput benchmark on the local GPU.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", ...}
that names the device it ran on (platform, device kind, count, and the
card's name and power limit from nvidia-smi).  It refuses to run when
JAX finds no GPU: a CPU number is never reported as a device metric.

Headline metric: particle pushes/sec over a DRAIN-TO-EMPTY transport
segment (a full pcut segment of the nonrelativistic DSA workload run
until every lane is saved or finished, with live-lane compaction).
Alongside it:
  * "kernel_window_pushes_per_sec": a fixed 256-step window with all
    lanes starting active;
  * "ladder_pushes_per_sec": one species through the whole pcut
    ladder via TransportEngine.run_ion (transport, on-device splits,
    escape binning), on the ladder the engine selects for the batch
    ("ladder" names it).

Pushes are counted from the actual per-lane step counters (sum of
nsteps), never from batch x steps, so lanes that finish early are not
credited.

The reference publishes no numbers (BASELINE.json "published": {});
vs_baseline is measured against a documented estimate of the serial
Julia reference at 2e6 pushes/s/core (a per-particle loop doing the
same transforms + RNG + trig per step).
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from montecarloscattering_jl_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)

REFERENCE_SERIAL_PUSHES_PER_SEC = 2.0e6   # documented estimate, see above
BATCH = int(os.environ.get("MCS_BENCH_BATCH", 1048576))
DRAIN_BATCH = int(os.environ.get("MCS_BENCH_DRAIN_BATCH", 262144))
N_STEPS = int(os.environ.get("MCS_BENCH_STEPS", 256))
P_DTYPE = (jnp.float32 if os.environ.get("MCS_BENCH_DTYPE", "f32") == "f32"
           else jnp.float64)


def _auto_levels(b: int) -> int:
    levels = 0
    while b > 4096 and b % 256 == 0:
        b //= 2
        levels += 1
    return levels


def _nvidia_smi() -> str:
    """Card name and power limit (queried before JAX opens the card)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return r.stdout.strip()


def main() -> int:
    smi = _nvidia_smi()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU visible to JAX ({dev.platform}); refusing "
              "to report a device metric", file=sys.stderr)
        return 1
    enable_compile_cache()

    from montecarloscattering_jl_tpu.engine.run import TransportEngine
    from montecarloscattering_jl_tpu.engine.setup import build_setup
    from montecarloscattering_jl_tpu.models.injection import init_pop
    from montecarloscattering_jl_tpu.ops import state as stt
    from montecarloscattering_jl_tpu.ops import step as stp
    from montecarloscattering_jl_tpu.utils import load_config

    cfg = load_config(os.path.join(os.path.dirname(__file__), "tests",
                                   "data", "dsa_nonrel.toml"))
    setup = build_setup(cfg)
    eng = TransportEngine(setup, p_dtype=P_DTYPE)
    prof = setup.profile
    grids = eng.segment_grids(prof)
    sc = eng.segment_scalars(0, 2, prof.bmag2)
    ss = eng.step_static(0)

    rng = np.random.default_rng(0)
    pop = init_pop(rng, cfg.species, 0, 1, cfg.energy_inj, True,
                   cfg.n_pts_inj, setup.x_grid_start, cfg.rg0, 1.0,
                   True, -1.0, cfg.beta0, cfg.gamma0, cfg.u0,
                   setup.x_grid_rg, prof.ux_sk, prof.gamma_sf)

    def fresh(seed, batch):
        reps = batch // len(pop.ptot_pf) + 1
        t = lambda a: np.tile(a, reps)[:batch]
        return stt.init_state(
            t(pop.weight), t(pop.ptot_pf), t(pop.pb_pf), t(pop.x_cm),
            t(pop.i_grid).astype(np.int32), t(prof.ux_sk[pop.i_grid]),
            cfg.xn_per_fine, setup.x_grid_stop, jax.random.key(seed),
            p_dtype=P_DTYPE)

    def fresh_tal(batch):
        return stt.make_tallies(setup.nb, setup.bins.n_mom,
                                setup.bins.n_theta, 0, 0, jnp.float32,
                                batch=batch,
                                chunk=int(os.environ.get("MCS_BENCH_CHUNK", 8)),
                                p_dtype=P_DTYPE)

    # ---- fixed-window kernel rate (all lanes active) -----------------------
    def steps(state, tal):
        def body(i, c):
            s, tl = c
            return stp.helix_step(s, tl, grids, sc, ss)
        return jax.lax.fori_loop(0, N_STEPS, body, (state, tal))

    stepsj = jax.jit(steps, donate_argnums=(0, 1))
    out = stepsj(fresh(0, BATCH), fresh_tal(BATCH))
    jax.block_until_ready(out)           # compile + warm

    kernel_rate = 0.0
    for i in range(3):
        s_in, t_in = fresh(i + 1, BATCH), fresh_tal(BATCH)
        t0 = time.time()
        s_out, _ = stepsj(s_in, t_in)
        pushes = int(np.asarray(s_out.nsteps, np.int64).sum())
        dt = time.time() - t0
        kernel_rate = max(kernel_rate, pushes / dt)

    # ---- drain-to-empty segment rate (the e2e number) ----------------------
    levels = int(os.environ.get("MCS_BENCH_COMPACT",
                                _auto_levels(DRAIN_BATCH)))
    s_out, _ = stp.run_segment_jit(fresh(0, DRAIN_BATCH),
                                   fresh_tal(DRAIN_BATCH), grids, sc, ss,
                                   levels)
    jax.block_until_ready(s_out)         # compile + warm

    drain_rate, drain_pushes = 0.0, 0
    n_rep = int(os.environ.get("MCS_BENCH_DRAIN_REPS", 2))
    for i in range(n_rep):
        s_in, t_in = fresh(i + 1, DRAIN_BATCH), fresh_tal(DRAIN_BATCH)
        t0 = time.time()
        s_out, _ = stp.run_segment_jit(s_in, t_in, grids, sc, ss, levels)
        jax.block_until_ready(s_out.nsteps)
        pushes = int(np.asarray(s_out.nsteps, np.int64).sum())
        dt = time.time() - t0
        if pushes / dt > drain_rate:
            drain_rate, drain_pushes = pushes / dt, pushes

    # ---- full pcut-ladder rate (transport + splits + escape binning) -------
    # the sustained number a production species pass sees, through the
    # ladder TransportEngine.run_ion selects at this batch
    cfg.n_pts_inj = cfg.n_pts_pcut = cfg.n_pts_pcut_hi = DRAIN_BATCH
    ladder_setup = build_setup(cfg)
    ladder_eng = TransportEngine(ladder_setup, p_dtype=P_DTYPE)

    def ladder(i_iter):
        it = ladder_eng.new_iteration_tallies()
        res = ladder_eng.run_ion(i_iter, 0, ladder_setup.profile, it)
        jax.block_until_ready(res.psd)
        return res.n_pushes

    ladder(0)                            # compile + warm
    ladder_rate = 0.0
    for i in range(2):
        t0 = time.time()
        pushes = ladder(i + 1)
        ladder_rate = max(ladder_rate, pushes / (time.time() - t0))

    print(json.dumps({
        "metric": "drain_to_empty_pushes_per_sec",
        "value": round(drain_rate, 1),
        "unit": "pushes/s",
        "vs_baseline": round(drain_rate / REFERENCE_SERIAL_PUSHES_PER_SEC, 3),
        "kernel_window_pushes_per_sec": round(kernel_rate, 1),
        "kernel_window_batch": BATCH,
        "drain_batch": DRAIN_BATCH,
        "drain_pushes": drain_pushes,
        "ladder_pushes_per_sec": round(ladder_rate, 1),
        "ladder": ladder_eng.ladder_path(),
        "n_pcuts": len(cfg.pcuts),
        "compact_levels": levels,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "nvidia_smi": smi},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
