"""Fused ion pass: all pcut segments of one species in ONE device
program.

The host-level pcut loop (cuts.jl:34-124 splitting between segments)
costs a device->host->device round trip per pcut (45 in the baseline).
Here the splitting runs on-device — compaction by stable sort on the
SAVED flag, replication by integer-divided lane indices — and a
lax.scan walks the pcut ladder, so one jit call transports a species
through every splitting level.  A pcut level with nothing saved leaves
an all-dead population and the remaining scan steps fall through in
O(1) while-loop iterations each (the reference's pcut_finalize break,
cuts.jl:115-119, without a host sync).

Used for single-device segments; the mesh path keeps host splitting so
lane placement (and therefore bitwise results) stay independent of the
mesh shape (tests/test_parallel.py).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .finish import EscapeTallies, finish_particles
from .state import ACTIVE, FINISHED, SAVED, ParticleState, Tallies
from .step import SegmentGrids, SegmentScalars, StepStatic, run_segment


def split_on_device(state: ParticleState, n_target, seg_key
                    ) -> tuple[ParticleState, jnp.ndarray]:
    """Build the next pcut population from SAVED lanes without leaving
    the device (new_pcut, cuts.jl:34-98; host twin: ops/cuts.py).

    Lane j of the new population replays saved lane ``j // i_mult``
    with weight / i_mult — the same interleaved layout np.repeat
    produces in the host splitter.  Returns (new state, n_new) where
    n_new = n_saved * i_mult; with nothing saved every lane comes out
    FINISHED with zero weight (and subsequent segments no-op).
    """
    b = state.weight.shape[0]
    saved = state.status == SAVED
    n_saved = jnp.sum(saved)
    # stable partition: saved lanes first, original order preserved
    order = jnp.argsort(~saved, stable=True)
    i_mult = jnp.maximum(n_target // jnp.maximum(n_saved, 1), 1)
    j = jnp.arange(b)
    src = order[jnp.minimum(j // i_mult, b - 1)]
    valid = j < n_saved * i_mult

    g = lambda a: a[src]
    p_dtype = state.pb.dtype
    lane_keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        seg_key, jnp.arange(b, dtype=jnp.uint32))

    new = ParticleState(
        weight=jnp.where(valid, g(state.weight) / i_mult,
                         0.0).astype(p_dtype),
        pb=g(state.pb), pperp=g(state.pperp), phi=g(state.phi),
        x=g(state.x), igrid=g(state.igrid), ux_prev=g(state.ux_prev),
        downstream=g(state.downstream), inj=g(state.inj),
        xn_per=g(state.xn_per),
        prp_x=g(state.prp_x),
        acctime=g(state.acctime), tcut=g(state.tcut),
        status=jnp.where(valid, ACTIVE, FINISHED).astype(jnp.int32),
        reason=jnp.zeros(b, jnp.int32),
        retro=jnp.zeros(b, bool),
        just_returned=jnp.zeros(b, bool),
        key=lane_keys,
        nsteps=jnp.zeros(b, jnp.int32),
        t_step=jnp.zeros(b, p_dtype),
    )
    return new, (n_saved * i_mult).astype(jnp.int32)


def run_ion_fused(state: ParticleState, tallies: Tallies,
                  esc: EscapeTallies, grids: SegmentGrids,
                  sc: SegmentScalars, ss: StepStatic,
                  pcuts, pcut_prevs, n_targets, seg_keys,
                  compact_levels: int = 0):
    """Transport one species through the whole pcut ladder.

    pcuts / pcut_prevs / n_targets / seg_keys are per-pcut arrays
    scanned over; tallies and escape tallies accumulate across segments
    (finalize_tallies' zone cumsum is linear, so summing difference
    arrays before the cumsum equals summing finalized tallies).

    Returns (state, tallies, esc, n_new[n_pcuts], nsteps[n_pcuts]).
    """

    def body(carry, xs):
        st, tl, es = carry
        pcut, pcut_prev, n_target, key = xs
        sci = sc._replace(pcut=pcut, pcut_prev=pcut_prev)
        st, tl = run_segment(st, tl, grids, sci, ss, compact_levels)
        es = finish_particles(st, es, grids, sci, ss)
        # uint64: per-lane caps are 1e4 and batches reach 1e6+ lanes,
        # so a segment's push count can exceed the uint32 range
        nsteps = jnp.sum(st.nsteps.astype(jnp.uint64))
        st, n_new = split_on_device(st, n_target, key)
        return (st, tl, es), (n_new, nsteps)

    (state, tallies, esc), (n_new, nsteps) = lax.scan(
        body, (state, tallies, esc),
        (pcuts, pcut_prevs, n_targets, seg_keys))
    return state, tallies, esc, n_new, nsteps


run_ion_fused_jit = jax.jit(run_ion_fused,
                            static_argnames=("ss", "compact_levels"),
                            donate_argnums=(0, 1, 2))


_XLA_HYBRID_CACHE = {}


def _get_xla_seg(ss, compact_levels: int):
    """One pcut segment as ONE jitted device program
    [run_segment -> finish -> split]."""
    key = (ss, compact_levels)
    if key in _XLA_HYBRID_CACHE:
        return _XLA_HYBRID_CACHE[key]

    def seg(st, tl, es, grids, sc, n_target, key):
        st, tl = run_segment(st, tl, grids, sc, ss, compact_levels)
        es = finish_particles(st, es, grids, sc, ss)
        nsteps = jnp.sum(st.nsteps.astype(jnp.uint64))
        st, n_new = split_on_device(st, n_target, key)
        return st, tl, es, n_new, nsteps

    f = jax.jit(seg, donate_argnums=(0, 1, 2))
    _XLA_HYBRID_CACHE[key] = f
    return f


def _get_xla_fin(ss):
    """[finish -> split] tail as its own program, for the
    host-chunked drain path (the drain runs via
    step.run_segment_chunked outside this program)."""
    key = ("fin", ss)
    if key in _XLA_HYBRID_CACHE:
        return _XLA_HYBRID_CACHE[key]

    def fin(st, es, grids, sc, n_target, key):
        es = finish_particles(st, es, grids, sc, ss)
        nsteps = jnp.sum(st.nsteps.astype(jnp.uint64))
        st, n_new = split_on_device(st, n_target, key)
        return st, es, n_new, nsteps

    f = jax.jit(fin, donate_argnums=(0, 1))
    _XLA_HYBRID_CACHE[key] = f
    return f


def drive_ladder_async(dispatch, n_seg: int, check=None):
    """Host loop over pcut segments WITHOUT a per-segment host sync:
    a blocking fetch drains the dispatch pipeline, so an
    int(n_new)-per-pcut loop would serialize [sync -> dispatch ->
    drain] once per segment.  The reference's pcut_finalize early
    break (cuts.jl:115-119) is instead checked every
    MCS_HYBRID_SYNC_EVERY segments (0 = never): a segment dispatched
    after the chain died is a cheap no-op — the split leaves every
    lane FINISHED with zero weight, the drain exits on its first trip,
    and finish_particles masks weight > 0 — so over-dispatching a few
    dead segments is cheaper than syncing on every live one.

    ``dispatch(i)`` runs segment i and returns (n_new, nsteps) device
    scalars (any integer/float dtype; pushes < 2^53 so the uint64
    conversion is exact).  ``check(i)`` (optional) runs at the sync
    points, after the pipeline has drained on int(n_new), so an
    in-flight failure check raises within MCS_HYBRID_SYNC_EVERY
    segments.

    Returns (n_new[n_seg] int64, nsteps[n_seg] uint64) with segments
    past the first die-out reported as the zeros they were."""
    sync_every = int(os.environ.get("MCS_HYBRID_SYNC_EVERY", "8"))
    n_new_d: list = []
    nsteps_d: list = []
    for i in range(n_seg):
        n_new, nsteps = dispatch(i)
        n_new_d.append(n_new)
        nsteps_d.append(nsteps)
        if sync_every and (i + 1) % sync_every == 0:
            dead = int(n_new) == 0
            if check is not None:
                check(i)
            if dead:
                break

    n_done = len(n_new_d)
    n_new_out = np.zeros(n_seg, np.int64)
    nsteps_out = np.zeros(n_seg, np.uint64)
    if n_new_d:
        n_new_out[:n_done] = np.asarray(jnp.stack(n_new_d), np.int64)
        nsteps_out[:n_done] = np.asarray(
            jnp.stack(nsteps_d)).astype(np.uint64)
    # report the same tail as the host splitter: segments past the
    # first die-out ran as no-ops and stay zero
    dead = np.flatnonzero(n_new_out[:n_done] == 0)
    if dead.size:
        n_new_out[dead[0] + 1:] = 0
        nsteps_out[dead[0] + 1:] = 0
    return n_new_out, nsteps_out


def run_ion_xla_hybrid(state, tallies, esc, grids, sc, ss,
                       pcuts, pcut_prevs, n_targets, seg_keys,
                       compact_levels: int = 0):
    """The whole pcut ladder as a host loop of per-segment device
    programs (one dispatch per pcut — negligible next to segment drain
    time), for batches above MCS_FUSED_MAX_BATCH where the engine does
    not build the whole-ladder lax.scan program.  Segments are
    async-dispatched through drive_ladder_async (chain-death break
    checked every MCS_HYBRID_SYNC_EVERY segments, dead segments are
    no-ops).  Returns (state, tallies, esc, n_new, nsteps)."""
    from .step import chunked_drain, run_segment_chunked

    # deep helix caps: host-chunked drains (no single device program
    # runs more than MCS_XLA_STEPS_PER_PROG while-trips)
    chunked = chunked_drain()
    if chunked:
        fin_fn = _get_xla_fin(ss)
    else:
        seg_fn = _get_xla_seg(ss, compact_levels)
    n_seg = len(pcuts)
    pcuts_h = np.asarray(pcuts, np.float64)
    prevs_h = np.asarray(pcut_prevs, np.float64)
    targets_h = np.asarray(n_targets, np.int64)
    p_dtype = state.pb.dtype

    def dispatch(i):
        nonlocal state, tallies, esc
        sci = sc._replace(
            pcut=jnp.asarray(pcuts_h[i], p_dtype),
            pcut_prev=jnp.asarray(prevs_h[i], p_dtype))
        if chunked:
            state, tallies = run_segment_chunked(
                state, tallies, grids, sci, ss, compact_levels)
            state, esc, n_new, nsteps = fin_fn(
                state, esc, grids, sci,
                jnp.asarray(targets_h[i], jnp.int32), seg_keys[i])
        else:
            state, tallies, esc, n_new, nsteps = seg_fn(
                state, tallies, esc, grids, sci,
                jnp.asarray(targets_h[i], jnp.int32), seg_keys[i])
        return n_new, nsteps

    n_new_out, nsteps_out = drive_ladder_async(dispatch, n_seg)
    return (state, tallies, esc, jnp.asarray(n_new_out),
            jnp.asarray(nsteps_out))
