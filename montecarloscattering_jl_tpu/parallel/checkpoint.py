"""Checkpoint / resume of a run's nonlinear state.

The reference designed but never implemented profile restart
(read-old-profile reaches an error, MonteCarloScattering.jl:462;
SURVEY.md section 5.4).  Two granularities:

* **Iteration-boundary** (save_checkpoint/load_checkpoint): the full
  fixed-point state — profile grids, adiabatic-index grid, q_esc /
  escape histories, iteration index, and RNG base seed — in a single
  NPZ, resumable on a different mesh shape (tallies are per-iteration
  and rebuilt, so only O(n_grid) state is stored).

* **Mid-iteration / segment-boundary** (save_mid_checkpoint +
  MidCheckpointer): everything an in-flight species needs — the live
  particle population (including per-lane RNG key/step counters, the
  determinism anchor per SURVEY.md section 5.2), the pcut segment
  index, the per-ion tally accumulators, the iteration tallies, and
  the completed species' reduction products — so a run whose long
  pole is ONE species' transport ladder can resume inside it.  Segment
  boundaries are the natural cut: state is host-visible there on the
  host-split path.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle

import numpy as np

from ..models.profile import ShockProfile


def save_checkpoint(path: str, *, i_iter: int, profile: ShockProfile,
                    gamma_grid: np.ndarray, q_px_hist: np.ndarray,
                    q_en_hist: np.ndarray, px_esc_hist: np.ndarray,
                    en_esc_hist: np.ndarray, gamma_dw_hist: np.ndarray,
                    prof_weight_fac: float, random_seed: int,
                    meta: dict | None = None) -> None:
    np.savez_compressed(
        path,
        i_iter=np.asarray(i_iter),
        ux_sk=profile.ux_sk, uz_sk=profile.uz_sk, utot=profile.utot,
        gamma_sf=profile.gamma_sf, beta_ef=profile.beta_ef,
        gamma_ef=profile.gamma_ef, btot=profile.btot,
        theta=profile.theta, eps_b=profile.eps_b,
        bmag2=np.asarray(profile.bmag2),
        gamma_grid=gamma_grid,
        q_px_hist=q_px_hist, q_en_hist=q_en_hist,
        px_esc_hist=px_esc_hist, en_esc_hist=en_esc_hist,
        gamma_dw_hist=gamma_dw_hist,
        prof_weight_fac=np.asarray(prof_weight_fac),
        random_seed=np.asarray(random_seed),
        meta=np.frombuffer(
            json.dumps(meta or {}).encode(), dtype=np.uint8),
    )


def load_checkpoint(path: str) -> dict:
    """Load a checkpoint; returns a dict with a reconstructed
    ShockProfile under 'profile'."""
    z = np.load(path)
    prof = ShockProfile(
        ux_sk=z["ux_sk"], uz_sk=z["uz_sk"], utot=z["utot"],
        gamma_sf=z["gamma_sf"], beta_ef=z["beta_ef"],
        gamma_ef=z["gamma_ef"], btot=z["btot"], theta=z["theta"],
        eps_b=z["eps_b"], bmag2=float(z["bmag2"]))
    meta = json.loads(bytes(z["meta"]).decode() or "{}")
    return {
        "i_iter": int(z["i_iter"]), "profile": prof,
        "gamma_grid": z["gamma_grid"],
        "q_px_hist": z["q_px_hist"], "q_en_hist": z["q_en_hist"],
        "px_esc_hist": z["px_esc_hist"], "en_esc_hist": z["en_esc_hist"],
        "gamma_dw_hist": z["gamma_dw_hist"],
        "prof_weight_fac": float(z["prof_weight_fac"]),
        "random_seed": int(z["random_seed"]), "meta": meta,
    }


# ---- mid-iteration (segment-boundary) checkpoints ----------------------


class _KeyLeaf:
    """Pickle-safe stand-in for a jax typed PRNG key array (typed keys
    reject np.asarray; raw key data roundtrips exactly)."""

    __slots__ = ("data", "impl")

    def __init__(self, data: np.ndarray, impl: str):
        self.data = data
        self.impl = impl


def _walk(obj, leaf):
    """Structure-preserving deep map over the container shapes a mid
    checkpoint payload uses: dict / list / tuple / NamedTuple /
    dataclass; everything else goes through ``leaf``."""
    if isinstance(obj, dict):
        return {k: _walk(v, leaf) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_walk(v, leaf) for v in obj]
    if isinstance(obj, tuple):
        vals = [_walk(v, leaf) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") \
            else tuple(vals)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return type(obj)(**{f.name: _walk(getattr(obj, f.name), leaf)
                            for f in dataclasses.fields(obj)})
    return leaf(obj)


def _to_host(obj):
    import jax

    def leaf(x):
        if isinstance(x, jax.Array):
            if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key):
                impl = str(jax.random.key_impl(x))
                return _KeyLeaf(np.asarray(jax.random.key_data(x)),
                                impl)
            return np.asarray(x)
        return x

    return _walk(obj, leaf)


def _restore_keys(obj):
    import jax

    def leaf(x):
        if isinstance(x, _KeyLeaf):
            return jax.random.wrap_key_data(
                jax.numpy.asarray(x.data), impl=x.impl)
        return x

    return _walk(obj, leaf)


def save_mid_checkpoint(path: str, payload: dict) -> None:
    """Atomically persist a segment-boundary payload (see
    MidCheckpointer).  Device arrays are fetched; typed PRNG keys are
    stored as raw key data.  Write is tmp-file + rename so a kill
    during the save leaves the previous checkpoint intact."""
    host = _to_host(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(host, f, protocol=4)
    os.replace(tmp, path)


def load_mid_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return _restore_keys(pickle.load(f))


def is_mid_checkpoint(path: str) -> bool:
    """Mid checkpoints are pickles (magic \\x80); iteration-boundary
    checkpoints are NPZ (zip magic PK)."""
    with open(path, "rb") as f:
        return f.read(2) == b"\x80\x04"


class MidCheckpointStop(Exception):
    """Raised by MidCheckpointer(stop_after_save=True) right after a
    save — the kill-and-resume test hook."""


class MidCheckpointer:
    """Segment-cadence mid-iteration checkpoint writer.

    The engine calls ``maybe(segments_done, payload_fn)`` at every
    segment boundary it can capture; the payload (which may force a
    device fetch) is only built when the cadence hits.  ``context_fn``
    is installed by the driver before each species and supplies the
    driver-level half of the payload (profile, histories, completed
    species' IonFinals, iteration tallies)."""

    def __init__(self, path: str, every: int = 8,
                 stop_after_save: bool = False):
        self.path = path
        self.every = max(int(every), 1)
        self.stop_after_save = stop_after_save
        self.context_fn = None
        self.n_saved = 0
        self._bucket = 0

    def reset(self, seg_done: int = 0) -> None:
        """Start a new species ladder (optionally resumed at
        ``seg_done`` segments already complete)."""
        self._bucket = seg_done // self.every

    def maybe(self, seg_done: int, payload_fn) -> None:
        """Save when ``seg_done`` first reaches or passes a cadence
        multiple.  Capture points need not align with ``every`` (the
        hybrid ladder only drains at its sync points), so this fires
        on bucket advance rather than exact multiples."""
        bucket = seg_done // self.every
        if bucket <= self._bucket:
            return
        self._bucket = bucket
        payload = dict(payload_fn())
        if self.context_fn is not None:
            payload["driver"] = self.context_fn()
        save_mid_checkpoint(self.path, payload)
        self.n_saved += 1
        if self.stop_after_save:
            raise MidCheckpointStop(self.path)
