"""Mid-iteration (segment-boundary) checkpoint / resume
(parallel/checkpoint.MidCheckpointer; SURVEY.md section 5.4).

The reference's restart was never implemented
(MonteCarloScattering.jl:462) and could at best restore iteration
boundaries; at scale one species' transport ladder is the long pole,
so the checkpoint has to cut INSIDE it.  These tests kill a run at a
segment boundary and verify the resumed run reproduces the
uninterrupted one bitwise on the host-split path, single-device and on
a device mesh; the fused ladders have no host-visible boundaries and
refuse a mid resume.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from montecarloscattering_jl_tpu.parallel.checkpoint import (
    MidCheckpointer, MidCheckpointStop, load_mid_checkpoint,
    is_mid_checkpoint, save_mid_checkpoint)


class TestSerialization:
    def test_payload_roundtrip_with_typed_keys(self, tmp_path):
        from montecarloscattering_jl_tpu.ops.finish import EscapeTallies
        p = str(tmp_path / "mid.ckpt")
        key = jax.random.key(42)
        esc = EscapeTallies.zeros(5, 4)
        payload = {
            "mode": "host", "next_seg": 3,
            "arr": np.arange(6, dtype=np.float64).reshape(2, 3),
            "dev": jnp.ones((4,), jnp.float32) * 1.5,
            "key": key, "esc": esc,
            "nested": {"t": (1, 2.5), "l": [np.zeros(2)]},
        }
        save_mid_checkpoint(p, payload)
        assert is_mid_checkpoint(p)
        back = load_mid_checkpoint(p)
        assert back["next_seg"] == 3
        np.testing.assert_array_equal(back["arr"], payload["arr"])
        np.testing.assert_array_equal(np.asarray(back["dev"]),
                                      np.asarray(payload["dev"]))
        # typed PRNG key roundtrips to the same key data
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(back["key"])),
            np.asarray(jax.random.key_data(key)))
        assert type(back["esc"]) is EscapeTallies
        assert back["nested"]["t"] == (1, 2.5)

    def test_npz_checkpoint_not_mid(self, tmp_path):
        p = str(tmp_path / "it.npz")
        np.savez(p, x=np.ones(3))
        assert not is_mid_checkpoint(p)

    def test_atomic_write_leaves_no_tmp(self, tmp_path):
        p = str(tmp_path / "mid.ckpt")
        save_mid_checkpoint(p, {"a": 1})
        assert not os.path.exists(p + ".tmp")


class TestCadence:
    def test_bucket_cadence(self, tmp_path):
        ck = MidCheckpointer(str(tmp_path / "m.ckpt"), every=3)
        for seg in range(1, 10):
            ck.maybe(seg, lambda: {})
        # fires once per cadence bucket: segments 3, 6, 9
        assert ck.n_saved == 3

    def test_unaligned_sync_points_still_fire(self, tmp_path):
        # hybrid sync points every 8 segments, cadence 5: buckets
        # advance at 8 (bucket 1), 16 (3), 24 (4)...
        ck = MidCheckpointer(str(tmp_path / "m.ckpt"), every=5)
        saves = []
        for seg in (8, 16, 24):
            ck.maybe(seg, lambda: {"s": saves.append(seg)})
        assert ck.n_saved == 3

    def test_reset_for_next_species(self, tmp_path):
        ck = MidCheckpointer(str(tmp_path / "m.ckpt"), every=4)
        ck.maybe(8, lambda: {})
        assert ck.n_saved == 1
        ck.reset()
        ck.maybe(4, lambda: {})
        assert ck.n_saved == 2

    def test_stop_after_save(self, tmp_path):
        ck = MidCheckpointer(str(tmp_path / "m.ckpt"), every=1,
                             stop_after_save=True)
        with pytest.raises(MidCheckpointStop):
            ck.maybe(1, lambda: {})


def _cfg():
    from montecarloscattering_jl_tpu.utils import load_config
    c = load_config("tests/data/dsa_nonrel.toml")
    c.n_itrs = 2
    return c


def _kill_at_first_mid(tmp_path, monkeypatch, **kw):
    """Run until the first segment-boundary checkpoint, then stop;
    returns (checkpoint path, mid path)."""
    from montecarloscattering_jl_tpu.engine import run

    ckpt = str(tmp_path / "ck.npz")
    monkeypatch.setenv("MCS_MID_STOP_AFTER", "1")
    with pytest.raises(MidCheckpointStop):
        run(_cfg(), checkpoint=ckpt, mid_every=2, **kw)
    monkeypatch.delenv("MCS_MID_STOP_AFTER")
    mid = ckpt + ".mid"
    assert os.path.exists(mid)
    peek = load_mid_checkpoint(mid)
    assert peek["mode"] == "host" and peek["next_seg"] == 2
    return ckpt, mid


def _assert_same_run(ref, res):
    assert res.n_pushes == ref.n_pushes
    assert res.n_trajectories == ref.n_trajectories
    assert len(res.iterations) == len(ref.iterations)
    a, b = ref.iterations[-1], res.iterations[-1]
    np.testing.assert_array_equal(a.profile_after.ux_sk,
                                  b.profile_after.ux_sk)
    for fa, fb in zip(a.ion_finals, b.ion_finals):
        np.testing.assert_array_equal(fa.psd, fb.psd)
        np.testing.assert_array_equal(fa.dndp_cr, fb.dndp_cr)
        np.testing.assert_array_equal(fa.zone_pop, fb.zone_pop)
    assert a.gamma_downstream == b.gamma_downstream
    assert a.q_esc_px == b.q_esc_px


@pytest.mark.slow
class TestKillAndResume:
    def test_host_split_bitwise(self, tmp_path, monkeypatch):
        """Kill at the first segment-boundary checkpoint of the run,
        resume, and compare every end-of-run product bitwise with the
        uninterrupted run (host-split path: the segment RNG key
        depends only on (seed, iter, ion, pcut), so a restored
        population continues on the identical trajectory set)."""
        from montecarloscattering_jl_tpu.engine import run

        ref = run(_cfg(), fused=False)
        ckpt, mid = _kill_at_first_mid(tmp_path, monkeypatch,
                                       fused=False)
        res = run(_cfg(), fused=False, checkpoint=ckpt, resume=mid,
                  mid_every=2)
        _assert_same_run(ref, res)

    def test_mesh_ladder_bitwise(self, tmp_path, monkeypatch):
        """The mesh ladder (--devices N) splits on the host too: a
        kill and resume on a 2-device mesh reproduces the
        uninterrupted mesh run."""
        from montecarloscattering_jl_tpu.engine import run
        from montecarloscattering_jl_tpu.parallel import make_mesh

        mesh = make_mesh(2)
        ref = run(_cfg(), mesh=mesh)
        ckpt, mid = _kill_at_first_mid(tmp_path, monkeypatch, mesh=mesh)
        res = run(_cfg(), mesh=mesh, checkpoint=ckpt, resume=mid,
                  mid_every=2)
        _assert_same_run(ref, res)

    def test_fused_ladder_refuses_mid_resume(self, tmp_path,
                                             monkeypatch):
        from montecarloscattering_jl_tpu.engine import run

        ckpt, mid = _kill_at_first_mid(tmp_path, monkeypatch,
                                       fused=False)
        with pytest.raises(ValueError, match="host-split loop"):
            run(_cfg(), checkpoint=ckpt, resume=mid, mid_every=2)


if __name__ == "__main__":
    pytest.main([__file__, "-v"])
