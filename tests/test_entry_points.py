"""Entry-point settings: the CLI's platform choices, where the
persistent compilation cache lives, and chip_smoke.py's refusal to run
without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from montecarloscattering_jl_tpu.__main__ import JAX_PLATFORMS, build_parser
from montecarloscattering_jl_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestPlatformChoices:
    @pytest.mark.parametrize("platform", ["gpu", "cpu", "default"])
    def test_accepted(self, platform):
        args = build_parser().parse_args(["cfg.toml", "--platform",
                                          platform])
        assert args.platform == platform
        # the name JAX's backend registry knows ("gpu" is not one)
        assert JAX_PLATFORMS.get(platform, "default") in (
            "cuda", "cpu", "default")

    @pytest.mark.parametrize("argv", [["--platform", "tpu"],
                                      ["--cache-dir", "/tmp/x"]])
    def test_rejected(self, argv, capsys):
        with pytest.raises(SystemExit) as e:
            build_parser().parse_args(["cfg.toml"] + argv)
        assert e.value.code == 2


class TestCompileCache:
    @pytest.fixture(autouse=True)
    def _restore_config(self):
        old = jax.config.jax_compilation_cache_dir
        yield
        jax.config.update("jax_compilation_cache_dir", old)

    def test_env_var_wins_and_nothing_is_set(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_fixed_in_checkout_path(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.isdir(path)
        # listed in .gitignore: the cache is never committed
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


class TestChipSmokeGuard:
    def test_refuses_cpu_only_process(self):
        r = _run_smoke(REPO)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
        assert "no GPU" in r.stderr

    def test_refuses_without_the_repo(self, tmp_path):
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        r = _run_smoke(str(tmp_path))
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
