"""The one compile-cache helper (`utils.cache.enable_compile_cache`) and
the GPU-only guards of the drivers."""

import argparse
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _record_updates(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    return calls


def test_cache_env_var_wins_and_sets_nothing(monkeypatch, tmp_path):
    from pmg_dolfinx_jax.utils import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_cache_defaults_to_repo_dir(monkeypatch):
    from pmg_dolfinx_jax.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    path = cache.enable_compile_cache(min_compile_secs=0.3)
    assert path == str(ROOT / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path),
                     ("jax_persistent_cache_min_compile_time_secs", 0.3)]
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def _python_files():
    """The checkout's Python files (git-ignored build output excluded)."""
    out = subprocess.run(
        ["git", "ls-files", "--cached", "--others", "--exclude-standard",
         "--", "*.py"],
        cwd=ROOT, capture_output=True, text=True,
    )
    if out.returncode == 0:
        return out.stdout.split()
    return [str(p.relative_to(ROOT)) for p in ROOT.rglob("*.py")
            if not any(part.startswith(".") for part in p.parts)]


def test_no_other_site_sets_the_cache():
    import re

    pat = re.compile(r"update\(\s*[\"']jax_compilation_cache_dir")
    files = [f for f in _python_files()
             if pat.search((ROOT / f).read_text())]
    assert files == ["pmg_dolfinx_jax/utils/cache.py"], files


def test_setup_jax_refuses_non_gpu_backend():
    sys.path.insert(0, str(ROOT / "examples"))
    from _common import setup_jax

    with pytest.raises(SystemExit, match="not 'gpu'"):
        setup_jax(argparse.Namespace(cpu=False, dtype="f32"))


@pytest.mark.parametrize("script,args", [
    ("pmg.py", ["--ndofs", "2000", "--degrees", "1", "3", "--pcg"]),
    ("unstructured.py", ["--demo-n", "2", "--degrees", "1", "3",
                         "--coarse", "amg"]),
])
def test_driver_without_gpu_or_cpu_flag_fails(script, args):
    import os

    r = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *args],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert r.returncode != 0
    assert "pass --cpu" in r.stderr
