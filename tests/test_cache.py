"""The compilation-cache rule (tpu_huffman/cache.py)."""

import os

from tpu_huffman import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _recorder(monkeypatch):
    import jax

    calls = {}
    monkeypatch.setattr(
        jax.config, "update", lambda name, value: calls.__setitem__(name, value)
    )
    return calls


def test_default_dir_inside_checkout_and_ignored(monkeypatch):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    assert cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_enable_sets_no_dir_when_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    calls = _recorder(monkeypatch)
    assert cache.enable() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls


def test_enable_sets_default_dir(monkeypatch):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    calls = _recorder(monkeypatch)
    assert cache.enable() == cache.DEFAULT_DIR
    assert calls["jax_compilation_cache_dir"] == cache.DEFAULT_DIR


def test_no_hard_coded_cache_paths():
    """Entry points use the helper: no other file names a cache directory."""
    hits = []
    for root in (REPO, os.path.join(REPO, "tpu_huffman"),
                 os.path.join(REPO, "tests"), os.path.join(REPO, "scripts")):
        for name in os.listdir(root):
            path = os.path.join(root, name)
            if not name.endswith(".py") or path == cache.__file__:
                continue
            with open(path) as f:
                if '"jax_compilation_cache_dir"' in f.read():
                    hits.append(path)
    assert hits == [os.path.join(REPO, "tests", "test_cache.py")]
