"""The persistent cache of the port's kernel libraries
(``repro_torch/core/compile_cache.py``), the counterpart of the reference's
``repro/core/compile_cache.py``: the directory from the argument or
``REPRO_COMPILE_CACHE``, idempotence, the entries, the hit and miss
counting of ``kernels/build.py`` (libraries placed by hand and a stand-in
for ``nvcc``: this host has none), ``jit_cache_stats`` with the
reference's four keys, and ``train --compile-cache``."""
import types

import pytest

import repro.core as jcore
from repro_torch.core import compile_cache_stats, enable_compile_cache
from repro_torch.core import compile_cache as tcc
from repro_torch.kernels import build
from repro_torch.launch import train as ttrain
from repro_torch.telemetry import jit_cache_stats
from _torch_threads import one_thread  # noqa: F401

KEYS = {"persistent_cache_dir", "persistent_cache_entries", "persistent_cache_hits",
        "persistent_cache_misses"}


@pytest.fixture(autouse=True)
def fresh_build_state(monkeypatch):
    """The build module's directory and counters as a new process has them,
    restored after the test; no ``REPRO_COMPILE_CACHE`` from outside."""
    monkeypatch.setattr(build, "BUILD_DIR", build.DEFAULT_BUILD_DIR)
    monkeypatch.setattr(build, "CACHE", {"hits": 0, "misses": 0})
    monkeypatch.setattr(build, "_LOOKED_UP", set())
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "BUILD_SECONDS", {})
    monkeypatch.delenv(tcc.ENV_VAR, raising=False)


def _place(name: str) -> None:
    """A library of ``name`` in the build directory, as a build leaves it."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.library_path(name)
    path.write_bytes(b"")
    path.with_suffix(".log").write_text(f"ptxas log of {name}")


def test_the_keys_are_the_reference_s():
    assert tcc.ENV_VAR == "REPRO_COMPILE_CACHE"
    assert set(compile_cache_stats()) == KEYS == set(jcore.compile_cache_stats())
    assert KEYS <= set(jit_cache_stats())


def test_unset_is_a_no_op():
    assert enable_compile_cache() is None
    assert build.BUILD_DIR == build.DEFAULT_BUILD_DIR
    assert compile_cache_stats()["persistent_cache_dir"] == str(build.DEFAULT_BUILD_DIR)


def test_env_fallback_and_the_argument_first(tmp_path, monkeypatch):
    env, arg = tmp_path / "env", tmp_path / "arg"
    monkeypatch.setenv(tcc.ENV_VAR, str(env))
    assert enable_compile_cache() == str(env)
    assert build.BUILD_DIR == env and env.is_dir()
    assert enable_compile_cache(str(arg)) == str(arg)
    assert build.BUILD_DIR == arg


def test_idempotent(tmp_path):
    d = str(tmp_path / "cache")
    first = enable_compile_cache(d)
    _place("tamper_check")
    before = compile_cache_stats()
    assert enable_compile_cache(d) == first == d
    assert compile_cache_stats() == before
    assert before == {"persistent_cache_dir": d, "persistent_cache_entries": 1,
                      "persistent_cache_hits": 0, "persistent_cache_misses": 0}


def test_entries_count_libraries_only(tmp_path):
    enable_compile_cache(str(tmp_path))
    for name in ("tamper_check", "quant_exchange", "fused_xent"):
        _place(name)
    # a build cut short leaves a temporary file, never a library
    build._tmp_path("flash_attention").write_bytes(b"")
    (tmp_path / "notes").mkdir()
    assert compile_cache_stats()["persistent_cache_entries"] == 3


def test_hits_and_misses_once_a_library_a_process(tmp_path, monkeypatch):
    """build_all finds the libraries placed by hand (hits) and builds the
    others (misses); a second build_all and the loads after it count
    nothing more; a library built by one process is a hit for the next."""
    enable_compile_cache(str(tmp_path))
    names = sorted(build.SOURCES)
    built = names[:2]
    for name in names[2:]:
        _place(name)
    started = []

    def start(name):
        started.append(name)
        return types.SimpleNamespace(poll=lambda: 0, name=name)

    def finish(name, proc):
        _place(name)

    monkeypatch.setattr(build, "_start", start)
    monkeypatch.setattr(build, "_finish", finish)
    logs = build.build_all()
    assert sorted(logs) == names and started == built
    assert build.CACHE == {"hits": len(names) - 2, "misses": 2}
    build.build_all()

    class FakeLib:
        def __getattr__(self, fn):
            f = types.SimpleNamespace()
            setattr(self, fn, f)
            return f

    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: FakeLib())
    for name in names:
        build.load(name)
    assert started == built
    stats = compile_cache_stats()
    assert stats == {"persistent_cache_dir": str(tmp_path),
                     "persistent_cache_entries": len(names),
                     "persistent_cache_hits": len(names) - 2, "persistent_cache_misses": 2}
    # the next process: every library a hit, nothing built
    monkeypatch.setattr(build, "CACHE", {"hits": 0, "misses": 0})
    monkeypatch.setattr(build, "_LOOKED_UP", set())
    monkeypatch.setattr(build, "_LOADED", {})
    build.load(names[0])
    build.build_all()
    assert started == built
    assert build.CACHE == {"hits": len(names), "misses": 0}
    assert {k: jit_cache_stats()[k] for k in KEYS} == compile_cache_stats()


def test_load_builds_a_missing_library_as_a_miss(tmp_path, monkeypatch):
    enable_compile_cache(str(tmp_path))
    monkeypatch.setattr(build, "_start", lambda name: name)
    monkeypatch.setattr(build, "_finish", lambda name, proc: _place(name))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: types.SimpleNamespace(
        **{fn: types.SimpleNamespace() for fn in build.SOURCES["tamper_check"]}))
    build.load("tamper_check")
    assert build.CACHE == {"hits": 0, "misses": 1}
    assert compile_cache_stats()["persistent_cache_entries"] == 1


@pytest.mark.parametrize("how", ["flag", "env"])
def test_train_cli_puts_the_libraries_in_the_cache(how, tmp_path, monkeypatch, capsys):
    d = str(tmp_path / how)
    if how == "env":
        monkeypatch.setenv(tcc.ENV_VAR, d)
    flags = ["--compile-cache", d] if how == "flag" else []
    ttrain.main(["--device", "cpu", "--task", "mnist", "--rounds", "1", "--local-steps", "1",
                 *flags])
    assert "done: pigeon+ rounds=1" in capsys.readouterr().out
    assert build.BUILD_DIR == tmp_path / how
    assert compile_cache_stats() == {"persistent_cache_dir": d, "persistent_cache_entries": 0,
                                     "persistent_cache_hits": 0,
                                     "persistent_cache_misses": 0}
