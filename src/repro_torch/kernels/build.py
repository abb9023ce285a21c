"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and compiles with ``nvcc``
into its own shared library, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  Libraries go to ``build/repro_torch_kernels/`` at
the repository root, or to the directory :func:`set_build_dir` names (the
persistent cache of ``core/compile_cache.py``), named by a hash of the
source, the ``csrc/*.cuh`` headers it includes and the flags, so an edited
source or header is rebuilt, an unchanged one is reused, and processes and
hosts can share one directory.  Nothing builds at import time: :func:`load`
builds on first use, and :func:`build_all` starts one ``nvcc`` per source at
once (what ``chip_smoke.py`` times).  :data:`CACHE` counts, once a library
a process, the libraries found in the directory (hits) and those ``nvcc``
built (misses).

Every launcher reports its launch through :func:`record_launch`, which raises
on a CUDA error and otherwise adds one to the launcher's count in
:data:`LAUNCHES`: one reset and one read cover every kernel of a path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Set, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
#: where the libraries go (:func:`set_build_dir`)
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: source stem -> {C function: argtypes}; every function returns a cudaError_t
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SOURCES: Dict[str, Dict[str, Tuple]] = {
    "quant_exchange": {
        # x, deq, scales, n, d, fmt, qinv, warps, vals, vec, stream
        "repro_quant_dequant": (_P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P),
        # x, deq, scales, scratch, n, d, fmt, qinv, per, vec, stream
        "repro_quant_dequant_wide": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P),
        # x, deq, scales, stats, m, n, d, fmt, qinv, row_blocks, col_blocks,
        # segs, rows, vec, stream
        "repro_quant_dequant_stats": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I,
                                      _P),
        # x, deq, scales, stats, scratch, m, n, d, fmt, qinv, stream
        "repro_quant_dequant_stats_wide": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
        # out (int*): the stats kernel's and B2's layout constants
        "repro_quant_exchange_constants": (_P,),
    },
    "tamper_check": {
        # ref, recv, partial, sums, dists, passed, ticket, r, n_elem, chunk, p,
        # tol, aliased, dtype (0 f32, 1 bf16), stream
        "repro_tamper_check": (_P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _I, _F, _I, _I, _P),
        # out (int*): the block and chunk constants
        "repro_tamper_check_constants": (_P,),
    },
    "flash_attention": {
        # q, k, v, out, lse, b, sq, sk, h, hkv, d, window, causal, scale, dtype,
        # stream
        "repro_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                  _I, _P),
    },
    "flash_attention_tc": {
        # q, k, v, out, lse, b, sq, sk, h, hkv, d, window, causal, scale, stream
        "repro_flash_attention_tc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                     _P),
    },
    "flash_attention_bwd": {
        # q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, sk, h, hkv, d,
        # window, causal, scale, dtype, stream
        "repro_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _I, _I, _I, _I, _F, _I, _P),
    },
    "flash_attention_bwd_tc": {
        # q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, sk, h, hkv, d,
        # window, causal, scale, stream
        "repro_flash_attention_bwd_tc": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                         _I, _I, _I, _I, _I, _I, _F, _P),
        # out (int*): each head dim's tiles (kernels/flash_attention.py::
        # bwd_tc_constants)
        "repro_flash_attention_bwd_tc_constants": (_P,),
    },
    "fused_xent": {
        # h, w, labels, part, picked, loss, lse, t, d, v, panels_per_block,
        # nsplit, dtype, stream
        "repro_fused_xent": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        # logits, lse, labels, g, rows, v, stream
        "repro_xent_grad": (_P, _P, _P, _P, _I, _I, _P),
    },
    "fused_xent_tc": {
        # h, w, labels, part, picked, loss, lse, t, d, v, panels_per_block,
        # nsplit, stream
        "repro_fused_xent_tc": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "fused_xent_bwd_tc": {
        # h, w, labels, lse, g, dl, t, d, v, panels_per_block, nsplit, stream
        "repro_xent_dlogits_tc": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "decode_attention": {
        # q, k, v, out, ws, index_dev, index_host, b, s, h, hkv, d, window,
        # chunk, splits, scale, dtype, stream
        "repro_decode_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _F, _I, _P),
        # q, k, v, out, lse, ws, index_dev, index_host, base, b, s, h, hkv, d,
        # window, chunk, splits, scale, dtype, stream
        "repro_decode_attention_partial": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                           _I, _I, _I, _I, _F, _I, _P),
    },
    "decode_attention_tc": {
        # q, k, v, out, index_dev, index_host, b, s, h, hkv, d, window, chunk,
        # splits, scale, stream
        "repro_decode_attention_tc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                      _I, _F, _P),
        # q, k, v, out, lse, index_dev, index_host, base, b, s, h, hkv, d,
        # window, chunk, splits, scale, stream
        "repro_decode_attention_tc_partial": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                              _I, _I, _I, _I, _F, _P),
        # d, splits, out (int*)
        "repro_decode_attention_tc_clusters": (_I, _I, _P),
        # out (int*): the tile and cluster constants
        "repro_decode_attention_tc_constants": (_P,),
    },
    "slstm_scan": {
        # pre, r, out, ws, z_save, s_save, t, b, d, heads, dtype, stream
        "repro_slstm_scan": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "slstm_scan_persistent": {
        # pre, r, out, ws, z_save, s_save, t, b, d, heads, units, wide_r,
        # dtype, stream
        "repro_slstm_scan_persistent": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                        _P),
        # out (int*): the kernel's block and row constants
        "repro_slstm_scan_persistent_constants": (_P,),
    },
    "slstm_scan_bwd": {
        # dout, r, z, state, dz, carry, t, b, d, heads, dtype, stream
        "repro_slstm_scan_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "slstm_scan_bwd_persistent": {
        # dout, r, z, state, dz, arrived, t, b, d, heads, units, wide_r,
        # dtype, stream
        "repro_slstm_scan_bwd_persistent": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                            _I, _P),
        # out (int*): the kernel's block and row constants
        "repro_slstm_scan_bwd_persistent_constants": (_P,),
    },
}

_LOADED: Dict[str, ctypes.CDLL] = {}
_CHECKED: Set[str] = set()
_STARTED: Dict[str, float] = {}

#: seconds each library built in this process took (``nvcc`` start to the
#: library in place); a library built before is not listed
BUILD_SECONDS: Dict[str, float] = {}

#: the first lookup of each library in this process (:func:`load` or
#: :func:`build_all`): ``hits`` found it in :data:`BUILD_DIR`, ``misses``
#: built it with ``nvcc``
CACHE: Dict[str, int] = {"hits": 0, "misses": 0}
_LOOKED_UP: Set[str] = set()

#: kernel launches per launcher; reset with :func:`reset_launches`.  B5's and
#: B4's forwards and backwards and B6 count by route: ``flash_attention``,
#: ``fused_xent``, their ``_bwd`` and ``decode_attention`` the f32-FMA
#: kernels, the same names with ``_tc`` the tensor-core ones; B7 counts
#: ``slstm_scan_persistent`` (one cooperative launch a scan) and
#: ``slstm_scan`` (the step kernel, T launches a scan) a call each, its
#: backward ``slstm_scan_bwd_persistent`` (one cooperative launch a reverse
#: scan) and ``slstm_scan_bwd`` (the step route, T reverse step kernels) a
#: call each; B1 counts
#: ``tamper_check_sums`` (f32 inputs) and ``tamper_check_sums_bf16`` (its
#: bf16 route); B5's forward and backward count a non-causal call under
#: their name with ``_noncausal`` (``flash_attention_tc_noncausal``, ...);
#: B6's partial mode (a panel of a sequence-sharded cache) counts
#: ``decode_attention_partial`` and ``decode_attention_partial_tc``
LAUNCHES: Dict[str, int] = {"quant_dequant": 0, "quant_dequant_stats": 0,
                            "tamper_check_sums": 0, "tamper_check_sums_bf16": 0,
                            "fused_xent": 0, "fused_xent_tc": 0,
                            "fused_xent_bwd": 0, "fused_xent_bwd_tc": 0,
                            "flash_attention": 0, "flash_attention_tc": 0,
                            "flash_attention_bwd": 0, "flash_attention_bwd_tc": 0,
                            "flash_attention_noncausal": 0, "flash_attention_tc_noncausal": 0,
                            "flash_attention_bwd_noncausal": 0,
                            "flash_attention_bwd_tc_noncausal": 0,
                            "decode_attention": 0, "decode_attention_tc": 0,
                            "decode_attention_partial": 0, "decode_attention_partial_tc": 0,
                            "slstm_scan": 0, "slstm_scan_persistent": 0,
                            "slstm_scan_bwd": 0, "slstm_scan_bwd_persistent": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def record_launch(err: int, name: str) -> None:
    """After launcher ``name`` called its C function: raise on the returned
    ``cudaError_t``, else count the launch."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1


@functools.lru_cache(maxsize=None)
def device_limits(device_index: int) -> Tuple[int, int]:
    """(SMs, shared memory bytes a block may use) of a CUDA device: what the
    persistent kernels' grid policies size their grids by."""
    import torch
    props = torch.cuda.get_device_properties(device_index)
    return (props.multi_processor_count,
            int(getattr(props, "shared_memory_per_block_optin", 232448)))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.MULTILINE)


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where ``csrc/<name>.cu``'s library goes: named by a hash of the flags,
    the source and every ``csrc`` header it includes (directly or through
    another header), so an edited header rebuilds its sources."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    todo, seen = [f"{name}.cu"], set()
    while todo:
        file = todo.pop(0)
        if file in seen:
            continue
        seen.add(file)
        text = (csrc / file).read_bytes()
        digest.update(file.encode() + b"\0" + text)
        todo.extend(inc.decode() for inc in _INCLUDE.findall(text))
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def set_build_dir(path) -> None:
    """Put the libraries in ``path`` (made if missing) from now on; a
    library already loaded stays loaded."""
    global BUILD_DIR
    BUILD_DIR = Path(path)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)


def _look_up(name: str) -> bool:
    """Whether ``name``'s library is in :data:`BUILD_DIR`; the first lookup
    of a name in this process counts a hit or a miss in :data:`CACHE`."""
    found = library_path(name).exists()
    if name not in _LOOKED_UP:
        _LOOKED_UP.add(name)
        CACHE["hits" if found else "misses"] += 1
    return found


def _tmp_path(name: str) -> Path:
    return library_path(name).with_suffix(f".{os.getpid()}.tmp")


def _start(name: str) -> subprocess.Popen:
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(_tmp_path(name)),
           str(CSRC / f"{name}.cu")]
    _STARTED[name] = time.perf_counter()
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    """Wait for one build; move the library into place only once complete,
    so a build cut short never leaves a library that looks finished."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
    out = library_path(name)
    out.with_suffix(".log").write_text(log)
    os.replace(_tmp_path(name), out)
    BUILD_SECONDS[name] = time.perf_counter() - _STARTED.pop(name)


def build_all() -> Dict[str, str]:
    """Build every source that has no library yet, one ``nvcc`` each, all
    started together.  Returns {name: compiler log} (ptxas register and
    shared-memory report) for every source, built now or before."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {name: _start(name) for name in SOURCES if not _look_up(name)}
    try:
        for name, proc in procs.items():
            _finish(name, proc)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {name: library_path(name).with_suffix(".log").read_text()
            for name in SOURCES}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    if not _look_up(name):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _finish(name, _start(name))
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SOURCES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _LOADED[name] = lib
    return lib


def check_constants(name: str, expected: Dict[str, int]) -> None:
    """Raise unless the constants that ``csrc/<name>.cu``'s C function
    ``repro_<name>_constants`` writes, in the order of ``expected``'s keys
    (the source's names), equal the values in ``expected``: the Python
    module's copies, which its split or layout policy and the CPU tests'
    models of the kernel use.  Checked once a process per library."""
    if name in _CHECKED:
        return
    out = (ctypes.c_int * len(expected))()
    err = getattr(load(name), f"repro_{name}_constants")(ctypes.addressof(out))
    got = dict(zip(expected, out))
    if err != 0 or got != expected:
        raise RuntimeError(f"{name}.cu's constants {got} (error {err}) differ from the "
                           f"launcher's copies {expected}")
    _CHECKED.add(name)


__all__ = ["BUILD_DIR", "BUILD_SECONDS", "CACHE", "DEFAULT_BUILD_DIR", "LAUNCHES", "SOURCES",
           "build_all", "check_constants", "device_limits", "library_path", "load",
           "record_launch", "reset_launches", "set_build_dir"]
