"""Build and load the port's hand-written CUDA kernels.

Each source under cavif_tpu_torch/csrc/ has a plain C entry point. On the
first CUDA call of a kernel, nvcc compiles its source for sm_90a into
cavif_tpu_torch/_build/lib<name>.so (one nvcc process per source, all
started together) and ctypes loads it. Importing this module needs neither
nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
SOURCES = {
    "dir_cost": "pass1_dir_cost.cu",
    "nd_cost": "pass1_nd_cost.cu",
    "mode_cost": "mode_search_cost.cu",
    "dir_cost_tc": "dir_cost_tc.cu",
}
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict = {}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def inputs(src: Path) -> list:
    """`src` and every header under csrc/ that it includes with quotes,
    directly or through another such header."""
    seen, todo = [], [src]
    while todo:
        f = todo.pop()
        if f in seen or not f.exists():
            continue
        seen.append(f)
        todo += [_CSRC / h for h in _INCLUDE.findall(f.read_text())]
    return seen


def stale(name: str) -> bool:
    """True unless lib<name>.so is newer than its source and every header
    the source includes."""
    so = _BUILD / f"lib{name}.so"
    if not so.exists():
        return True
    built = so.stat().st_mtime
    return any(f.stat().st_mtime > built
               for f in inputs(_CSRC / SOURCES[name]))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build(names=tuple(SOURCES)) -> dict:
    """Compile the named kernels' sources (one nvcc process each, all
    started together) into _build/lib<name>.so unless an up-to-date library
    is there (newer than the source and the csrc/ headers it includes).
    Returns {name: (seconds, nvcc output)}; the output carries
    ptxas's register / shared-memory / spill report."""
    _BUILD.mkdir(exist_ok=True)
    procs, done = {}, {}
    t0 = time.perf_counter()
    for name in names:
        src = _CSRC / SOURCES[name]
        so = _BUILD / f"lib{name}.so"
        if not stale(name):
            done[name] = (0.0, "")
            continue
        tmp = so.with_suffix(f".so.{os.getpid()}")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ), tmp, so)
    for name, (p, tmp, so) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {SOURCES[name]}:\n{out.decode()}")
        os.replace(tmp, so)
        done[name] = (time.perf_counter() - t0, out.decode())
    return done


def load(name: str):
    """The ctypes library of kernel `name`, built and loaded on first
    use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                build((name,))
                lib = ctypes.CDLL(str(_BUILD / f"lib{name}.so"))
                _libs[name] = lib
    return lib


def function(name: str, symbol: str, argtypes):
    """The C entry point `symbol` of kernel `name`, returning int (the
    launch's cudaGetLastError())."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name, t, shape, dtype, device):
    """Raise unless tensor `t` has this device, dtype (or one of a tuple of
    dtypes), shape and is contiguous (what a kernel takes)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
