"""Build and bind the CUDA kernels in ``kernels/csrc``.

Each ``.cu`` source is compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface under the
repository's ``build/`` directory (listed in ``.gitignore``), and bound
with ``ctypes``.  All sources are compiled in parallel, one ``nvcc`` each.
A library's file name carries a hash of its sources and flags, so an
edited kernel is rebuilt and a stale one is never loaded.  nvcc's
``-Xptxas -v`` report is kept beside each library (``<library>.ptxas.txt``)
and read back when the library is already built.

Every pointer and the stream cross the boundary as ``c_void_p`` and every
extent as ``c_int64``; each C entry point returns ``cudaGetLastError()``
after its launches, which the wrappers turn into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

from repro_torch.analysis import lockdep as _lockdep

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int64

#: C entry points of each source: name -> argtypes.
KERNELS: Dict[str, Dict[str, list]] = {
    "assemble_members": {
        f"assemble_members_{t}": [_P, _I, _P, _P, _I, _P, _P, _I, _P, _I,
                                  _P, _P]
        for t in ("f32", "f64")},
    "axis_pass_fwd": {
        f"axis_pass_fwd_{t}": [_P, _P, _I, _P, _P, _P, _I, _P]
        for t in ("f32", "f64")},
    "axis_pass_inv": {
        f"axis_pass_inv_{t}": [_P, _P, _P, _I, _I, _I, _I, _P]
        for t in ("f32", "f64")},
    "axis_pass_scatter_fwd": {
        f"axis_pass_scatter_fwd_{t}": [_P, _I, _P, _I, _P, _P, _I, _I, _P,
                                       _I, _P, _P, _P, _P, _P]
        for t in ("f32", "f64")},
    "owner_fold": {f"owner_fold_{t}": [_P, _P, _P, _I, _I, _P, _I, _P, _I,
                                       _P, _P]
                   for t in ("f32", "f64")},
    "launch_floor": {"launch_floor_empty": [_P]},
    "pole_fwd": {f"pole_fwd_{t}": [_P, _P, _I, _I, _I, _I, _I, _P]
                 for t in ("f32", "f64")},
    "pole_inv": {f"pole_inv_{t}": [_P, _P, _I, _I, _I, _I, _P]
                 for t in ("f32", "f64")},
    "axis_operator": {f"axis_operator_{t}": [_P] * 6 + [_I] * 4 + [_P]
                      for t in ("f32", "f64", "bf16")},
    "fused_tail": {f"fused_tail_{t}": [_P] * 5 + [_I] + [_P] * 6
                   + [_I, _I, _P] for t in ("f32", "f64", "bf16")},
    "flash_attention": {
        **{f"flash_attention_{t}": [_P] * 6 + [_I] * 17 + [_P]
           for t in ("f32", "bf16")},
        "flash_attention_smem": [_I, _I, _I]},
    "flash_attention_bwd": {
        **{f"flash_attention_bwd_{t}": [_P] * 11 + [_I] * 10 + [_P]
           for t in ("f32", "bf16")},
        "flash_attention_bwd_smem": [_I, _I]},
}

_BUILD_LOCK = _lockdep.make_lock("kernel-build")
_LIBS: Dict[str, ctypes.CDLL] = {}

#: nvcc's ``-Xptxas -v`` report of each loaded library.
PTXAS_LOG: Dict[str, str] = {}
#: Names of the libraries this process found built and did not rebuild.
CACHED: set = set()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh") and (src.suffix == ".cuh"
                                              or src.stem == name):
            h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) every kernel library not built yet and load all.

    Raises ``RuntimeError`` with nvcc's output if a build fails."""
    with _BUILD_LOCK:
        if len(_LIBS) == len(KERNELS):
            return _LIBS
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {n: _library_path(n) for n in KERNELS if n not in _LIBS}
        procs = {}
        for name, path in todo.items():
            if path.is_file():
                log = path.with_suffix(".ptxas.txt")
                PTXAS_LOG[name] = log.read_text() if log.is_file() else ""
                CACHED.add(name)
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            PTXAS_LOG[name] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}.cu:\n{log}")
                continue
            todo[name].with_suffix(".ptxas.txt").write_text(log)
            os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, path in todo.items():
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in KERNELS[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS


def kernel(name: str, dtype_tag: str):
    """The bound C entry point ``{name}_{dtype_tag}`` (building on first use)."""
    return getattr(load_all()[name], f"{name}_{dtype_tag}")


def sass(name: str) -> Dict[str, str]:
    """The machine code of library ``name`` (``cuobjdump -sass``, building
    it first), by kernel: mangled kernel name -> its SASS text."""
    load_all()
    text = subprocess.run(
        [str(Path(_nvcc()).with_name("cuobjdump")), "-sass",
         str(_library_path(name))], capture_output=True, text=True,
        timeout=120, check=True).stdout
    kernels: Dict[str, list] = {}
    lines: list = []
    for line in text.splitlines():
        if "Function : " in line:
            lines = kernels.setdefault(line.split("Function : ", 1)[1]
                                       .strip(), [])
        else:
            lines.append(line)
    return {k: "\n".join(v) for k, v in kernels.items()}
