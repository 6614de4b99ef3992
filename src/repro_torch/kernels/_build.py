"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). ``csrc/pycall.cu`` is built the same way, with the
interpreter's include directory, into a CPython extension module that
``load_module`` imports. Libraries land in ``build/repro_torch/`` at the
root of the checkout, named by a hash of the source and the compiler
flags, so a changed source is rebuilt and an unchanged one is loaded as
it is.
``build_all`` starts one ``nvcc`` per source at once and waits for all.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sysconfig
from types import ModuleType
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# flags of one source only: the extension module needs Python.h
EXTRA_FLAGS = {"pycall": ("-I" + sysconfig.get_paths()["include"],)}

_loaded: Dict[str, ctypes.CDLL] = {}
_modules: Dict[str, ModuleType] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built from source on first use and need the "
                           "CUDA toolkit (set CUDA_HOME)")
    return path


def flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _start(name: str):
    """Start the build of ``name`` unless its library exists; returns the
    (process, tmp path, final path) triple, or None when already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *flags(name), "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: a reader never sees half a file
    return log


def sources():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, str]:
    """Compile every source in parallel; returns {name: nvcc log} for the
    sources that were built now (the log holds ``-Xptxas -v`` output)."""
    jobs = {name: _start(name) for name in sources()}
    return {name: _finish(name, job)
            for name, job in jobs.items() if job is not None}


def _built(name: str) -> str:
    job = _start(name)
    if job is not None:
        _finish(name, job)
    return str(library_path(name))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(_built(name))
    return lib


def load_module(name: str) -> ModuleType:
    """``csrc/<name>.cu``, which defines ``PyInit_<name>``, imported as a
    CPython extension module, building it if needed."""
    mod = _modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, _built(name))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[name] = mod
    return mod
