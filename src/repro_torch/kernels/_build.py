"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). ``csrc/pycall.cu`` is built the same way, with the
interpreter's include directory, into a CPython extension module that
``load_module`` imports. ``csrc/tensor_call.cpp``, the one source that
includes PyTorch's headers (a few narrow ones), holds no device code: the
host's C++ compiler builds it into an extension module linked against
the running PyTorch. Libraries land in ``build/repro_torch/`` at the root
of the checkout, named by a hash of the source and the compiler flags, so
a changed source is rebuilt and an unchanged one is loaded as it is.
``build_all`` starts one compiler per source at once and waits for all;
``build_seconds`` keeps each build's wall seconds.
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
import time
from types import ModuleType
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# flags of one source only: the extension module needs Python.h
EXTRA_FLAGS = {"pycall": ("-I" + sysconfig.get_paths()["include"],)}
# the sources the host's C++ compiler builds, by file name
HOST_SOURCES = {"tensor_call": "tensor_call.cpp"}

_loaded: Dict[str, ctypes.CDLL] = {}
_modules: Dict[str, ModuleType] = {}
build_seconds: Dict[str, float] = {}


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


def host_compiler() -> str:
    found = shutil.which(os.environ.get("CXX", "c++"))
    if not found:
        raise RuntimeError("no C++ compiler: csrc/tensor_call.cpp is built "
                           "on first use by the host's compiler (set CXX)")
    return found


def torch_flags(device: str = "CUDA") -> tuple:
    """Compiler and linker flags of a source built against the running
    PyTorch: its headers, its C++ ABI, its libraries (found again at load
    time through the run path), and the device kind the source takes."""
    import torch
    root = pathlib.Path(torch.__file__).resolve().parent
    lib = root / "lib"
    return ("-std=c++17", "-O2", "-shared", "-fPIC",
            f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
            f"-DTENSOR_CALL_DEVICE={device}",
            "-I" + str(root / "include"),
            "-I" + sysconfig.get_paths()["include"],
            "-L" + str(lib), f"-Wl,-rpath,{lib}",
            "-ltorch_python", "-ltorch_cpu", "-lc10")


def flags(name: str) -> tuple:
    if name in HOST_SOURCES:
        return torch_flags()
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def source_path(name: str) -> pathlib.Path:
    return CSRC / HOST_SOURCES.get(name, f"{name}.cu")


def library_path(name: str) -> pathlib.Path:
    src = source_path(name).read_bytes()
    key = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _start(name: str):
    """Start the build of ``name`` unless its library exists; returns the
    (process, tmp path, final path, start time) of the build, or None when
    already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if name in HOST_SOURCES:
        # the source before the libraries, which the linker then keeps
        cmd = [host_compiler(), str(source_path(name)), *flags(name), "-o",
               str(tmp)]
    else:
        cmd = [nvcc(), *flags(name), "-Xptxas", "-v", "-o", str(tmp),
               str(source_path(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, job) -> str:
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the build of csrc/{source_path(name).name} "
                           f"failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: a reader never sees half a file
    return log


def sources():
    return sorted([p.stem for p in CSRC.glob("*.cu")] + list(HOST_SOURCES))


def build_all() -> Dict[str, str]:
    """Compile every source in parallel; returns {name: compiler log} for
    the sources that were built now (an nvcc log holds ``-Xptxas -v``
    output)."""
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
    """The source ``name`` (``csrc/pycall.cu``, ``csrc/tensor_call.cpp``),
    which defines ``PyInit_<name>``, imported as a CPython extension
    module, building it if needed."""
    mod = _modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, _built(name))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[name] = mod
    return mod
