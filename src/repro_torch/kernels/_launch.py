"""The host side of a kernel launch, shared by every CUDA wrapper of
``repro_torch.kernels``.

On the anomaly-detection paths a launch does 2-5 microseconds of work on
the card, so what the caller pays per call is the wrapper's host time.
Here nothing is looked up, built or converted twice: each C entry point
is resolved once from a declared table and called through the trampoline
of its C signature in ``csrc/pycall.cu`` (a METH_FASTCALL function, not a
ctypes call), the stream is asked of PyTorch's C layer without building a
``torch.cuda.Stream``, and a tensor's data pointer is taken once, for the
alignment test and the launch alike.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch

from repro_torch.kernels import _build

_PTR, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_float)
_FLASH = (_PTR,) * 4                            # q, k, v, out
_FLASH_TAIL = (_PTR, _I32, _I32, _F32, _PTR)    # strides, causal, window,
#                                                 scale, stream

# C entry point -> (its source csrc/<source>.cu, its argument types): a
# pointer or the stream is c_void_p, a `long long` c_longlong, an `int`
# c_int, a `float` c_float. Each returns 0 or an error. The types pick the
# trampoline that converts the arguments, so a wrong entry cuts a pointer
# or misreads a size; tests/test_torch_launch.py holds this table to the
# sources.
ENTRY_POINTS = {
    "quantize_q8": ("quantize", (_PTR, _PTR, _PTR, _I64, _PTR)),
    "dequantize_q8": ("quantize", (_PTR, _PTR, _PTR, _I64, _PTR)),
    "ef_round_trip": ("quantize", (_PTR, _PTR, _PTR, _PTR, _I64, _PTR)),
    "cohort_gather": ("gather", (_PTR, _PTR, _PTR, _I64, _I64, _I32, _PTR)),
    "masked_agg": ("masked_agg", (_PTR, _PTR, _PTR, _I32, _I64, _PTR)),
    "fused_update": ("masked_agg",
                     (_PTR, _I32, _PTR, _PTR, _PTR, _I32, _I64, _PTR)),
    # u, r, counts, clients, clients a reference, n, stream
    "per_client_sign_align": ("sign_align",
                              (_PTR, _PTR, _PTR, _I32, _I32, _I64, _PTR)),
    "sign_align_counts": ("sign_align",
                          (_PTR, _I32, _PTR, _PTR, _I64, _PTR)),
    # in_bf16, out_bf16, B, H, K, S, Sk, hd
    "flash_attention": ("flash_attn", _FLASH + (_I32,) * 8 + _FLASH_TAIL),
    # out_bf16, B, H, K, S, Sk, hd
    "flash_attention_wgmma": ("flash_attn_wgmma",
                              _FLASH + (_I32,) * 7 + _FLASH_TAIL),
}

# C functions that return a value and launch nothing, called through
# ctypes with these types, off the launch path.
QUERIES = {
    "flash_attention_wgmma_smem_bytes": ("flash_attn_wgmma", (_I32,)),
}

CODES = {_PTR: "p", _I64: "l", _I32: "i", _F32: "f"}


def trampoline_name(argtypes) -> str:
    """The name of the ``csrc/pycall.cu`` function that converts and
    passes arguments of these C types: one code letter each."""
    return "".join(CODES[t] for t in argtypes)


class _Entries(dict):
    """Entry point name -> a callable of its arguments (Python numbers)
    that raises RuntimeError with the error if the launch fails. A name is
    resolved on its first lookup, building its source and
    ``csrc/pycall.cu``; later lookups are a dict's."""

    def __missing__(self, name: str) -> Callable[..., None]:
        source, argtypes = ENTRY_POINTS[name]
        address = ctypes.cast(getattr(_build.load(source), name),
                              ctypes.c_void_p).value
        trampoline = getattr(_build.load_module("pycall"),
                             trampoline_name(argtypes))
        fn = self[name] = functools.partial(trampoline, name, address)
        return fn


entries = _Entries()


def query(name: str, *args) -> int:
    """Call the C function ``name`` of ``QUERIES`` and return its int."""
    source, argtypes = QUERIES[name]
    fn = getattr(_build.load(source), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn(*args)


try:
    # stream(device) -> the raw handle of that card's current stream, asked
    # anew on every call: under torch.cuda.stream(s) it is s, during a CUDA
    # graph's capture the capturing stream. PyTorch's own C function, so a
    # launch pays no Python frame for it.
    stream = torch._C._cuda_getCurrentRawStream
except AttributeError:          # a PyTorch built without CUDA
    def stream(device: int) -> int:
        raise RuntimeError("this PyTorch has no CUDA")


def device_index(name: str, a: torch.Tensor, *others: torch.Tensor) -> int:
    """-1 when the tensors lie on the CPU, the card's index when they lie
    on one CUDA device; ValueError otherwise."""
    if a.is_cuda:
        index = a.get_device()
        for t in others:
            if not (t.is_cuda and t.get_device() == index):
                break
        else:
            return index
    elif a.is_cpu and all(t.is_cpu for t in others):
        return -1
    for t in others:
        if t.device != a.device:
            raise ValueError(f"{name} takes its tensors on one device; got "
                             f"{a.device} and {t.device}")
    raise ValueError(f"no {name} kernel for device {a.device}")


def aligned_pointer(name: str, t: torch.Tensor) -> int:
    """``t``'s data pointer, for a kernel that takes ``t`` contiguous and
    16-byte aligned: ValueError unless it is."""
    if not t.is_contiguous():
        raise ValueError(f"the {name} kernel takes contiguous tensors")
    ptr = t.data_ptr()
    if ptr % 16:
        raise ValueError(f"the {name} kernel takes 16-byte aligned tensors")
    return ptr
