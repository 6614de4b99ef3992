"""Time the host launch path of ``quantize_q8``, ``dequantize_q8`` and
``cohort_gather`` on one card in alternating turns, three ways in one
process, beside the library call where there is one:

- ``parent``: the wrappers of an older tree unpacked at ``--parent``
  (``kernels/quantize.py`` and ``kernels/gather.py`` from before
  ``kernels/_launch.py``: a ctypes call through ``_lib``, the row and
  kernel-argument checks of ``_check_rows`` and ``_check_kernel_args``,
  a ``torch.cuda.Stream`` a call), e.g. ``git archive 71beec9``;
- ``trampoline``: this tree's wrappers as they are, each entry point
  called through its METH_FASTCALL trampoline in ``csrc/pycall.cu``;
- ``ctypes``: this tree's wrappers with each entry point called as a
  ctypes function with the argument types ``_launch.ENTRY_POINTS``
  declares (no error test on its result, which favours it by a compare).

    python3 tools/launch_ab.py --parent build/parent [--rounds 10]

Each round runs parent, trampoline, ctypes, library, library, ctypes,
trampoline, parent; each turn splits one call's host time by piece
(``chip_smoke.host_us``) and times the call eagerly
(``chip_smoke.time_ms``). One JSON line per wrapper and version, every
turn's numbers and their medians; then one per wrapper that holds the
trampoline path against each other version round by round
(``compare``). Needs one CUDA device and the repository around it.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

NAMES = ("dequantize_q8", "cohort_gather", "quantize_q8")
ORDER = ["parent", "trampoline", "ctypes", "library",
         "library", "ctypes", "trampoline", "parent"]


def parent_modules(root: str):
    """The older tree's ``kernels/quantize.py`` and ``kernels/gather.py``,
    loaded beside this tree's; they reach this tree's ``_build`` (the
    kernels' sources are the same) and ``ref``."""
    mods = []
    for name in ("quantize", "gather"):
        path = pathlib.Path(root) / "src/repro_torch/kernels" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods.append(mod)
    return tuple(mods)


def parent_pieces(quantize, gather, x, q, s, src, idx) -> dict:
    """The pieces of each wrapper call as ``kernels/quantize.py`` and
    ``kernels/gather.py`` made it before the shared launch path (ctypes
    through ``_lib``, ``_check_rows`` and ``_check_kernel_args``), for
    ``host_us``."""
    f32, dev = torch.float32, x.device
    fns = {k: quantize._lib(k) for k in ("quantize_q8", "dequantize_q8")}
    fns["cohort_gather"] = gather._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    q_out, s_out = torch.empty_like(q), torch.empty_like(s)
    d_out = torch.empty(q.shape, dtype=f32, device=dev)
    N, R, _ = src.shape
    K = idx.shape[0]
    g_out = torch.empty((K, R, 1024), dtype=f32, device=dev)

    def q_checks():
        quantize._check_rows("x", x, f32)
        if x.device.type != "cpu":
            quantize._check_kernel_args("quantize_q8", x)

    def d_checks():
        quantize._check_rows("q", q, torch.int8)
        if tuple(s.shape) != (q.shape[0], 1) or s.dtype != f32 or \
                q.device != s.device:
            raise AssertionError("unreachable")
        if q.device.type != "cpu":
            quantize._check_kernel_args("dequantize_q8", q, s)

    def g_checks():
        gather.check_args(src, idx)
        if src.device.type != "cpu" and src.device.type == "cuda" and \
                src.is_contiguous() and idx.is_contiguous() and \
                src.data_ptr() % 16:
            raise AssertionError("unreachable")

    def g_alloc():
        N, R, _ = src.shape
        K = idx.shape[0]
        return torch.empty((K, R, 1024), dtype=f32, device=src.device)

    def stream_of(t):
        return lambda: torch.cuda.current_stream(t.device).cuda_stream

    return {
        "quantize_q8": dict(
            checks=q_checks, lookup=lambda: quantize._lib("quantize_q8"),
            stream=stream_of(x),
            alloc=lambda: (torch.empty(x.shape, dtype=torch.int8,
                                       device=x.device),
                           torch.empty((x.shape[0], 1), dtype=f32,
                                       device=x.device)),
            c_call=lambda: fns["quantize_q8"](
                *(t.data_ptr() for t in (x, q_out, s_out)), x.shape[0],
                stream),
            call=lambda: quantize.quantize_q8(x)),
        "dequantize_q8": dict(
            checks=d_checks, lookup=lambda: quantize._lib("dequantize_q8"),
            stream=stream_of(q),
            alloc=lambda: torch.empty(q.shape, dtype=f32, device=q.device),
            c_call=lambda: fns["dequantize_q8"](
                *(t.data_ptr() for t in (q, s, d_out)), q.shape[0], stream),
            call=lambda: quantize.dequantize_q8(q, s)),
        "cohort_gather": dict(
            checks=g_checks, lookup=gather._lib, stream=stream_of(src),
            alloc=g_alloc,
            c_call=lambda: fns["cohort_gather"](
                src.data_ptr(), idx.data_ptr(), g_out.data_ptr(), N, R, K,
                stream),
            call=lambda: gather.cohort_gather(src, idx)),
    }


def ctypes_entries(build, launch) -> dict:
    """Each entry point as a ctypes function with its declared types."""
    out = {}
    for name, (source, argtypes) in launch.ENTRY_POINTS.items():
        fn = getattr(build.load(source), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        out[name] = fn
    return out


def compare(this: dict, other: dict) -> dict:
    """This version against another, per metric (the whole call's host
    µs, the eager ms): each round's ratio of this version's mean over its
    two turns to the other's, the rounds this version is faster in, the
    difference of the medians and the other's interquartile range over
    its turns."""
    out = {}
    for metric in ("call_us", "ms"):
        a, b = np.array(this[metric]), np.array(other[metric])
        ratio = a.reshape(-1, 2).mean(1) / b.reshape(-1, 2).mean(1)
        q1, q3 = np.percentile(b, [25, 75])
        out[metric] = {"ratio_by_round": ratio.tolist(),
                       "faster_rounds": int((ratio < 1).sum()),
                       "median_diff": float(np.median(b) - np.median(a)),
                       "other_iqr": float(q3 - q1)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("launch_ab.py needs a CUDA device")
    from repro_torch.kernels import _build, _launch, gather, quantize

    _build.build_all()
    inputs = smoke.split_inputs()
    p_quantize, p_gather = parent_modules(args.parent)
    trampolines = _launch.entries
    by_ctypes = ctypes_entries(_build, _launch)
    entries = {"trampoline": trampolines, "ctypes": by_ctypes}
    pieces = {"parent": parent_pieces(p_quantize, p_gather, *inputs),
              "trampoline": smoke.launch_pieces(quantize, gather, _launch,
                                                *inputs)}
    _launch.entries = by_ctypes
    pieces["ctypes"] = smoke.launch_pieces(quantize, gather, _launch, *inputs)
    _launch.entries = trampolines
    library = smoke.library_calls(*inputs)

    def run(name, who):
        # each version's wrappers reach the entry points it names
        _launch.entries = entries.get(who, trampolines)
        try:
            return smoke.turns(name, pieces, library, [who]).get(who)
        finally:
            _launch.entries = trampolines

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for name in NAMES:
        runs = {}
        for _ in range(args.rounds):
            for who in ORDER:
                r = run(name, who)
                if r is None:
                    continue
                got = runs.setdefault(who, {"call_us": [], "ms": [],
                                            "host_us": []})
                got["host_us"] += r["host_us"]
                got["call_us"] += [t["call"] for t in r["host_us"]]
                got["ms"] += r["ms"]
        lines = [{"name": name, "version": who, "gpu": gpu,
                  "host_us": {k: float(np.median(
                      [t[k] for t in r["host_us"]]))
                      for k in r["host_us"][0]},
                  "call_us_turns": r["call_us"], "ms_turns": r["ms"],
                  "ms_median": float(np.median(r["ms"]))}
                 for who, r in runs.items()]
        lines.append({"name": name, "gpu": gpu, "rounds": args.rounds,
                      "trampoline_against": {
                          who: compare(runs["trampoline"], runs[who])
                          for who in runs if who != "trampoline"}})
        for line in lines:
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
