"""The host launch path of the port's CUDA kernels
(``repro_torch.kernels._launch``) and the wrappers on it.

There is no card here. The declared argument types are held to the C
signatures in ``csrc/`` and to the trampolines of ``csrc/pycall.cu``
that convert them, the kernel path's refusals are made on CPU tensors,
and the wrappers' kernel path runs with CPU tensors against stand-ins
for the C functions, which record what they are passed.
"""
import ctypes
import importlib.util
import math
import re
import shutil
import subprocess
import sysconfig
import types

import pytest
torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _build
from repro_torch.kernels import _launch
from repro_torch.kernels import flash_attn as tfa
from repro_torch.kernels import gather as tgather
from repro_torch.kernels import masked_agg as tma
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import sign_align as tsa

LANE = 1024
C_TYPES = {"ptr": ctypes.c_void_p, "long long": ctypes.c_longlong,
           "int": ctypes.c_int, "float": ctypes.c_float}
DECLARED = {**_launch.ENTRY_POINTS, **_launch.QUERIES}
KERNEL_SOURCES = sorted(p.stem for p in _build.CSRC.glob("*.cu")
                        if p.stem != "pycall")


def _c_signatures(source):
    """{C function: [C type of each parameter]} from the ``extern "C"``
    functions of ``csrc/<source>.cu``."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        kinds = []
        for param in params.split(","):
            decl = " ".join(param.split())
            if "*" in decl:
                kinds.append("ptr")
            elif decl.startswith("long long "):
                kinds.append("long long")
            elif decl.startswith("int "):
                kinds.append("int")
            elif decl.startswith("float "):
                kinds.append("float")
            else:
                raise AssertionError(f"{source}.cu: {name}: parameter "
                                     f"{decl!r} has no ctypes type here")
        out[name] = kinds
    return out


@pytest.mark.parametrize("name", sorted(DECLARED))
def test_declared_argtypes_match_the_c_signature(name):
    source, argtypes = DECLARED[name]
    kinds = _c_signatures(source)[name]
    assert list(argtypes) == [C_TYPES[k] for k in kinds]


def test_every_entry_point_of_the_sources_is_declared():
    found = {name: src for src in KERNEL_SOURCES
             for name in _c_signatures(src)}
    assert found == {name: src for name, (src, _) in DECLARED.items()}
    assert not set(_launch.ENTRY_POINTS) & set(_launch.QUERIES)


@pytest.mark.parametrize("name", ["flash_attn", "gather", "masked_agg",
                                  "quantize", "sign_align"])
def test_wrapper_calls_c_only_through_the_launch_path(name):
    """No wrapper keeps a ctypes handle or an argument-type table of its
    own: each reaches its C functions through ``_launch``."""
    text = (_build.CSRC.parent / "kernels" / f"{name}.py").read_text()
    assert "_build" not in text and "argtypes" not in text
    assert "_launch.entries[" in text


def _trampolines():
    """{name: [C type of each converted argument]} of the METH_FASTCALL
    trampolines in ``csrc/pycall.cu``, and the names its method table
    lists."""
    text = (_build.CSRC / "pycall.cu").read_text()
    defined = {
        name: [" ".join(t.split()) for t in types_.split(",")]
        for name, types_ in re.findall(
            r"PyObject\* (\w+)\(PyObject\*, PyObject\* const\* args, "
            r"Py_ssize_t n\) \{\s*return call<([^>]*)>", text)}
    listed = re.findall(r"(?<!define )METHOD\((\w+)\)", text)
    return defined, listed


def test_trampoline_names_spell_the_types_they_convert():
    defined, listed = _trampolines()
    code = {"P": "p", "L": "l", "int": "i", "float": "f"}
    assert defined and sorted(listed) == sorted(defined)
    for name, ctypes_ in defined.items():
        assert name == "".join(code[t] for t in ctypes_)


@pytest.mark.parametrize("name", sorted(_launch.ENTRY_POINTS))
def test_each_entry_point_has_the_trampoline_of_its_signature(name):
    _source, argtypes = _launch.ENTRY_POINTS[name]
    assert _launch.trampoline_name(argtypes) in _trampolines()[0]


# the place of the flash kernels' strides pointer among their arguments
STRIDES_AT = {"flash_attention": 12, "flash_attention_wgmma": 11}


@pytest.fixture
def fake_card(monkeypatch):
    """The kernel path with CPU tensors: ``device_index`` checks them as
    ever and reports card 0, the current stream is 77, each entry point
    has an address of its own, and each trampoline records what it is
    passed (the flash kernels' strides pointer as the 12 strides it
    points to, read during the call) and, as ``csrc/pycall.cu`` does,
    raises when its entry point returns a CUDA error (``errors[name]``)."""
    calls, loads, errors = [], [], {}
    stubs = {name: ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)
             for name in _launch.ENTRY_POINTS}
    named = {ctypes.cast(f, ctypes.c_void_p).value: n
             for n, f in stubs.items()}

    def load(source):
        loads.append(source)
        return types.SimpleNamespace(**{
            name: stubs[name] for name, (src, _) in
            _launch.ENTRY_POINTS.items() if src == source})

    def trampoline(code):
        def call(name, address, *args):
            assert named[address] == name
            if name in STRIDES_AT:
                at = STRIDES_AT[name]
                strides = (ctypes.c_longlong * 12).from_address(args[at])
                args = (*args[:at], list(strides), *args[at + 1:])
            calls.append((name, code, args))
            if errors.get(name):
                raise RuntimeError(f"{name} kernel launch failed: CUDA "
                                   f"error {errors[name]}")
        return call

    def load_module(name):
        loads.append(name)
        codes = {_launch.trampoline_name(t)
                 for _, t in _launch.ENTRY_POINTS.values()}
        return types.SimpleNamespace(**{c: trampoline(c) for c in codes})

    real_index = _launch.device_index

    def index(name, a, *others):
        real_index(name, a, *others)
        return 0

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "load_module", load_module)
    monkeypatch.setattr(_launch, "entries", _launch._Entries())
    monkeypatch.setattr(_launch, "stream", lambda device: 77)
    monkeypatch.setattr(_launch, "device_index", index)
    return types.SimpleNamespace(calls=calls, loads=loads, errors=errors)


def _codec_inputs(R=3):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((R, LANE), generator=g)
    q = torch.randint(-127, 128, (R, LANE), generator=g, dtype=torch.int8)
    s = torch.rand((R, 1), generator=g)
    return x, q, s


def _gather_inputs():
    return torch.zeros((4, 2, LANE)), torch.tensor([3, 0, 1])


def _agg_inputs():
    g = torch.Generator().manual_seed(1)
    u = torch.randn((5, 2, LANE), generator=g)
    w = torch.rand(5, generator=g)
    r = torch.randint(-1, 2, (2, LANE), generator=g, dtype=torch.int8)
    return u, w, r


def _launch_counts():
    return {**tq.launches, "cohort_gather": tgather.launches, **tma.launches,
            **tsa.launches, "flash": tfa.launches,
            "flash_attention": tfa.launches_by_route["simt"],
            "flash_attention_wgmma": tfa.launches_by_route["wgmma"]}


def _wrapper_cases():
    """Entry point -> (a wrapper call that reaches it, the arguments the
    entry point must get, from the call's result)."""
    x, q, s = _codec_inputs()
    src, idx = _gather_inputs()
    u, w, r = _agg_inputs()
    p16 = torch.zeros((2, LANE), dtype=torch.bfloat16)
    qf, kf = torch.zeros((1, 128, 4, 32)), torch.zeros((1, 256, 2, 32))
    qb = torch.zeros((2, 128, 2, 64), dtype=torch.bfloat16)

    def ptrs(*ts):
        return tuple(t.data_ptr() for t in ts)

    def strides(*ts):
        return [st for t in ts for st in t.stride()[:3]]

    return {
        "quantize_q8": (lambda: tq.quantize_q8(x),
                        lambda out: (*ptrs(x, *out), 3, 77)),
        "dequantize_q8": (lambda: tq.dequantize_q8(q, s),
                          lambda out: (*ptrs(q, s, out), 3, 77)),
        "ef_round_trip": (lambda: tq.ef_round_trip(x, x),
                          lambda out: (*ptrs(x, x, *out), 3, 77)),
        "cohort_gather": (lambda: tgather.cohort_gather(src, idx),
                          lambda out: (*ptrs(src, idx, out), 4, 2, 3, 77)),
        "masked_agg": (lambda: tma.masked_agg(u, w),
                       lambda out: (*ptrs(u, w, out), 5, 2 * LANE, 77)),
        "fused_update": (lambda: tma.fused_update(p16, u, w),
                         lambda out: (p16.data_ptr(), 1, *ptrs(u, w, out), 5,
                                      2 * LANE, 77)),
        # the f32 counts: the kernel writes the tensor the wrapper returns
        # clients, clients a reference (one reference: all of them), n
        "per_client_sign_align": (
            lambda: tsa.per_client_sign_align(u, r),
            lambda out: (*ptrs(u, r, out), 5, 5, 2 * LANE, 77)),
        "sign_align_counts": (
            lambda: tsa.sign_align_counts(p16, r),
            lambda out: (p16.data_ptr(), 1, *ptrs(r, out), 2 * LANE, 77)),
        # f32 takes the SIMT kernel: in_bf16, out_bf16, B, H, K, S, Sk, hd
        "flash_attention": (
            lambda: tfa.flash_attention_gqa(qf, kf, kf, causal=True),
            lambda out: (*ptrs(qf, kf, kf, out), 0, 0, 1, 4, 2, 128, 256,
                         32, strides(qf, kf, kf, out), 1, 0,
                         1 / math.sqrt(32), 77)),
        # bf16 at hd 64 the wgmma kernel: out_bf16, B, H, K, S, Sk, hd
        "flash_attention_wgmma": (
            lambda: tfa.flash_attention_gqa(qb, qb, qb, causal=False,
                                            sliding_window=64,
                                            out_dtype=torch.float32),
            lambda out: (*ptrs(qb, qb, qb, out), 0, 2, 2, 2, 128, 128, 64,
                         strides(qb, qb, qb, out), 0, 64, 0.125, 77)),
    }


def test_entry_is_resolved_once_through_its_signature(fake_card):
    x, _q, _s = _codec_inputs()
    tq.quantize_q8(x)
    tq.quantize_q8(x)
    assert fake_card.loads == ["quantize", "pycall"]
    assert [c[:2] for c in fake_card.calls] == [("quantize_q8", "ppplp")] * 2


def test_wrappers_pass_the_c_signature(fake_card):
    """Each wrapper passes its pointers, sizes and the current stream in
    the order of the C signature to the trampoline of its types, and
    counts the launch, its own and no other."""
    for name, (call, expect) in _wrapper_cases().items():
        before = _launch_counts()
        fake_card.calls.clear()
        out = call()
        assert fake_card.calls == [
            (name, _launch.trampoline_name(_launch.ENTRY_POINTS[name][1]),
             expect(out))], name
        want = dict(before, **{name: before[name] + 1})
        if name.startswith("flash"):
            want["flash"] += 1
        assert _launch_counts() == want, name
        for t in out if isinstance(out, tuple) else (out,):
            assert t.is_contiguous(), name


@pytest.mark.parametrize("P", [1, 2, 3, 6])
def test_grouped_sign_align_passes_clients_a_reference(fake_card, P):
    """With P references (P, R, LANE), the one launch gets C / P clients a
    reference, and the wrapper refuses P that do not divide C."""
    g = torch.Generator().manual_seed(2)
    u = torch.randn((6, 2, LANE), generator=g)
    r = torch.randint(-1, 2, (P, 2, LANE), generator=g, dtype=torch.int8)
    out = tsa.per_client_sign_align(u, r)
    assert fake_card.calls == [("per_client_sign_align", "pppiilp",
                                (u.data_ptr(), r.data_ptr(), out.data_ptr(),
                                 6, 6 // P, 2 * LANE, 77))]
    for bad in ((4, 2, LANE), (0, 2, LANE), (2, 3, LANE), (1, 1, 2, LANE)):
        with pytest.raises(ValueError, match="r must be"):
            tsa.per_client_sign_align(u, torch.zeros(bad, dtype=torch.int8))


class _AtenCalls(TorchDispatchMode):
    """Records the name of every ATen operation run under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["per_client_sign_align",
                                  "sign_align_counts"])
def test_sign_wrappers_make_no_tensor_op_but_the_output(fake_card, name):
    """A sign-count call on the kernel path allocates its f32 output
    uninitialised (no zero fill) and returns it as the kernel wrote it
    (no cast): on the card the launch is the call's one device operation.
    ``test_wrappers_pass_the_c_signature`` checks that the entry point
    gets that output's pointer."""
    call, _expect = _wrapper_cases()[name]
    with _AtenCalls() as ops:
        out = call()
    assert ops.names == ["aten.new_empty.default"]
    assert out.dtype == torch.float32 and len(fake_card.calls) == 1


def test_round_trip_wrapper_makes_no_tensor_op_but_its_outputs(fake_card):
    """An ``ef_round_trip`` call on the kernel path allocates its two f32
    outputs uninitialised and reads nothing back: on the card the launch
    is the call's one device operation, and a scanned dispatch that calls
    it stays free of host synchronisations."""
    call, _expect = _wrapper_cases()["ef_round_trip"]
    with _AtenCalls() as ops:
        restored, residual = call()
    assert ops.names == ["aten.empty_like.default"] * 2
    assert restored.dtype == residual.dtype == torch.float32
    assert len(fake_card.calls) == 1


def test_wrapper_outputs_have_the_plain_versions_shapes(fake_card):
    """On the kernel path each wrapper returns what its plain version
    returns on the same inputs, in shape and dtype."""
    x, q, s = _codec_inputs()
    src, idx = _gather_inputs()
    u, w, r = _agg_inputs()
    calls = {
        "quantize_q8": (tq.quantize_q8, (x,)),
        "dequantize_q8": (tq.dequantize_q8, (q, s)),
        "ef_round_trip": (tq.ef_round_trip, (x, x)),
        "cohort_gather": (tgather.cohort_gather, (src, idx)),
        "masked_agg": (tma.masked_agg, (u, w)),
        "fused_update": (tma.fused_update, (u[0].bfloat16(), u, w)),
        "per_client_sign_align": (tsa.per_client_sign_align, (u, r)),
        "sign_align_counts": (tsa.sign_align_counts, (u[0], r)),
    }
    for name, (fn, args) in calls.items():
        got = fn(*args)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(_launch, "device_index", lambda *a: -1)
            want = fn(*args)
        got, want = ((got, want) if isinstance(got, tuple)
                     else ((got,), (want,)))
        assert [(t.shape, t.dtype) for t in got] == [
            (t.shape, t.dtype) for t in want], name


@pytest.mark.parametrize("name", sorted(_launch.ENTRY_POINTS))
def test_failed_launch_raises_and_is_not_counted(fake_card, name):
    call, _expect = _wrapper_cases()[name]
    fake_card.errors[name] = 700
    before = _launch_counts()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        call()
    assert _launch_counts() == before


def _misaligned(shape, dtype):
    """A contiguous CPU tensor whose data starts 4 bytes past a 16-byte
    boundary."""
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    buf = torch.zeros(nbytes + 32, dtype=torch.uint8)
    off = (4 - buf.data_ptr()) % 16
    t = buf[off:off + nbytes].view(dtype).view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 == 4
    return t


def _kernel_path_refusals():
    _x, q, s = _codec_inputs()
    src, idx = _gather_inputs()
    wide = torch.zeros((3, 2 * LANE))
    u, w, r = _agg_inputs()
    u_wide = torch.zeros((5, 2, 2 * LANE))
    r_wide = torch.zeros((2, 2 * LANE), dtype=torch.int8)
    return {
        "x non-contiguous": lambda: tq.quantize_q8(wide[:, ::2]),
        "x misaligned": lambda: tq.quantize_q8(
            _misaligned((3, LANE), torch.float32)),
        "q non-contiguous": lambda: tq.dequantize_q8(
            wide.to(torch.int8)[:, ::2], s),
        "q misaligned": lambda: tq.dequantize_q8(
            _misaligned((3, LANE), torch.int8), s),
        "scale non-contiguous": lambda: tq.dequantize_q8(
            q, torch.zeros((3, 2))[:, :1]),
        "scale misaligned": lambda: tq.dequantize_q8(
            q, _misaligned((3, 1), torch.float32)),
        "ef_round_trip d non-contiguous": lambda: tq.ef_round_trip(
            wide[:, ::2], _x),
        "ef_round_trip e misaligned": lambda: tq.ef_round_trip(
            _x, _misaligned((3, LANE), torch.float32)),
        "src non-contiguous": lambda: tgather.cohort_gather(
            torch.zeros((4, 2, 2 * LANE))[..., ::2], idx),
        "src misaligned": lambda: tgather.cohort_gather(
            _misaligned((4, 2, LANE), torch.float32), idx),
        "idx non-contiguous": lambda: tgather.cohort_gather(
            src, torch.tensor([3, 9, 0, 9])[::2]),
        "masked_agg u non-contiguous": lambda: tma.masked_agg(
            u_wide[..., ::2], w),
        "masked_agg u misaligned": lambda: tma.masked_agg(
            _misaligned(u.shape, torch.float32), w),
        "masked_agg w non-contiguous": lambda: tma.masked_agg(
            u, torch.zeros(10)[::2]),
        "fused_update p non-contiguous": lambda: tma.fused_update(
            torch.zeros((2, 2 * LANE))[:, ::2], u, w),
        "fused_update p misaligned": lambda: tma.fused_update(
            _misaligned((2, LANE), torch.bfloat16), u, w),
        "fused_update u non-contiguous": lambda: tma.fused_update(
            u[0], u_wide[..., ::2], w),
        "fused_update u misaligned": lambda: tma.fused_update(
            u[0], _misaligned(u.shape, torch.float32), w),
        "fused_update w_lr non-contiguous": lambda: tma.fused_update(
            u[0], u, torch.zeros(10)[::2]),
        "per_client_sign_align u non-contiguous": lambda:
            tsa.per_client_sign_align(u_wide[..., ::2], r),
        "per_client_sign_align u misaligned": lambda:
            tsa.per_client_sign_align(_misaligned(u.shape, torch.float32), r),
        "per_client_sign_align r non-contiguous": lambda:
            tsa.per_client_sign_align(u, r_wide[:, ::2]),
        "per_client_sign_align r misaligned": lambda:
            tsa.per_client_sign_align(u, _misaligned(r.shape, torch.int8)),
        "sign_align_counts g non-contiguous": lambda:
            tsa.sign_align_counts(u_wide[0, :, ::2], r),
        "sign_align_counts g misaligned": lambda: tsa.sign_align_counts(
            _misaligned((2, LANE), torch.bfloat16), r),
        "sign_align_counts r misaligned": lambda: tsa.sign_align_counts(
            u[0], _misaligned(r.shape, torch.int8)),
    }


@pytest.mark.parametrize("case", sorted(_kernel_path_refusals()))
def test_kernel_path_refusals_come_before_the_launch(fake_card, case):
    before = _launch_counts()
    with pytest.raises(ValueError):
        _kernel_path_refusals()[case]()
    assert fake_card.calls == [] and fake_card.loads == []
    assert _launch_counts() == before


def test_aligned_pointer_takes_the_pointer_once_checked():
    t = torch.zeros((3, LANE))
    assert _launch.aligned_pointer("k", t) == t.data_ptr()
    with pytest.raises(ValueError, match="contiguous"):
        _launch.aligned_pointer("k", t.t())
    with pytest.raises(ValueError, match="16-byte"):
        _launch.aligned_pointer("k", _misaligned((2, 5), torch.float32))


def _device_cases():
    cpu, meta = torch.zeros(2), torch.zeros(2, device="meta")
    return {
        "cpu": ((cpu,), -1),
        "cpu cpu": ((cpu, cpu), -1),
        "meta": ((meta,), ValueError),
        "meta meta": ((meta, meta), ValueError),
        "cpu meta": ((cpu, meta), ValueError),
        "meta cpu": ((meta, cpu), ValueError),
        "cpu cpu cpu": ((cpu, cpu, cpu), -1),
        "cpu cpu meta": ((cpu, cpu, meta), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_device_cases()))
def test_device_index(case):
    args, want = _device_cases()[case]
    if want is ValueError:
        with pytest.raises(ValueError):
            _launch.device_index("k", *args)
    else:
        assert _launch.device_index("k", *args) == want


def test_device_index_of_cuda_tensors():
    """CUDA tensors (fake ones, no card here) give their card's index;
    a CUDA tensor with a CPU one is refused."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a = torch.empty(2, device="cuda")
        b = torch.empty(2, device="cuda")
        assert _launch.device_index("k", a) == 0
        assert _launch.device_index("k", a, b) == 0
    with pytest.raises(ValueError, match="one device"):
        _launch.device_index("k", a, torch.zeros(2))
    with pytest.raises(ValueError, match="one device"):
        _launch.device_index("k", torch.zeros(2), a)


C_DECL = {"p": "void*", "l": "long long", "i": "int", "f": "float"}


def _stubs(names):
    """C stand-ins, one per trampoline, of the signature its name spells:
    each records its arguments (a float in ``fseen``, any other in
    ``seen``) and returns ``result``."""
    lines = ['extern "C" {',
             "long long seen[32]; double fseen[32]; int result;"]
    for name in names:
        params = ", ".join(f"{C_DECL[c]} a{i}" for i, c in enumerate(name))
        body = " ".join(f"fseen[{i}] = a{i};" if c == "f" else
                        f"seen[{i}] = (long long)a{i};"
                        for i, c in enumerate(name))
        lines.append(f"int {name}({params}) {{ {body} return result; }}")
    return "\n".join(lines + ["}"]) + "\n"


def _host_build(tmp_path, name, source, *flags):
    out = tmp_path / f"lib{name}.so"
    subprocess.run([shutil.which("c++"), "-x", "c++", "-std=c++17", "-O1",
                    "-shared", "-fPIC", *flags, "-o", str(out), str(source)],
                   check=True, capture_output=True, text=True)
    return out


def test_trampolines_pass_each_argument_in_order(tmp_path):
    """``csrc/pycall.cu`` holds no device code, so the host's C++ compiler
    builds it here: each trampoline hands a C stand-in of its signature
    every argument in its place, 64-bit pointers and sizes whole, a float
    rounded as ctypes rounds it, returns None when it returns 0 and raises
    RuntimeError with the kernel's name and the error when it does not,
    and refuses a wrong count, a non-number, an int out of range and a
    null address."""
    names = sorted(_trampolines()[0])
    (tmp_path / "stubs.cu").write_text(_stubs(names))
    stubs = ctypes.CDLL(str(_host_build(tmp_path, "stubs",
                                        tmp_path / "stubs.cu")))
    path = _host_build(tmp_path, "pycall", _build.CSRC / "pycall.cu",
                       *(f for f in _build.flags("pycall")
                         if f.startswith("-I")))
    spec = importlib.util.spec_from_file_location("pycall", path)
    pycall = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pycall)
    seen = (ctypes.c_longlong * 32).in_dll(stubs, "seen")
    fseen = (ctypes.c_double * 32).in_dll(stubs, "fseen")
    result = ctypes.c_int.in_dll(stubs, "result")
    ptr = 0x7FFF_1234_5670
    value = {"p": lambda i: ptr + 16 * i, "l": lambda i: 2**40 + i,
             "i": lambda i: 65535 - 7 * i, "f": lambda i: 1 / math.sqrt(96)}
    for name in names:
        trampoline = getattr(pycall, name)
        address = ctypes.cast(getattr(stubs, name), ctypes.c_void_p).value
        args = [value[c](i) for i, c in enumerate(name)]
        result.value = 0
        assert trampoline("k", address, *args) is None, name
        for i, c in enumerate(name):
            if c == "f":
                assert fseen[i] == ctypes.c_float(args[i]).value, name
            else:
                assert seen[i] == args[i], (name, i)
        result.value = 700
        with pytest.raises(RuntimeError,
                           match="^k kernel launch failed: CUDA error 700$"):
            trampoline("k", address, *args)
        result.value = -3
        with pytest.raises(RuntimeError,
                           match="^k kernel launch failed: host error -3$"):
            trampoline("k", address, *args)
        result.value = 0
        with pytest.raises(TypeError):
            trampoline("k", address, *args[:-1])
        with pytest.raises(TypeError):
            trampoline("k", address, *args[:-1], "7")
        with pytest.raises(ValueError):
            trampoline("k", 0, *args)
        if "i" in name:
            at = name.index("i")
            with pytest.raises(OverflowError):
                trampoline("k", address, *args[:at], 2**31, *args[at + 1:])
