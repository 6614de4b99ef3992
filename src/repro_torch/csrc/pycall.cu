// Calls into the kernels' plain C entry points from Python, for the
// wrappers' launch path (kernels/_launch.py). No kernel lives here.
//
// A ctypes call converts each argument through its declared type and
// drops and retakes the interpreter lock: a microsecond or more of host
// time on a launch whose kernel runs for two (chip_smoke.py splits a
// wrapper call's host time by piece; PERF.md has the numbers). This file
// is a CPython extension module instead, built by nvcc like the kernels'
// sources, with the interpreter's include directory and no PyTorch
// headers. It has one METH_FASTCALL function per C signature of the entry
// points, named by the signature's codes (p a pointer or the stream, l a
// long long, i an int, f a float); each takes the kernel's name, the entry
// point's address and its arguments as Python numbers, converts them in
// C, calls it and raises if it returns an error. The entry point only
// enqueues its kernel, so the lock is kept for the call.
//
// A trampoline is bound to a signature, not to a kernel: the wrapper
// picks it from the entry point's declared argument types, and
// tests/test_torch_launch.py holds those to the C signatures and each
// trampoline's name to the types it converts.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <climits>
#include <tuple>

namespace {

bool convert(PyObject* o, void** out) {
  *out = PyLong_AsVoidPtr(o);
  return !(*out == nullptr && PyErr_Occurred());
}

bool convert(PyObject* o, long long* out) {
  *out = PyLong_AsLongLong(o);
  return !(*out == -1 && PyErr_Occurred());
}

bool convert(PyObject* o, int* out) {
  const long v = PyLong_AsLong(o);
  if (v == -1 && PyErr_Occurred()) return false;
  if (v < INT_MIN || v > INT_MAX) {
    PyErr_SetString(PyExc_OverflowError, "argument out of range of a C int");
    return false;
  }
  *out = (int)v;
  return true;
}

bool convert(PyObject* o, float* out) {
  const double v = PyFloat_AsDouble(o);
  if (v == -1.0 && PyErr_Occurred()) return false;
  *out = (float)v;
  return true;
}

// args: the kernel's name (for the error), the entry point's address,
// then its arguments. Returns None, or raises RuntimeError with the error
// the entry point returns: a CUDA error, or below 0 one of its host
// code's own (the flash kernel's tensor-map encoder).
template <typename... A>
PyObject* call(PyObject* const* args, Py_ssize_t n) {
  constexpr Py_ssize_t kArgs = sizeof...(A);
  if (n != kArgs + 2) {
    PyErr_Format(PyExc_TypeError, "expected %zd arguments (a name, an "
                 "address and %zd), got %zd", kArgs + 2, kArgs, n);
    return nullptr;
  }
  void* fn = nullptr;
  if (!convert(args[1], &fn)) return nullptr;
  if (fn == nullptr) {
    PyErr_SetString(PyExc_ValueError, "null entry point");
    return nullptr;
  }
  std::tuple<A...> values;
  Py_ssize_t i = 2;
  const bool ok = std::apply(
      [&](A&... v) { return (convert(args[i++], &v) && ...); }, values);
  if (!ok) return nullptr;
  const int err = std::apply(reinterpret_cast<int (*)(A...)>(fn), values);
  if (err > 0) {
    PyErr_Format(PyExc_RuntimeError, "%S kernel launch failed: CUDA error %d",
                 args[0], err);
    return nullptr;
  }
  if (err < 0) {
    PyErr_Format(PyExc_RuntimeError, "%S kernel launch failed: host error %d",
                 args[0], err);
    return nullptr;
  }
  Py_RETURN_NONE;
}

using P = void*;
using L = long long;

// the codec (quantize_q8, dequantize_q8)
PyObject* ppplp(PyObject*, PyObject* const* args, Py_ssize_t n) {
  return call<P, P, P, L, P>(args, n);
}

// ef_round_trip
PyObject* pppplp(PyObject*, PyObject* const* args, Py_ssize_t n) {
  return call<P, P, P, P, L, P>(args, n);
}

// cohort_gather
PyObject* pppllip(PyObject*, PyObject* const* args, Py_ssize_t n) {
  return call<P, P, P, L, L, int, P>(args, n);
}

// masked_agg
PyObject* pppilp(PyObject*, PyObject* const* args, Py_ssize_t n) {
  return call<P, P, P, int, L, P>(args, n);
}

// per_client_sign_align
PyObject* pppiilp(PyObject*, PyObject* const* args, Py_ssize_t n) {
  return call<P, P, P, int, int, L, P>(args, n);
}

// fused_update
PyObject* pipppilp(PyObject*, PyObject* const* args, Py_ssize_t n) {
  return call<P, int, P, P, P, int, L, P>(args, n);
}

// sign_align_counts
PyObject* pipplp(PyObject*, PyObject* const* args, Py_ssize_t n) {
  return call<P, int, P, P, L, P>(args, n);
}

// flash_attention (SIMT)
PyObject* ppppiiiiiiiipiifp(PyObject*, PyObject* const* args, Py_ssize_t n) {
  return call<P, P, P, P, int, int, int, int, int, int, int, int, P, int, int,
              float, P>(args, n);
}

// flash_attention_wgmma
PyObject* ppppiiiiiiipiifp(PyObject*, PyObject* const* args, Py_ssize_t n) {
  return call<P, P, P, P, int, int, int, int, int, int, int, P, int, int,
              float, P>(args, n);
}

#define METHOD(name) \
  {#name, (PyCFunction)(void (*)(void))name, METH_FASTCALL, nullptr}

PyMethodDef methods[] = {METHOD(ppplp),    METHOD(pppplp),
                         METHOD(pppllip),  METHOD(pppilp),
                         METHOD(pppiilp),
                         METHOD(pipppilp), METHOD(pipplp),
                         METHOD(ppppiiiiiiiipiifp),
                         METHOD(ppppiiiiiiipiifp),
                         {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "pycall", nullptr, -1, methods,
                      nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_pycall(void) { return PyModule_Create(&module); }
