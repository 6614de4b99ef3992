// The whole host side of a dequantize_q8 or cohort_gather call on the
// card, in one C++ call from Python. No kernel lives here.
//
// Those two kernels run for one to two microseconds, so a call's cost is
// its host work (PERF.md section 6). Through csrc/pycall.cu the Python
// wrapper checked the tensors, took their pointers, allocated the output
// and asked for the stream itself, a few Python calls each, before the
// trampoline launched: most of a call went to that, and torch.mul and
// torch.index_select, which do it in C++, were faster in eager time.
// Here each is one METH_FASTCALL function that takes the tensors and
//  - checks them against the kernel's contract (shape, dtype, one device
//    of the kind the kernels run on, contiguous, 16-byte aligned), with
//    the Python wrappers' exceptions (ValueError, TypeError);
//  - allocates the output from PyTorch's caching allocator on the
//    tensors' device, with the device current (at::detail::empty_generic
//    with the device's allocator, as the CUDA backend's empty does,
//    without the dispatcher's round: 0.2-0.8 us a call less than
//    at::empty in a probe of ten turns on the H100);
//  - asks that device's current stream (the one torch.cuda.stream(s)
//    makes current, or the capturing stream during a CUDA graph's
//    capture);
//  - calls the kernel's C entry point (csrc/quantize.cu, csrc/gather.cu),
//    which launches and returns cudaGetLastError(), and raises
//    RuntimeError if that is not 0;
//  - returns the output.
// The entry points' addresses are bound once (bind), as kernels/_launch.py
// resolves them. The interpreter lock is kept: the call only enqueues.
//
// Built by the host's C++ compiler against PyTorch's headers
// (kernels/_build.py), not by nvcc: there is no device code, and no CUDA
// header is included. The stream comes through c10's device-generic
// interface. So the same file builds against a CPU-only PyTorch with
// -DTENSOR_CALL_DEVICE=CPU, where it takes CPU tensors and passes a null
// stream: tests/test_torch_launch.py builds it so and holds its checks,
// its arguments and its errors on the host. Only the narrow headers it
// needs are included (the Python tensor type, empty_generic, the
// allocator and device guard interfaces), not torch/extension.h.

#include <torch/csrc/autograd/python_variable.h>

#include <ATen/EmptyTensor.h>
#include <c10/core/Allocator.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>

#include <string>

#ifndef TENSOR_CALL_DEVICE
#define TENSOR_CALL_DEVICE CUDA
#endif

namespace {

constexpr int64_t kLane = 1024;
constexpr int64_t kMaxK = 65535;   // the gather's grid y extent
constexpr c10::DeviceType kDevice = c10::DeviceType::TENSOR_CALL_DEVICE;
constexpr c10::DispatchKey kKey = kDevice == c10::DeviceType::CUDA
                                      ? c10::DispatchKey::CUDA
                                      : c10::DispatchKey::CPU;

using DequantizeFn = int (*)(const void*, const void*, void*, long long,
                             void*);
using GatherFn = int (*)(const void*, const void*, void*, long long,
                         long long, int, void*);

DequantizeFn dequantize_entry = nullptr;
GatherFn gather_entry = nullptr;

std::string shape_of(const at::Tensor& t) {
  std::string s = "(";
  for (int64_t i = 0; i < t.dim(); ++i) {
    if (i) s += ", ";
    s += std::to_string(t.size(i));
  }
  return s + (t.dim() == 1 ? ",)" : ")");
}

const char* dtype_of(const at::Tensor& t) {
  return c10::toString(t.scalar_type());
}

// The tensor behind args[i], or a TypeError.
const at::Tensor& tensor_arg(PyObject* const* args, Py_ssize_t i,
                             const char* name) {
  TORCH_CHECK_TYPE(THPVariable_Check(args[i]), name, " takes tensors");
  return THPVariable_Unpack(args[i]);
}

// The kernels' device check: one device, of the kind the kernels run on.
void check_device(const char* name, const at::Tensor& a,
                  const at::Tensor& b) {
  TORCH_CHECK_VALUE(a.device() == b.device(), name,
                    " takes its tensors on one device; got ", a.device(),
                    " and ", b.device());
  TORCH_CHECK_VALUE(a.device().type() == kDevice, "no ", name,
                    " kernel for device ", a.device());
}

// t's data pointer, for a kernel that takes t contiguous and 16-byte
// aligned (kernels/_launch.py, aligned_pointer).
const void* aligned_pointer(const char* name, const at::Tensor& t) {
  TORCH_CHECK_VALUE(t.is_contiguous(), "the ", name,
                    " kernel takes contiguous tensors");
  const void* ptr = t.const_data_ptr();
  TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(ptr) % 16 == 0, "the ",
                    name, " kernel takes 16-byte aligned tensors");
  return ptr;
}

// An uninitialised contiguous tensor from the device's caching allocator
// (the current device's: the caller holds a guard of the tensors' device).
at::Tensor empty_output(c10::IntArrayRef sizes) {
  return at::detail::empty_generic(sizes, c10::GetAllocator(kDevice),
                                   c10::DispatchKeySet(kKey), at::kFloat,
                                   std::nullopt);
}

void* current_stream(const at::Tensor& t) {
  if (kDevice != c10::DeviceType::CUDA) return nullptr;   // a host build
  return c10::impl::getDeviceGuardImpl(kDevice)
      ->getStream(t.device())
      .native_handle();
}

void check_launch(const char* name, int err) {
  TORCH_CHECK(err <= 0, name, " kernel launch failed: CUDA error ", err);
  TORCH_CHECK(err == 0, name, " kernel launch failed: host error ", err);
}

void check_count(const char* name, Py_ssize_t n, Py_ssize_t want) {
  TORCH_CHECK_TYPE(n == want, name, " takes ", want, " arguments, got ",
                   n);
}

// dequantize_q8(q, scale) -> q * scale: q (R, 1024) int8, scale (R, 1)
// f32, R >= 1; returns (R, 1024) f32.
PyObject* dequantize_q8(PyObject*, PyObject* const* args, Py_ssize_t n) {
  HANDLE_TH_ERRORS
  constexpr const char* kName = "dequantize_q8";
  check_count(kName, n, 2);
  const at::Tensor& q = tensor_arg(args, 0, kName);
  const at::Tensor& scale = tensor_arg(args, 1, kName);
  TORCH_CHECK_VALUE(q.dim() == 2 && q.size(1) == kLane && q.size(0) >= 1,
                    "q must be (R >= 1, ", kLane, "); got ", shape_of(q));
  TORCH_CHECK_TYPE(q.scalar_type() == at::kChar, "expected q int8; got ",
                   dtype_of(q));
  const int64_t rows = q.size(0);
  TORCH_CHECK_VALUE(scale.dim() == 2 && scale.size(0) == rows &&
                        scale.size(1) == 1,
                    "scale must be (", rows, ", 1); got ", shape_of(scale));
  TORCH_CHECK_TYPE(scale.scalar_type() == at::kFloat,
                   "expected scale float32; got ", dtype_of(scale));
  check_device(kName, q, scale);
  const void* pq = aligned_pointer(kName, q);
  const void* ps = aligned_pointer(kName, scale);
  TORCH_CHECK(dequantize_entry != nullptr, kName, " is not bound");
  const c10::DeviceGuard guard(q.device());
  at::Tensor out = empty_output({rows, kLane});
  check_launch(kName, dequantize_entry(pq, ps, out.data_ptr(), rows,
                                       current_stream(q)));
  return THPVariable_Wrap(std::move(out));
  END_HANDLE_TH_ERRORS
}

// cohort_gather(src, idx) -> src[idx]: src (N, R, 1024) f32, idx (K,)
// int64, 1 <= K <= 65535; returns (K, R, 1024) f32.
PyObject* cohort_gather(PyObject*, PyObject* const* args, Py_ssize_t n) {
  HANDLE_TH_ERRORS
  constexpr const char* kName = "cohort_gather";
  check_count(kName, n, 2);
  const at::Tensor& src = tensor_arg(args, 0, kName);
  const at::Tensor& idx = tensor_arg(args, 1, kName);
  TORCH_CHECK_VALUE(src.dim() == 3 && src.size(2) == kLane &&
                        src.size(0) >= 1 && src.size(1) >= 1,
                    "src must be (N >= 1, R >= 1, ", kLane, "); got ",
                    shape_of(src));
  TORCH_CHECK_VALUE(idx.dim() == 1 && idx.size(0) >= 1 &&
                        idx.size(0) <= kMaxK,
                    "idx must be (K,) with 1 <= K <= ", kMaxK, "; got ",
                    shape_of(idx));
  TORCH_CHECK_TYPE(src.scalar_type() == at::kFloat &&
                       idx.scalar_type() == at::kLong,
                   "expected src float32 and idx int64; got ",
                   dtype_of(src), ", ", dtype_of(idx));
  check_device(kName, src, idx);
  const void* psrc = aligned_pointer(kName, src);
  TORCH_CHECK_VALUE(idx.is_contiguous(),
                    "the cohort_gather kernel takes a contiguous idx");
  TORCH_CHECK(gather_entry != nullptr, kName, " is not bound");
  const int64_t rows = src.size(1), k = idx.size(0);
  const c10::DeviceGuard guard(src.device());
  at::Tensor out = empty_output({k, rows, kLane});
  check_launch(kName, gather_entry(psrc, idx.const_data_ptr(),
                                   out.data_ptr(), src.size(0), rows,
                                   static_cast<int>(k),
                                   current_stream(src)));
  return THPVariable_Wrap(std::move(out));
  END_HANDLE_TH_ERRORS
}

// bind(name, address): the C entry point that ``name`` launches through.
PyObject* bind(PyObject*, PyObject* const* args, Py_ssize_t n) {
  HANDLE_TH_ERRORS
  check_count("bind", n, 2);
  const char* name = PyUnicode_AsUTF8(args[0]);
  if (name == nullptr) return nullptr;
  void* address = PyLong_AsVoidPtr(args[1]);
  if (address == nullptr) {
    if (!PyErr_Occurred())
      PyErr_SetString(PyExc_ValueError, "null entry point");
    return nullptr;
  }
  const std::string which(name);
  if (which == "dequantize_q8") {
    dequantize_entry = reinterpret_cast<DequantizeFn>(address);
  } else if (which == "cohort_gather") {
    gather_entry = reinterpret_cast<GatherFn>(address);
  } else {
    PyErr_Format(PyExc_KeyError, "no tensor call named %s", name);
    return nullptr;
  }
  Py_RETURN_NONE;
  END_HANDLE_TH_ERRORS
}

#define METHOD(name) \
  {#name, (PyCFunction)(void (*)(void))name, METH_FASTCALL, nullptr}

PyMethodDef methods[] = {METHOD(dequantize_q8), METHOD(cohort_gather),
                         METHOD(bind), {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "tensor_call", nullptr, -1,
                      methods, nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_tensor_call(void) { return PyModule_Create(&module); }
