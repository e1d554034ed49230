// paddle_tpu_torch C inference API: the capi_exp surface over the embedded
// runtime (counterpart of paddle_tpu/capi/paddle_tpu_c.cpp).
//
// The inference engine is a jit.save artifact run by PyTorch, so the C API
// embeds the CPython interpreter and drives ``paddle_tpu_torch.inference``
// through it: the C caller never sees Python.  Float32 single-input /
// single-output subset (the exp API's common case); richer IO goes through
// the Python Predictor directly.  PD_PredictorCreate runs the predictor on
// the card, as a Python Config does; PD_PredictorCreateOnDevice takes the
// device ("cpu", "cuda", "cuda:<id>"), as Config.disable_gpu() does.
//
// Build (capi/__init__.py's build()):
//   g++ -O2 -shared -fPIC paddle_tpu_torch_c.cpp \
//       -o libpaddle_tpu_torch_c.so \
//       $(python3-config --includes) $(python3-config --ldflags --embed)

#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct PredictorHandle {
  PyObject* predictor;  // owned
};

bool g_finalized = false;

// Every exported entry point (after PD_Init) runs under this guard so C
// hosts may call from any thread: PD_Init releases the GIL it acquired at
// interpreter startup, and the guard re-acquires per call.
struct GilGuard {
  PyGILState_STATE state;
  GilGuard() : state(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state); }
};

PyObject* import_attr(const char* module, const char* attr) {
  PyObject* mod = PyImport_ImportModule(module);
  if (!mod) return nullptr;
  PyObject* out = PyObject_GetAttrString(mod, attr);
  Py_DECREF(mod);
  return out;
}

void print_py_error(const char* where) {
  std::fprintf(stderr, "[paddle_tpu_torch_c] error in %s:\n", where);
  PyErr_Print();
}

}  // namespace

extern "C" {

// Initialize the embedded runtime.  `extra_sys_paths`: colon-separated
// paths prepended to sys.path (site-packages of the deployment venv plus
// the framework checkout/install location).  Returns 0 on success.
int PD_Init(const char* extra_sys_paths) {
  if (g_finalized) {
    // numpy/torch C-extension state does not survive Py_Finalize; a second
    // interpreter lifecycle in one process is not supported (CPython
    // embedding limitation) — distinct error, not a crash later
    std::fprintf(stderr,
                 "[paddle_tpu_torch_c] PD_Init after PD_Finalize is unsupported\n");
    return 3;
  }
  bool fresh = !Py_IsInitialized();
  if (fresh) {
    Py_InitializeEx(0);
  }
  {
    // hold the GIL for the body whether we just created the interpreter
    // (ctypes hosts release it around foreign calls) or not
    GilGuard gil;
    // paths go through the object API (no source-string interpolation:
    // quotes/backslashes in paths must not alter or inject code)
    if (extra_sys_paths && *extra_sys_paths) {
      PyObject* sys_path = PySys_GetObject("path");  // borrowed
      if (!sys_path) return 1;
      std::string paths(extra_sys_paths);
      size_t start = 0;
      int pos = 0;
      while (start <= paths.size()) {
        size_t end = paths.find(':', start);
        if (end == std::string::npos) end = paths.size();
        std::string p = paths.substr(start, end - start);
        if (!p.empty()) {
          PyObject* s = PyUnicode_FromStringAndSize(p.data(), p.size());
          if (!s || PyList_Insert(sys_path, pos++, s) != 0) {
            Py_XDECREF(s);
            return 1;
          }
          Py_DECREF(s);
        }
        start = end + 1;
      }
    }
    PyObject* mod = PyImport_ImportModule("paddle_tpu_torch.inference");
    if (!mod) {
      print_py_error("PD_Init(import paddle_tpu_torch.inference)");
      return 2;
    }
    Py_DECREF(mod);
  }
  if (fresh) {
    // release the GIL acquired at interpreter startup so other host
    // threads can enter via GilGuard
    PyEval_SaveThread();
  }
  return 0;
}

const char* PD_GetVersion() { return "paddle_tpu_torch-capi-0.1"; }

// Create a predictor from a jit.save artifact prefix
// (<prefix>.pdmodel.pt2 + .pdiparams.npz + .pdmodel.json) on `device`
// ("cpu", "cuda" or "cuda:<id>"; NULL is the card).
void* PD_PredictorCreateOnDevice(const char* model_prefix,
                                 const char* device) {
  GilGuard gil;
  PyObject* config_cls = import_attr("paddle_tpu_torch.inference", "Config");
  PyObject* create =
      import_attr("paddle_tpu_torch.inference", "create_predictor");
  if (!config_cls || !create) {
    print_py_error("PD_PredictorCreate(import)");
    Py_XDECREF(config_cls);
    Py_XDECREF(create);
    return nullptr;
  }
  PyObject* config = PyObject_CallFunction(config_cls, "s", model_prefix);
  if (config && device && std::strcmp(device, "cpu") == 0) {
    PyObject* r = PyObject_CallMethod(config, "disable_gpu", nullptr);
    if (!r) Py_CLEAR(config);
    Py_XDECREF(r);
  } else if (config && device && std::strncmp(device, "cuda", 4) == 0) {
    int id = device[4] == ':' ? std::atoi(device + 5) : 0;
    PyObject* r =
        PyObject_CallMethod(config, "enable_use_gpu", "ii", 100, id);
    if (!r) Py_CLEAR(config);
    Py_XDECREF(r);
  } else if (config && device) {
    std::fprintf(stderr, "[paddle_tpu_torch_c] unknown device %s\n", device);
    Py_CLEAR(config);
  }
  PyObject* pred =
      config ? PyObject_CallFunctionObjArgs(create, config, nullptr) : nullptr;
  Py_XDECREF(config);
  Py_DECREF(config_cls);
  Py_DECREF(create);
  if (!pred) {
    print_py_error("PD_PredictorCreate");
    return nullptr;
  }
  PredictorHandle* h = new PredictorHandle{pred};
  return h;
}

// Create a predictor on the card.
void* PD_PredictorCreate(const char* model_prefix) {
  return PD_PredictorCreateOnDevice(model_prefix, nullptr);
}

// Run: float32 input `data` with `shape`[ndim] → writes at most
// `out_capacity` floats into `out` and the output shape into
// out_shape/out_ndim (out_shape capacity: 8).  Returns 0 on success, a
// negative code on error, or — when `out` is too small — the required
// element count (call again with a buffer of at least that many floats).
long long PD_PredictorRunFloat(void* handle, const float* data,
                               const long long* shape, int ndim, float* out,
                               long long out_capacity, long long* out_shape,
                               int* out_ndim) {
  PredictorHandle* h = (PredictorHandle*)handle;
  if (!h || !h->predictor) return -1;
  GilGuard gil;

  // np.frombuffer(bytes, float32).reshape(shape)
  long long numel = 1;
  for (int i = 0; i < ndim; ++i) numel *= shape[i];
  PyObject* np = PyImport_ImportModule("numpy");
  if (!np) return -2;
  PyObject* bytes =
      PyBytes_FromStringAndSize((const char*)data, numel * sizeof(float));
  PyObject* frombuffer = PyObject_GetAttrString(np, "frombuffer");
  PyObject* flat =
      PyObject_CallFunction(frombuffer, "Os", bytes, "float32");
  Py_XDECREF(frombuffer);
  Py_XDECREF(bytes);
  PyObject* arr = nullptr;
  if (flat) {
    PyObject* shp = PyTuple_New(ndim);
    for (int i = 0; i < ndim; ++i) {
      PyTuple_SET_ITEM(shp, i, PyLong_FromLongLong(shape[i]));
    }
    arr = PyObject_CallMethod(flat, "reshape", "O", shp);
    Py_DECREF(shp);
    Py_DECREF(flat);
  }
  if (!arr) {
    print_py_error("PD_PredictorRunFloat(input)");
    Py_DECREF(np);
    return -3;
  }

  PyObject* inputs = PyList_New(1);
  PyList_SET_ITEM(inputs, 0, arr);  // steals arr
  PyObject* outs =
      PyObject_CallMethod(h->predictor, "run", "O", inputs);
  Py_DECREF(inputs);
  if (!outs) {
    print_py_error("PD_PredictorRunFloat(run)");
    Py_DECREF(np);
    return -4;
  }
  PyObject* out0 = PySequence_GetItem(outs, 0);
  Py_DECREF(outs);
  if (!out0) {
    Py_DECREF(np);
    return -5;
  }
  // np.ascontiguousarray(out0, float32) → tobytes
  PyObject* ascont = PyObject_GetAttrString(np, "ascontiguousarray");
  PyObject* cont = PyObject_CallFunction(ascont, "Os", out0, "float32");
  Py_XDECREF(ascont);
  Py_DECREF(out0);
  Py_DECREF(np);
  if (!cont) {
    print_py_error("PD_PredictorRunFloat(output cast)");
    return -6;
  }
  PyObject* shape_obj = PyObject_GetAttrString(cont, "shape");
  Py_ssize_t odim = shape_obj ? PyTuple_Size(shape_obj) : -1;
  long long out_numel = 1;
  if (odim >= 0 && odim <= 8) {
    *out_ndim = (int)odim;
    for (Py_ssize_t i = 0; i < odim; ++i) {
      long long d =
          PyLong_AsLongLong(PyTuple_GET_ITEM(shape_obj, i));
      out_shape[i] = d;
      out_numel *= d;
    }
  } else {
    Py_XDECREF(shape_obj);
    Py_DECREF(cont);
    return -7;
  }
  Py_XDECREF(shape_obj);
  if (out_numel > out_capacity) {
    Py_DECREF(cont);
    return out_numel;  // caller must grow the buffer
  }
  PyObject* tobytes = PyObject_CallMethod(cont, "tobytes", nullptr);
  Py_DECREF(cont);
  if (!tobytes) return -8;
  std::memcpy(out, PyBytes_AsString(tobytes),
              (size_t)out_numel * sizeof(float));
  Py_DECREF(tobytes);
  return 0;
}

void PD_PredictorDestroy(void* handle) {
  PredictorHandle* h = (PredictorHandle*)handle;
  if (h) {
    GilGuard gil;
    Py_XDECREF(h->predictor);
    delete h;
  }
}

// End-of-process teardown ONLY: numpy/torch extension state cannot be
// re-initialized, so PD_Init after PD_Finalize is rejected (code 3).
void PD_Finalize() {
  if (Py_IsInitialized()) {
    PyGILState_Ensure();  // Py_Finalize needs the GIL
    Py_Finalize();
    g_finalized = true;
  }
}

}  // extern "C"
