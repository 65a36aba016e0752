// C ABI binding for openpose_tpu — the TPU-native analogue of the
// reference's Unity plugin (src/openpose/unity/unityBinding.cpp:459-675),
// which exposes _OPConfigure*/_OPRun/... as a flat C surface over its C++
// core. Here the core is the JAX/XLA pipeline, reached through an embedded
// CPython layer (openpose_tpu/capi.py); this file contains no business
// logic, only marshalling.
//
// Usage from C/C#/anything with FFI:
//   void* h = op_create("{\"model_pose\":\"BODY_25\"}");
//   float* kp; int people, parts;
//   op_process(h, bgr_bytes, height, width, &kp, &people, &parts);
//   ... kp[(p*parts + j)*3 + {0,1,2}] = x, y, score ...
//   op_free_floats(kp);
//   op_destroy(h);
//
// Thread-safety: every entry point takes the GIL via PyGILState_Ensure, so
// calls may come from any thread. If no interpreter is running (pure C host
// process), op_initialize() starts one; when loaded inside Python (e.g. via
// ctypes in the tests) the existing interpreter is reused.
//
// Build: make -C native libopenpose_capi.so

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

namespace {

std::mutex g_err_mutex;
std::string g_last_error;
std::once_flag g_init_once;
int g_init_rc = 0;
// op_last_error() hands out a pointer that must outlive concurrent
// set_error() calls; each thread gets its own stable snapshot buffer.
thread_local std::string g_last_error_snapshot;

void set_error(const std::string& msg) {
    std::lock_guard<std::mutex> lock(g_err_mutex);
    g_last_error = msg;
}

// Capture the pending Python exception into op_last_error().
void capture_py_error(const char* where) {
    PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
    PyErr_Fetch(&type, &value, &trace);
    std::string msg = std::string(where) + ": ";
    if (value != nullptr) {
        PyObject* s = PyObject_Str(value);
        if (s != nullptr) {
            const char* text = PyUnicode_AsUTF8(s);
            if (text != nullptr) msg += text;
            Py_DECREF(s);
        }
    } else {
        msg += "unknown error";
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(trace);
    set_error(msg);
}

// Call openpose_tpu_torch.capi.<fn>(*args). Returns new ref or nullptr (error set).
PyObject* call_capi(const char* fn, PyObject* args) {
    PyObject* module = PyImport_ImportModule("openpose_tpu_torch.capi");
    if (module == nullptr) {
        // Meta-path import hooks (e.g. pytest's assertion rewriter) can
        // leave a stray exception set during a cascading first import;
        // clear it and retry once (partially-imported deps are cached).
        PyErr_Clear();
        module = PyImport_ImportModule("openpose_tpu_torch.capi");
    }
    if (module == nullptr) {
        capture_py_error("import openpose_tpu_torch.capi");
        Py_XDECREF(args);
        return nullptr;
    }
    PyObject* func = PyObject_GetAttrString(module, fn);
    Py_DECREF(module);
    if (func == nullptr) {
        capture_py_error(fn);
        Py_XDECREF(args);
        return nullptr;
    }
    PyObject* result = PyObject_CallObject(func, args);
    Py_DECREF(func);
    Py_XDECREF(args);
    if (result == nullptr) capture_py_error(fn);
    return result;
}

}  // namespace

extern "C" {

// Start an interpreter if none is running. Returns 0 on success. Optional:
// every other entry point calls it implicitly. std::call_once serializes
// concurrent first calls from non-Python threads (two racing
// Py_InitializeEx calls are UB).
int op_initialize(void) {
    std::call_once(g_init_once, []() {
        if (Py_IsInitialized()) return;  // embedded in a Python host
        Py_InitializeEx(0);
        if (!Py_IsInitialized()) {
            set_error("op_initialize: Py_InitializeEx failed");
            g_init_rc = 1;
            return;
        }
        // Release the GIL acquired by Py_InitializeEx so PyGILState_Ensure
        // works from any caller thread.
        PyEval_SaveThread();
    });
    return g_init_rc;
}

// Valid until this thread's next op_* call (thread-local snapshot; a
// concurrent set_error from another thread cannot invalidate it).
const char* op_last_error(void) {
    std::lock_guard<std::mutex> lock(g_err_mutex);
    g_last_error_snapshot = g_last_error;
    return g_last_error_snapshot.c_str();
}

// Create a pipeline from a JSON config (see capi.py for keys).
// Returns a handle (>0) or 0 on error.
void* op_create(const char* config_json) {
    if (op_initialize() != 0) return nullptr;
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* args = Py_BuildValue("(s)", config_json ? config_json : "{}");
    PyObject* result = call_capi("create", args);
    long handle = 0;
    if (result != nullptr) {
        handle = PyLong_AsLong(result);
        Py_DECREF(result);
    }
    PyGILState_Release(gil);
    return reinterpret_cast<void*>(static_cast<intptr_t>(handle));
}

// Run the pipeline on an HxWx3 uint8 BGR frame. On success, *out_keypoints
// is a malloc'd people x parts x 3 float array (caller frees with
// op_free_floats); returns 0. Zero people => *out_keypoints = NULL.
int op_process(void* handle, const unsigned char* bgr, int height, int width,
               float** out_keypoints, int* out_people, int* out_parts) {
    if (out_keypoints == nullptr || out_people == nullptr ||
        out_parts == nullptr) {
        set_error("op_process: null output pointer");
        return 1;
    }
    *out_keypoints = nullptr;
    *out_people = 0;
    *out_parts = 0;
    if (handle == nullptr || bgr == nullptr || height <= 0 || width <= 0) {
        set_error("op_process: bad arguments");
        return 1;
    }
    if (op_initialize() != 0) return 1;
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* args = Py_BuildValue(
        "(ly#ii)", static_cast<long>(reinterpret_cast<intptr_t>(handle)),
        reinterpret_cast<const char*>(bgr),
        static_cast<Py_ssize_t>(height) * width * 3, height, width);
    PyObject* result = call_capi("process", args);
    int rc = 1;
    if (result != nullptr) {
        char* buf = nullptr;
        Py_ssize_t buf_len = 0;
        int people = 0, parts = 0;
        if (PyArg_ParseTuple(result, "y#ii", &buf, &buf_len, &people,
                             &parts)) {
            if (people > 0 && buf_len > 0) {
                float* out = static_cast<float*>(malloc(buf_len));
                if (out != nullptr) {
                    memcpy(out, buf, buf_len);
                    *out_keypoints = out;
                    *out_people = people;
                    *out_parts = parts;
                    rc = 0;
                } else {
                    set_error("op_process: out of memory");
                }
            } else {
                rc = 0;  // valid frame, no people
            }
        } else {
            capture_py_error("op_process: result unpack");
        }
        Py_DECREF(result);
    }
    PyGILState_Release(gil);
    return rc;
}

// Run the pipeline and return the rendered overlay frame instead (uint8 BGR,
// same size as the input). Caller frees with op_free_bytes.
int op_render(void* handle, const unsigned char* bgr, int height, int width,
              unsigned char** out_frame) {
    if (out_frame == nullptr) {
        set_error("op_render: null output pointer");
        return 1;
    }
    *out_frame = nullptr;
    if (handle == nullptr || bgr == nullptr || height <= 0 || width <= 0) {
        set_error("op_render: bad arguments");
        return 1;
    }
    if (op_initialize() != 0) return 1;
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* args = Py_BuildValue(
        "(ly#ii)", static_cast<long>(reinterpret_cast<intptr_t>(handle)),
        reinterpret_cast<const char*>(bgr),
        static_cast<Py_ssize_t>(height) * width * 3, height, width);
    PyObject* result = call_capi("render", args);
    int rc = 1;
    if (result != nullptr) {
        char* buf = nullptr;
        Py_ssize_t buf_len = 0;
        if (PyBytes_Check(result) &&
            PyBytes_AsStringAndSize(result, &buf, &buf_len) == 0 &&
            buf_len == static_cast<Py_ssize_t>(height) * width * 3) {
            unsigned char* out = static_cast<unsigned char*>(malloc(buf_len));
            if (out != nullptr) {
                memcpy(out, buf, buf_len);
                *out_frame = out;
                rc = 0;
            } else {
                set_error("op_render: out of memory");
            }
        } else {
            capture_py_error("op_render: result unpack");
        }
        Py_DECREF(result);
    }
    PyGILState_Release(gil);
    return rc;
}

void op_free_floats(float* buf) { free(buf); }
void op_free_bytes(unsigned char* buf) { free(buf); }

void op_destroy(void* handle) {
    if (handle == nullptr || !Py_IsInitialized()) return;
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* args = Py_BuildValue(
        "(l)", static_cast<long>(reinterpret_cast<intptr_t>(handle)));
    PyObject* result = call_capi("destroy", args);
    Py_XDECREF(result);
    PyGILState_Release(gil);
}

}  // extern "C"
