// Host-side frame staging runtime of dvsg_tpu_torch (C++, CPython C API).
//
// The per-byte host work of video I/O lives here, off the interpreter lock:
//
//   * bgr_to_rgb_batch: fused channel swap + staging copy, one pass,
//     parallelized over pixels with a persistent thread pool.
//   * copy_batch: parallel memcpy into pinned/aligned staging buffers.
//   * pool_size: the pool's worker count.
//
// Built as the `_dvsg_torch_native` extension at first use
// (dvsg_tpu_torch/native/build.py); utils/staging.py wraps it and keeps the
// numpy channel swap as the plain version that tests hold it to.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// A tiny persistent thread pool (std::thread; no external deps).
// ---------------------------------------------------------------------------
class Pool {
 public:
  static Pool& instance() {
    static Pool pool;
    return pool;
  }

  // Runs fn(i) for i in [0, n) across the pool, blocking until done.
  // Safe for CONCURRENT callers (e.g. the per-clip decode threads of the
  // multi-clip pipeline): submissions are serialized — interleaved task
  // state corrupted the pool otherwise (dangling task pointer → crash or
  // a pending_ count that never drains → deadlock).
  void parallel_for(size_t n, const std::function<void(size_t)>& fn) {
    if (n == 0) return;
    if (n == 1) {
      fn(0);
      return;
    }
    std::lock_guard<std::mutex> submit_lk(submit_m_);
    std::unique_lock<std::mutex> lk(m_);
    task_ = &fn;
    total_ = n;
    next_ = 0;
    pending_ = n;
    generation_++;
    cv_.notify_all();
    done_cv_.wait(lk, [&] { return pending_ == 0; });
    task_ = nullptr;
  }

  int size() const { return static_cast<int>(workers_.size()); }

 private:
  Pool() {
    unsigned hw = std::thread::hardware_concurrency();
    int n = hw ? static_cast<int>(hw) : 4;
    if (n > 16) n = 16;
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] { worker(); });
    }
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
      cv_.notify_all();
    }
    for (auto& t : workers_) t.join();
  }

  void worker() {
    uint64_t seen = 0;
    for (;;) {
      std::unique_lock<std::mutex> lk(m_);
      cv_.wait(lk, [&] { return stop_ || generation_ != seen; });
      if (stop_) return;
      seen = generation_;
      while (true) {
        size_t i = next_;
        if (i >= total_) break;
        next_ = i + 1;
        lk.unlock();
        (*task_)(i);
        lk.lock();
        if (--pending_ == 0) done_cv_.notify_all();
      }
    }
  }

  std::vector<std::thread> workers_;
  std::mutex submit_m_;   // serializes concurrent parallel_for callers
  std::mutex m_;
  std::condition_variable cv_, done_cv_;
  const std::function<void(size_t)>* task_ = nullptr;
  size_t total_ = 0, next_ = 0, pending_ = 0;
  uint64_t generation_ = 0;
  bool stop_ = false;
};

inline void bgr_to_rgb_rows(const uint8_t* src, uint8_t* dst, size_t pixels) {
  // One fused pass; the compiler vectorizes the 3-byte swizzle.
  for (size_t p = 0; p < pixels; ++p) {
    dst[3 * p + 0] = src[3 * p + 2];
    dst[3 * p + 1] = src[3 * p + 1];
    dst[3 * p + 2] = src[3 * p + 0];
  }
}

struct View {
  uint8_t* data;
  Py_ssize_t len;
};

bool get_view(PyObject* obj, Py_buffer* buf, bool writable, View* out) {
  int flags = PyBUF_C_CONTIGUOUS | (writable ? PyBUF_WRITABLE : 0);
  if (PyObject_GetBuffer(obj, buf, flags) != 0) return false;
  out->data = static_cast<uint8_t*>(buf->buf);
  out->len = buf->len;
  return true;
}

// bgr_to_rgb_batch(src, dst, rows_per_task=64)
// src/dst: C-contiguous uint8 buffers of identical length, length % 3 == 0.
PyObject* bgr_to_rgb_batch(PyObject*, PyObject* args) {
  PyObject *src_o, *dst_o;
  Py_ssize_t rows_per_task = 1 << 16;  // pixels per task
  if (!PyArg_ParseTuple(args, "OO|n", &src_o, &dst_o, &rows_per_task)) {
    return nullptr;
  }
  Py_buffer sb, db;
  View src, dst;
  if (!get_view(src_o, &sb, false, &src)) return nullptr;
  if (!get_view(dst_o, &db, true, &dst)) {
    PyBuffer_Release(&sb);
    return nullptr;
  }
  if (src.len != dst.len || src.len % 3 != 0) {
    PyBuffer_Release(&sb);
    PyBuffer_Release(&db);
    PyErr_SetString(PyExc_ValueError,
                    "src/dst must be equal-length uint8 buffers (len%3==0)");
    return nullptr;
  }
  size_t pixels = static_cast<size_t>(src.len) / 3;
  size_t chunk = static_cast<size_t>(rows_per_task);
  size_t tasks = (pixels + chunk - 1) / chunk;
  {
    Py_BEGIN_ALLOW_THREADS
    Pool::instance().parallel_for(tasks, [&](size_t t) {
      size_t begin = t * chunk;
      size_t count = begin + chunk <= pixels ? chunk : pixels - begin;
      bgr_to_rgb_rows(src.data + 3 * begin, dst.data + 3 * begin, count);
    });
    Py_END_ALLOW_THREADS
  }
  PyBuffer_Release(&sb);
  PyBuffer_Release(&db);
  Py_RETURN_NONE;
}

// copy_batch(src, dst) — parallel memcpy of equal-length buffers.
PyObject* copy_batch(PyObject*, PyObject* args) {
  PyObject *src_o, *dst_o;
  if (!PyArg_ParseTuple(args, "OO", &src_o, &dst_o)) return nullptr;
  Py_buffer sb, db;
  View src, dst;
  if (!get_view(src_o, &sb, false, &src)) return nullptr;
  if (!get_view(dst_o, &db, true, &dst)) {
    PyBuffer_Release(&sb);
    return nullptr;
  }
  if (src.len != dst.len) {
    PyBuffer_Release(&sb);
    PyBuffer_Release(&db);
    PyErr_SetString(PyExc_ValueError, "src/dst length mismatch");
    return nullptr;
  }
  size_t total = static_cast<size_t>(src.len);
  size_t chunk = 4 << 20;  // 4 MiB per task
  size_t tasks = (total + chunk - 1) / chunk;
  {
    Py_BEGIN_ALLOW_THREADS
    Pool::instance().parallel_for(tasks, [&](size_t t) {
      size_t begin = t * chunk;
      size_t count = begin + chunk <= total ? chunk : total - begin;
      std::memcpy(dst.data + begin, src.data + begin, count);
    });
    Py_END_ALLOW_THREADS
  }
  PyBuffer_Release(&sb);
  PyBuffer_Release(&db);
  Py_RETURN_NONE;
}

PyObject* pool_size(PyObject*, PyObject*) {
  return PyLong_FromLong(Pool::instance().size());
}

PyMethodDef methods[] = {
    {"bgr_to_rgb_batch", bgr_to_rgb_batch, METH_VARARGS,
     "Fused parallel BGR->RGB conversion between uint8 buffers."},
    {"copy_batch", copy_batch, METH_VARARGS,
     "Parallel memcpy between equal-length buffers."},
    {"pool_size", pool_size, METH_NOARGS, "Worker thread count."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_dvsg_torch_native",
    "Native host staging runtime for dvsg_tpu_torch", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__dvsg_torch_native() { return PyModule_Create(&module); }
