// fastenc — native host-side encoders for the feature pipeline (the
// port's copy of rat_tpu/native/fastenc.cpp, built and loaded by
// rat_tpu_torch/native/__init__.py).
//
// The dataset build encodes millions of rows through per-value vocab
// lookups; in pure Python each is a dict probe on a boxed object
// (reference: fuxictr/preprocess.py:80-93). This extension provides:
//
//   encode_category(values, vocab_dict, oov) -> list[int]
//   encode_sequences(texts, vocab_dict, oov, sep, max_len, pad_value,
//                    pre_pad, pre_trunc) -> list[list[int]]
//   count_tokens(texts, sep) -> (dict, max_len)
//
// with a std::unordered_map of the vocab's keys as UTF-8 (non-string
// keys and values through str()), built once per call. The Python
// paths stay as the fallback, with equal outputs.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

using Vocab = std::unordered_map<std::string, int64_t, std::hash<std::string>>;

// Build a C++ map from a Python dict {bytes|str: int}.
bool build_vocab(PyObject* dict, Vocab* vocab) {
  PyObject *key, *value;
  Py_ssize_t pos = 0;
  vocab->reserve(PyDict_Size(dict) * 2);
  while (PyDict_Next(dict, &pos, &key, &value)) {
    const char* data = nullptr;
    Py_ssize_t len = 0;
    PyObject* tmp = nullptr;
    if (PyBytes_Check(key)) {
      data = PyBytes_AS_STRING(key);
      len = PyBytes_GET_SIZE(key);
    } else if (PyUnicode_Check(key)) {
      data = PyUnicode_AsUTF8AndSize(key, &len);
      if (!data) return false;
    } else {
      // non-string keys (e.g. ints): stringify via str()
      tmp = PyObject_Str(key);
      if (!tmp) return false;
      data = PyUnicode_AsUTF8AndSize(tmp, &len);
      if (!data) {
        Py_DECREF(tmp);
        return false;
      }
    }
    long long idx = PyLong_AsLongLong(value);
    if (idx == -1 && PyErr_Occurred()) {
      Py_XDECREF(tmp);
      return false;
    }
    vocab->emplace(std::string(data, len), idx);
    Py_XDECREF(tmp);
  }
  return true;
}

bool get_view(PyObject* obj, const char** data, Py_ssize_t* len,
              PyObject** tmp) {
  *tmp = nullptr;
  if (PyBytes_Check(obj)) {
    *data = PyBytes_AS_STRING(obj);
    *len = PyBytes_GET_SIZE(obj);
    return true;
  }
  if (PyUnicode_Check(obj)) {
    *data = PyUnicode_AsUTF8AndSize(obj, len);
    return *data != nullptr;
  }
  *tmp = PyObject_Str(obj);
  if (!*tmp) return false;
  *data = PyUnicode_AsUTF8AndSize(*tmp, len);
  if (!*data) {
    Py_DECREF(*tmp);
    *tmp = nullptr;
    return false;
  }
  return true;
}

PyObject* encode_category(PyObject*, PyObject* args) {
  PyObject* values;
  PyObject* vocab_dict;
  long long oov;
  if (!PyArg_ParseTuple(args, "OOL", &values, &vocab_dict, &oov)) return nullptr;
  if (!PySequence_Check(values) || !PyDict_Check(vocab_dict)) {
    PyErr_SetString(PyExc_TypeError, "expected (sequence, dict, int)");
    return nullptr;
  }
  Vocab vocab;
  if (!build_vocab(vocab_dict, &vocab)) return nullptr;

  PyObject* fast = PySequence_Fast(values, "expected a sequence");
  if (!fast) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject* out_list = PyList_New(n);
  if (!out_list) {
    Py_DECREF(fast);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(fast, i);
    const char* data;
    Py_ssize_t len;
    PyObject* tmp;
    long long idx = oov;
    if (get_view(item, &data, &len, &tmp)) {
      auto it = vocab.find(std::string(data, len));
      if (it != vocab.end()) idx = it->second;
      Py_XDECREF(tmp);
    } else {
      PyErr_Clear();
    }
    PyList_SET_ITEM(out_list, i, PyLong_FromLongLong(idx));
  }
  Py_DECREF(fast);
  return out_list;
}

PyObject* encode_sequences(PyObject*, PyObject* args) {
  PyObject* texts;
  PyObject* vocab_dict;
  long long oov, max_len, pad_value;
  const char* sep;
  int pre_pad, pre_trunc;
  if (!PyArg_ParseTuple(args, "OOLsLLpp", &texts, &vocab_dict, &oov, &sep,
                        &max_len, &pad_value, &pre_pad, &pre_trunc))
    return nullptr;
  Vocab vocab;
  if (!build_vocab(vocab_dict, &vocab)) return nullptr;
  const size_t sep_len = std::strlen(sep);

  PyObject* fast = PySequence_Fast(texts, "expected a sequence");
  if (!fast) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject* rows = PyList_New(n);
  if (!rows) {
    Py_DECREF(fast);
    return nullptr;
  }
  std::vector<long long> ids;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(fast, i);
    ids.clear();
    const char* data = nullptr;
    Py_ssize_t len = 0;
    PyObject* tmp = nullptr;
    bool valid = item != Py_None && get_view(item, &data, &len, &tmp);
    if (!valid) PyErr_Clear();
    if (valid && len > 0) {
      std::string_view sv(data, len);
      size_t start = 0;
      while (start <= sv.size()) {
        size_t end = sep_len ? sv.find(sep, start) : std::string_view::npos;
        std::string_view token = (end == std::string_view::npos)
                                     ? sv.substr(start)
                                     : sv.substr(start, end - start);
        auto it = vocab.find(std::string(token));
        ids.push_back(it != vocab.end() ? it->second : oov);
        if (end == std::string_view::npos) break;
        start = end + sep_len;
      }
    }
    Py_XDECREF(tmp);
    // truncate
    size_t m = static_cast<size_t>(max_len);
    size_t keep = ids.size() > m ? m : ids.size();
    size_t offset = (ids.size() > m && pre_trunc) ? ids.size() - m : 0;
    PyObject* row = PyList_New(max_len);
    if (!row) {
      Py_DECREF(fast);
      Py_DECREF(rows);
      return nullptr;
    }
    size_t pad = m - keep;
    for (size_t j = 0; j < m; ++j) {
      long long v;
      if (pre_pad) {
        v = (j < pad) ? pad_value : ids[offset + j - pad];
      } else {
        v = (j < keep) ? ids[offset + j] : pad_value;
      }
      PyList_SET_ITEM(row, j, PyLong_FromLongLong(v));
    }
    PyList_SET_ITEM(rows, i, row);
  }
  Py_DECREF(fast);
  return rows;
}

PyObject* count_tokens_c(PyObject*, PyObject* args) {
  PyObject* texts;
  const char* sep;
  if (!PyArg_ParseTuple(args, "Os", &texts, &sep)) return nullptr;
  const size_t sep_len = std::strlen(sep);
  std::unordered_map<std::string, long long> counts;
  long long max_len = 0;

  PyObject* fast = PySequence_Fast(texts, "expected a sequence");
  if (!fast) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(fast, i);
    const char* data;
    Py_ssize_t len;
    PyObject* tmp;
    if (!get_view(item, &data, &len, &tmp)) {
      PyErr_Clear();
      continue;
    }
    std::string_view sv(data, len);
    long long row_len = 0;
    size_t start = 0;
    while (start <= sv.size()) {
      size_t end = sep_len ? sv.find(sep, start) : std::string_view::npos;
      std::string_view token = (end == std::string_view::npos)
                                   ? sv.substr(start)
                                   : sv.substr(start, end - start);
      ++counts[std::string(token)];
      ++row_len;
      if (end == std::string_view::npos) break;
      start = end + sep_len;
    }
    if (row_len > max_len) max_len = row_len;
    Py_XDECREF(tmp);
  }
  Py_DECREF(fast);

  PyObject* out = PyDict_New();
  if (!out) return nullptr;
  for (const auto& kv : counts) {
    PyObject* k = PyUnicode_FromStringAndSize(kv.first.data(), kv.first.size());
    PyObject* v = PyLong_FromLongLong(kv.second);
    if (!k || !v || PyDict_SetItem(out, k, v) < 0) {
      Py_XDECREF(k);
      Py_XDECREF(v);
      Py_DECREF(out);
      return nullptr;
    }
    Py_DECREF(k);
    Py_DECREF(v);
  }
  return Py_BuildValue("(NL)", out, max_len);
}

PyMethodDef methods[] = {
    {"encode_category", encode_category, METH_VARARGS,
     "encode_category(values, vocab, oov) -> list[int]"},
    {"encode_sequences", encode_sequences, METH_VARARGS,
     "encode_sequences(texts, vocab, oov, sep, max_len, pad, pre_pad, "
     "pre_trunc) -> list[list[int]]"},
    {"count_tokens", count_tokens_c, METH_VARARGS,
     "count_tokens(texts, sep) -> (dict, max_len)"},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "fastenc",
                                "native feature-pipeline encoders", -1,
                                methods};

}  // namespace

PyMODINIT_FUNC PyInit_fastenc(void) { return PyModule_Create(&moduledef); }
