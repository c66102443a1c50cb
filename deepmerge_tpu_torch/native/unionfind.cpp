// Native union-find for RAG contraction.
//
// The merge engine's host side unions millions of passing edges per round on
// big mosaics; a Python-loop union-find is seconds per round, this is
// microseconds. CPython C API (no pybind11 in the build image).
//
// Semantics match deepmerge_tpu_torch.infer.merge.UnionFind exactly:
//   * union by smaller root id (deterministic)
//   * path halving
//   * labels(): dense 0..k-1 ordered by smallest member id

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <vector>

namespace {

int64_t find(std::vector<int64_t>& parent, int64_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];
    x = parent[x];
  }
  return x;
}

// connected_labels(n, edges_bytes, n_edges) -> (labels_bytes, k)
// edges_bytes: contiguous int64 pairs (2 * n_edges values).
PyObject* connected_labels(PyObject* /*self*/, PyObject* args) {
  Py_ssize_t n;
  Py_buffer edges;
  if (!PyArg_ParseTuple(args, "ny*", &n, &edges)) return nullptr;

  const int64_t* e = static_cast<const int64_t*>(edges.buf);
  const Py_ssize_t n_edges = edges.len / (2 * sizeof(int64_t));

  std::vector<int64_t> parent(n);
  for (Py_ssize_t i = 0; i < n; ++i) parent[i] = i;

  for (Py_ssize_t i = 0; i < n_edges; ++i) {
    int64_t a = e[2 * i], b = e[2 * i + 1];
    if (a < 0 || a >= n || b < 0 || b >= n) {
      PyBuffer_Release(&edges);
      PyErr_Format(PyExc_ValueError, "edge (%lld, %lld) out of range [0, %zd)",
                   (long long)a, (long long)b, n);
      return nullptr;
    }
    int64_t ra = find(parent, a), rb = find(parent, b);
    if (ra != rb) {
      if (ra < rb) parent[rb] = ra; else parent[ra] = rb;
    }
  }
  PyBuffer_Release(&edges);

  // dense labels ordered by smallest member id: roots are always the
  // smallest member (union keeps the smaller id as root), and iterating i
  // ascending assigns label ids in first-seen (== smallest-member) order.
  std::vector<int32_t> labels(n);
  std::vector<int32_t> root_label(n, -1);
  int32_t k = 0;
  for (Py_ssize_t i = 0; i < n; ++i) {
    int64_t r = find(parent, i);
    if (root_label[r] < 0) root_label[r] = k++;
    labels[i] = root_label[r];
  }

  PyObject* out = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(labels.data()),
      static_cast<Py_ssize_t>(n * sizeof(int32_t)));
  if (!out) return nullptr;
  PyObject* result = Py_BuildValue("(Ni)", out, (int)k);
  return result;
}

PyMethodDef methods[] = {
    {"connected_labels", connected_labels, METH_VARARGS,
     "connected_labels(n, edges_int64_buffer) -> (labels_int32_bytes, k)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_unionfind",
    "Native union-find for RAG contraction", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__unionfind(void) { return PyModule_Create(&moduledef); }
