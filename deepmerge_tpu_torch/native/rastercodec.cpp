// Native TIFF codecs for the raster ingestion layer.
//
// The reference consumes rasters through GDAL, whose strip/tile codecs are
// C++ (SURVEY.md §2.3; MyUtils1.py:319-323). Our pure-Python reader decodes
// LZW and PackBits with byte-at-a-time Python loops — fine for fixtures,
// ~1 MB/s on real mosaics. These are the same codecs in C++, bit-exact
// against geodata/geotiff.py's _lzw_decode/_unpackbits, releasing the GIL so
// the reader can decode many strips/tiles on a thread pool.
//
// CPython C API (no pybind11 in the build image).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// TIFF 6.0 LZW: MSB-first variable-width codes, early change (width bumps
// when next_code + 1 reaches 2^nbits), CLEAR=256, EOI=257. Decoded into
// `out` until `expected` bytes are produced, codes run out, or EOI.
void lzw_decode_into(const uint8_t* data, Py_ssize_t n,
                     std::vector<uint8_t>& out, Py_ssize_t expected) {
  constexpr int kClear = 256, kEoi = 257, kMaxCode = 4096;
  // Table entry c (>= 258) is prefix[c] followed by suffix[c].
  std::vector<int32_t> prefix(kMaxCode, -1);
  std::vector<uint8_t> suffix(kMaxCode, 0);
  std::vector<uint8_t> stack(kMaxCode);

  int next_code = 258;
  int nbits = 9;
  int prev = -1;
  int64_t bitpos = 0;
  const int64_t total_bits = int64_t(n) * 8;

  while (bitpos + nbits <= total_bits &&
         (Py_ssize_t)out.size() < expected) {
    const int64_t byte_idx = bitpos >> 3;
    uint32_t chunk = 0;
    for (int i = 0; i < 4; ++i) {
      chunk <<= 8;
      if (byte_idx + i < n) chunk |= data[byte_idx + i];
    }
    const int code =
        (chunk >> (32 - (bitpos & 7) - nbits)) & ((1u << nbits) - 1);
    bitpos += nbits;

    if (code == kClear) {
      next_code = 258;
      nbits = 9;
      prev = -1;
      continue;
    }
    if (code == kEoi) break;

    // Decode `code` (or the KwKwK case prev+prev[0]) backwards into stack.
    int sp = 0;
    int first;  // first byte of the emitted entry (becomes new suffix)
    if (prev < 0) {
      if (code >= 256) break;  // corrupt stream; match Python's IndexError-free cap
      stack[sp++] = (uint8_t)code;
      first = code;
    } else if (code < next_code) {
      int c = code;
      while (c >= 258) {
        stack[sp++] = suffix[c];
        c = prefix[c];
      }
      if (c >= 256) break;  // corrupt (dangling table slot 256/257)
      stack[sp++] = (uint8_t)c;
      first = c;
      if (next_code < kMaxCode) {
        prefix[next_code] = prev;
        suffix[next_code] = (uint8_t)first;
        ++next_code;
      }
    } else {
      // KwKwK: entry = prev + first(prev)
      int c = prev;
      while (c >= 258) {
        stack[sp++] = suffix[c];
        c = prefix[c];
      }
      if (c >= 256) break;
      stack[sp++] = (uint8_t)c;
      first = c;
      // emit prev then first: push first at BOTTOM of the reversed stack
      // by emitting prev (already in stack) and appending first after.
      // Easier: emit stack reversed, then the extra byte.
      for (int i = sp - 1; i >= 0; --i) out.push_back(stack[i]);
      out.push_back((uint8_t)first);
      if (next_code < kMaxCode) {
        prefix[next_code] = prev;
        suffix[next_code] = (uint8_t)first;
        ++next_code;
      }
      prev = code;
      if (next_code + 1 >= (1 << nbits) && nbits < 12) ++nbits;
      continue;
    }
    for (int i = sp - 1; i >= 0; --i) out.push_back(stack[i]);
    prev = code;
    if (next_code + 1 >= (1 << nbits) && nbits < 12) ++nbits;
  }
}

// lzw_decode(data, expected) -> bytes
PyObject* lzw_decode(PyObject* /*self*/, PyObject* args) {
  Py_buffer data;
  Py_ssize_t expected;
  if (!PyArg_ParseTuple(args, "y*n", &data, &expected)) return nullptr;
  std::vector<uint8_t> out;
  out.reserve(expected + 4096);
  Py_BEGIN_ALLOW_THREADS
  lzw_decode_into(static_cast<const uint8_t*>(data.buf), data.len, out,
                  expected);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&data);
  return PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(out.data()),
      static_cast<Py_ssize_t>(out.size()));
}

// unpackbits(data, expected) -> bytes   (TIFF PackBits / Apple RLE)
PyObject* unpackbits(PyObject* /*self*/, PyObject* args) {
  Py_buffer data;
  Py_ssize_t expected;
  if (!PyArg_ParseTuple(args, "y*n", &data, &expected)) return nullptr;
  const uint8_t* d = static_cast<const uint8_t*>(data.buf);
  const Py_ssize_t n = data.len;
  std::vector<uint8_t> out;
  out.reserve(expected);
  Py_BEGIN_ALLOW_THREADS
  {
    Py_ssize_t i = 0;
    while (i < n && (Py_ssize_t)out.size() < expected) {
      const uint8_t h = d[i++];
      if (h < 128) {  // literal run of h+1 bytes
        const Py_ssize_t take = h + 1 <= n - i ? h + 1 : n - i;
        out.insert(out.end(), d + i, d + i + take);
        i += h + 1;
      } else if (h > 128) {  // repeat next byte 257-h times
        if (i < n) out.insert(out.end(), 257 - h, d[i]);
        i += 1;
      }  // h == 128: no-op
    }
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&data);
  return PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(out.data()),
      static_cast<Py_ssize_t>(out.size()));
}

PyMethodDef methods[] = {
    {"lzw_decode", lzw_decode, METH_VARARGS,
     "lzw_decode(data, expected) -> bytes (TIFF 6.0 LZW, early change)"},
    {"unpackbits", unpackbits, METH_VARARGS,
     "unpackbits(data, expected) -> bytes (TIFF PackBits)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_rastercodec",
    "Native TIFF strip/tile codecs (LZW, PackBits)", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__rastercodec(void) { return PyModule_Create(&moduledef); }
