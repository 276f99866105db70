// Native data-loader core: JPEG decode + bilinear letterbox resize + pad.
//
// The reference's per-image path rides TensorFlow's C++ ops
// (tf.io.decode_image + tf.image.resize_with_pad,
// vision_transformer_utilities.py:418-449); this extension is the
// framework's equivalent: libjpeg decode and a half-pixel-center
// bilinear resize into a zero-padded canvas, all outside the GIL so a host
// worker pool scales with cores. The Python pipeline
// (data/pipeline.py) uses it when built, falling back to PIL otherwise.
//
// Build: tools/build_native.sh (setuptools; links -ljpeg).

#include <Python.h>

#include <jpeglib.h>
#include <setjmp.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void ErrorExit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

struct Decoded {
  std::vector<unsigned char> rgb;  // oh * ow * 3 (decoded-buffer dims)
  int oh = 0;       // decoded buffer height (== full_h unless DCT-scaled)
  int ow = 0;       // decoded buffer width
  int full_h = 0;   // pre-scaling image dims from the JPEG header —
  int full_w = 0;   // letterbox geometry and labels key off these
  bool ok = false;
  std::string error;
};

// Letterbox resize target for a (full_h, full_w) source into a (th, tw)
// canvas — double math + ties-to-even, the exact twin of the Python
// fallback's round() (see DecodeLetterbox below).
void LetterboxResizeDims(int full_h, int full_w, int th, int tw,
                         int* rh, int* rw) {
  const double scale = std::max(static_cast<double>(full_h) / th,
                                static_cast<double>(full_w) / tw);
  *rh = std::max(1, static_cast<int>(std::nearbyint(full_h / scale)));
  *rw = std::max(1, static_cast<int>(std::nearbyint(full_w / scale)));
}

// letterbox_th/letterbox_tw > 0 enables DCT-domain scaled decode: after
// the header reveals the full dims, the exact letterbox resize target
// (rh, rw) is derived and libjpeg decodes at the smallest M/8 (M in
// 1..8) whose output still covers it — skipping most of the IDCT +
// color-convert work when the canvas is much smaller than the source.
// The subsequent bilinear step then only ever downscales.
Decoded DecodeJpeg(const unsigned char* data, size_t size,
                   int letterbox_th = 0, int letterbox_tw = 0) {
  Decoded out;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = ErrorExit;
  if (setjmp(jerr.setjmp_buffer)) {
    char msg[JMSG_LENGTH_MAX];
    (*cinfo.err->format_message)(
        reinterpret_cast<j_common_ptr>(&cinfo), msg);
    out.error = msg;
    jpeg_destroy_decompress(&cinfo);
    return out;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  out.full_h = static_cast<int>(cinfo.image_height);
  out.full_w = static_cast<int>(cinfo.image_width);
  // Sanity-cap the FULL header dims before anything else: the scaled
  // path shrinks the decode buffer up to 64x, which would otherwise
  // let a crafted 65500x65500 header (rejected in exact mode) through
  // to a ~200 MB allocation + full-image Huffman pass per call.
  if (static_cast<size_t>(out.full_h) * out.full_w > (1u << 27)) {
    out.error = "image dimensions too large (" + std::to_string(out.full_w)
        + "x" + std::to_string(out.full_h) + ")";
    jpeg_destroy_decompress(&cinfo);
    return out;
  }
  if (letterbox_th > 0 && letterbox_tw > 0) {
    int rh = 0, rw = 0;
    LetterboxResizeDims(out.full_h, out.full_w, letterbox_th, letterbox_tw,
                        &rh, &rw);
    for (int m = 1; m <= 8; ++m) {
      // libjpeg's scaled output dims are ceil(dim * m / 8).
      const long sh = (static_cast<long>(out.full_h) * m + 7) / 8;
      const long sw = (static_cast<long>(out.full_w) * m + 7) / 8;
      if (sh >= rh && sw >= rw) {
        cinfo.scale_num = m;
        cinfo.scale_denom = 8;
        break;
      }
    }
  }
  jpeg_start_decompress(&cinfo);

  out.oh = static_cast<int>(cinfo.output_height);
  out.ow = static_cast<int>(cinfo.output_width);
  // Sanity-cap the decoded size BEFORE allocating: a corrupt/adversarial
  // header can declare 65500x65500 (~12.8 GB RGB) and the resulting
  // bad_alloc would escape worker threads into std::terminate.
  if (static_cast<size_t>(out.oh) * out.ow > (1u << 27)) {
    out.error = "image dimensions too large (" + std::to_string(out.ow)
        + "x" + std::to_string(out.oh) + ")";
    jpeg_destroy_decompress(&cinfo);
    return out;
  }
  out.rgb.resize(static_cast<size_t>(out.oh) * out.ow * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out.rgb.data()
        + static_cast<size_t>(cinfo.output_scanline) * out.ow * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  out.ok = true;
  return out;
}

// Half-pixel-center bilinear resize of an RGB buffer (the classic
// tf.image.resize / jax.image.resize convention). Horizontal coefficients
// are precomputed per destination column and each source row pair is
// horizontally resampled once into float rows, so the inner loops are
// tight multiply-adds the compiler can vectorise.
void ResizeBilinear(const unsigned char* src, int sh, int sw,
                    unsigned char* dst, int dh, int dw) {
  const float scale_y = static_cast<float>(sh) / dh;
  const float scale_x = static_cast<float>(sw) / dw;

  std::vector<int> x0s(dw), x1s(dw);
  std::vector<float> fxs(dw);
  for (int x = 0; x < dw; ++x) {
    float sx = (x + 0.5f) * scale_x - 0.5f;
    sx = std::max(0.0f, std::min(sx, static_cast<float>(sw - 1)));
    x0s[x] = static_cast<int>(sx);
    x1s[x] = std::min(x0s[x] + 1, sw - 1);
    fxs[x] = sx - x0s[x];
  }

  // Horizontally-resampled rows, cached by source row index.
  std::vector<float> row_a(dw * 3), row_b(dw * 3);
  int cached_a = -1, cached_b = -1;

  auto hresample = [&](int sy, std::vector<float>& out) {
    const unsigned char* row = src + static_cast<size_t>(sy) * sw * 3;
    for (int x = 0; x < dw; ++x) {
      const unsigned char* p0 = row + x0s[x] * 3;
      const unsigned char* p1 = row + x1s[x] * 3;
      const float fx = fxs[x];
      float* o = out.data() + x * 3;
      o[0] = p0[0] + (p1[0] - p0[0]) * fx;
      o[1] = p0[1] + (p1[1] - p0[1]) * fx;
      o[2] = p0[2] + (p1[2] - p0[2]) * fx;
    }
  };

  for (int y = 0; y < dh; ++y) {
    float sy = (y + 0.5f) * scale_y - 0.5f;
    sy = std::max(0.0f, std::min(sy, static_cast<float>(sh - 1)));
    const int y0 = static_cast<int>(sy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float fy = sy - y0;

    if (cached_a != y0) {
      if (cached_b == y0) {
        std::swap(row_a, row_b);
        std::swap(cached_a, cached_b);
      } else {
        hresample(y0, row_a);
        cached_a = y0;
      }
    }
    if (cached_b != y1) {
      hresample(y1, row_b);
      cached_b = y1;
    }

    unsigned char* out = dst + static_cast<size_t>(y) * dw * 3;
    const float* a = row_a.data();
    const float* b = row_b.data();
    const int n = dw * 3;
    for (int i = 0; i < n; ++i) {
      // Convex combination of uint8 values stays in [0, 255].
      out[i] = static_cast<unsigned char>(a[i] + (b[i] - a[i]) * fy + 0.5f);
    }
  }
}

// Decode + aspect-preserving resize + center pad into (th, tw, 3) zeros —
// the letterbox geometry of data/annotations.py:letterbox_params
// (vtu.py:305-323 semantics).
Decoded DecodeLetterbox(const unsigned char* data, size_t size,
                        int th, int tw, bool scaled) {
  // With `scaled`, libjpeg stops IDCT at the smallest M/8 covering the
  // resize target (decided inside DecodeJpeg, right after the header).
  // The geometry (rh, rw, pad offsets, returned original dims) is
  // computed from the FULL header dims either way, so labels and box
  // mapping are bit-identical between the two modes; only the
  // resampling path differs (DCT box-filter prescale + short bilinear
  // vs one long bilinear), a bounded pixel-value difference that the
  // fast mode's callers opt into (tests/test_native_pipeline.py pins it).
  Decoded decoded = scaled ? DecodeJpeg(data, size, th, tw)
                           : DecodeJpeg(data, size);
  if (!decoded.ok) return decoded;
  // Double math + ties-to-even (nearbyint under the default rounding
  // mode), matching Python's round() in the PIL fallback — lround's
  // half-away-from-zero placed the resize 1px off at exact .5 sizes,
  // skewing native-vs-PIL hosts against each other.
  int rh = 0, rw = 0;
  LetterboxResizeDims(decoded.full_h, decoded.full_w, th, tw, &rh, &rw);
  const int oh = decoded.oh;
  const int ow = decoded.ow;

  std::vector<unsigned char> resized(static_cast<size_t>(rh) * rw * 3);
  ResizeBilinear(decoded.rgb.data(), oh, ow, resized.data(), rh, rw);

  Decoded out;
  out.oh = decoded.full_h;
  out.ow = decoded.full_w;
  out.ok = true;
  out.rgb.assign(static_cast<size_t>(th) * tw * 3, 0);
  const int top = (th - rh) / 2;
  const int left = (tw - rw) / 2;
  for (int y = 0; y < rh; ++y) {
    std::memcpy(out.rgb.data()
                    + ((static_cast<size_t>(top) + y) * tw + left) * 3,
                resized.data() + static_cast<size_t>(y) * rw * 3,
                static_cast<size_t>(rw) * 3);
  }
  return out;
}

// noexcept wrapper: a std::bad_alloc (or any exception) escaping a
// worker thread or a Py_BEGIN_ALLOW_THREADS region calls std::terminate;
// convert it into the same error-Decoded path as libjpeg failures.
Decoded DecodeLetterboxSafe(const unsigned char* data, size_t size,
                            int th, int tw, bool scaled) noexcept {
  try {
    return DecodeLetterbox(data, size, th, tw, scaled);
  } catch (const std::exception& e) {
    Decoded d;
    d.error = e.what();
    return d;
  } catch (...) {
    Decoded d;
    d.error = "unknown native decode failure";
    return d;
  }
}

PyObject* MakeResult(const Decoded& d, int th, int tw) {
  if (!d.ok) {
    PyErr_SetString(PyExc_ValueError,
                    ("jpeg decode failed: " + d.error).c_str());
    return nullptr;
  }
  PyObject* bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(d.rgb.data()),
      static_cast<Py_ssize_t>(d.rgb.size()));
  if (bytes == nullptr) return nullptr;
  return Py_BuildValue("(Nii)", bytes, d.oh, d.ow);
}

// decode_letterbox(data: bytes, target_h: int, target_w: int,
//                  scaled: int = 0) -> (canvas_bytes, orig_h, orig_w)
PyObject* PyDecodeLetterbox(PyObject*, PyObject* args) {
  Py_buffer buffer;
  int th = 0, tw = 0, scaled = 0;
  if (!PyArg_ParseTuple(args, "y*ii|p", &buffer, &th, &tw, &scaled))
    return nullptr;
  if (th <= 0 || tw <= 0) {
    PyBuffer_Release(&buffer);
    PyErr_SetString(PyExc_ValueError, "target size must be positive");
    return nullptr;
  }
  Decoded result;
  Py_BEGIN_ALLOW_THREADS
  result = DecodeLetterboxSafe(
      static_cast<const unsigned char*>(buffer.buf),
      static_cast<size_t>(buffer.len), th, tw, scaled != 0);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&buffer);
  return MakeResult(result, th, tw);
}

// decode_letterbox_batch(list[bytes], th, tw, num_threads,
//                        scaled: int = 0) -> list[(canvas_bytes, oh, ow)]
PyObject* PyDecodeLetterboxBatch(PyObject*, PyObject* args) {
  PyObject* seq = nullptr;
  int th = 0, tw = 0, num_threads = 0, scaled = 0;
  if (!PyArg_ParseTuple(args, "Oiii|p", &seq, &th, &tw, &num_threads,
                        &scaled))
    return nullptr;
  PyObject* fast = PySequence_Fast(seq, "expected a sequence of bytes");
  if (fast == nullptr) return nullptr;
  const Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);

  std::vector<std::string> inputs;
  inputs.reserve(n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(fast, i);
    char* data = nullptr;
    Py_ssize_t size = 0;
    if (PyBytes_AsStringAndSize(item, &data, &size) != 0) {
      Py_DECREF(fast);
      return nullptr;
    }
    inputs.emplace_back(data, static_cast<size_t>(size));
  }
  Py_DECREF(fast);

  std::vector<Decoded> results(n);
  const int workers = std::max(
      1, std::min<int>(num_threads > 0
                           ? num_threads
                           : static_cast<int>(
                                 std::thread::hardware_concurrency()),
                       static_cast<int>(n)));
  Py_BEGIN_ALLOW_THREADS {
    std::vector<std::thread> pool;
    std::atomic<Py_ssize_t> next{0};
    for (int t = 0; t < workers; ++t) {
      pool.emplace_back([&]() {
        while (true) {
          const Py_ssize_t i = next.fetch_add(1);
          if (i >= n) break;
          results[i] = DecodeLetterboxSafe(
              reinterpret_cast<const unsigned char*>(inputs[i].data()),
              inputs[i].size(), th, tw, scaled != 0);
        }
      });
    }
    for (auto& t : pool) t.join();
  }
  Py_END_ALLOW_THREADS

  PyObject* out = PyList_New(n);
  if (out == nullptr) return nullptr;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = MakeResult(results[i], th, tw);
    if (item == nullptr) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, i, item);
  }
  return out;
}

PyMethodDef kMethods[] = {
    {"decode_letterbox", PyDecodeLetterbox, METH_VARARGS,
     "JPEG bytes -> (letterboxed uint8 HWC canvas bytes, orig_h, orig_w); "
     "scaled=True enables DCT-domain reduced-scale decode"},
    {"decode_letterbox_batch", PyDecodeLetterboxBatch, METH_VARARGS,
     "Parallel batch decode: (list[bytes], th, tw, threads, scaled) -> "
     "list"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_native_pipeline",
    "Native JPEG decode + letterbox core for the input pipeline.",
    -1, kMethods,
};

}  // namespace

extern "C" PyMODINIT_FUNC PyInit__native_pipeline(void) {
  return PyModule_Create(&kModule);
}
