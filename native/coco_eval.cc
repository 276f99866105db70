// Native core of the official-protocol COCO evaluator.
//
// metrics/coco_eval.py implements pycocotools-COCOeval semantics in pure
// NumPy; its cost at scale is NOT arithmetic but per-call Python overhead:
// evaluating 5k images makes ~60k (image, category) Python calls, each
// doing ~40 tiny-array NumPy ops (measured on the host: ~133 us/pair,
// 8+ s total). This extension replaces the per-(image, category)
// inner work — the IoU matrix, the per-area-range ignore/stable-reorder,
// and the greedy COCO matcher over all IoU thresholds — with ONE C call
// returning the packed match/ignore masks for every area range at once.
//
// Bit parity: all arithmetic is IEEE double in the same operation order
// as the NumPy path (iou_xywh / _match_image in metrics/coco_eval.py),
// so results are exactly equal, not just close; the randomized
// differential tests in tests/test_coco_eval.py assert array equality.
//
// Build: tools/build_native.sh (no external deps).

#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Greedy COCO match for one (image, category): fills matched/ignored
// masks of shape (A, T, M) and n_positive of shape (A,).
void MatchImage(const double* det_boxes, Py_ssize_t num_dt,
                const double* gt_boxes, const unsigned char* gt_iscrowd,
                const double* gt_areas, Py_ssize_t num_gt,
                const double* area_ranges, Py_ssize_t num_a,
                const double* thresholds, Py_ssize_t num_t,
                unsigned char* matched_out, unsigned char* ignored_out,
                int64_t* npos_out) {
  // IoU matrix in the ORIGINAL ground-truth order (crowd columns use
  // intersection / detection-area, the maskUtils.iou convention).
  std::vector<double> ious(static_cast<size_t>(num_dt * num_gt), 0.0);
  std::vector<double> det_areas(static_cast<size_t>(num_dt), 0.0);
  for (Py_ssize_t d = 0; d < num_dt; ++d) {
    const double dx0 = det_boxes[d * 4 + 0];
    const double dy0 = det_boxes[d * 4 + 1];
    const double dw = det_boxes[d * 4 + 2];
    const double dh = det_boxes[d * 4 + 3];
    const double dx1 = dx0 + dw;
    const double dy1 = dy0 + dh;
    const double det_area = dw * dh;
    det_areas[d] = det_area;
    for (Py_ssize_t g = 0; g < num_gt; ++g) {
      const double gx0 = gt_boxes[g * 4 + 0];
      const double gy0 = gt_boxes[g * 4 + 1];
      const double gw = gt_boxes[g * 4 + 2];
      const double gh = gt_boxes[g * 4 + 3];
      const double iw =
          std::max(std::min(dx1, gx0 + gw) - std::max(dx0, gx0), 0.0);
      const double ih =
          std::max(std::min(dy1, gy0 + gh) - std::max(dy0, gy0), 0.0);
      const double inter = iw * ih;
      const double gt_area = gw * gh;
      const double uni =
          gt_iscrowd[g] ? det_area : det_area + gt_area - inter;
      ious[d * num_gt + g] = uni > 0.0 ? inter / uni : 0.0;
    }
  }

  std::vector<unsigned char> gt_ignore(static_cast<size_t>(num_gt), 0);
  std::vector<Py_ssize_t> order(static_cast<size_t>(num_gt), 0);
  std::vector<unsigned char> gt_matched(static_cast<size_t>(num_t * num_gt),
                                        0);
  for (Py_ssize_t a = 0; a < num_a; ++a) {
    const double lo = area_ranges[a * 2 + 0];
    const double hi = area_ranges[a * 2 + 1];
    int64_t npos = 0;
    for (Py_ssize_t g = 0; g < num_gt; ++g) {
      gt_ignore[g] =
          gt_iscrowd[g] || gt_areas[g] < lo || gt_areas[g] > hi ? 1 : 0;
      if (!gt_ignore[g]) ++npos;
    }
    npos_out[a] = npos;
    // Stable non-ignored-first order (np.argsort(gt_ignore, stable)).
    Py_ssize_t pos = 0;
    for (Py_ssize_t g = 0; g < num_gt; ++g)
      if (!gt_ignore[g]) order[pos++] = g;
    for (Py_ssize_t g = 0; g < num_gt; ++g)
      if (gt_ignore[g]) order[pos++] = g;

    std::fill(gt_matched.begin(), gt_matched.end(), 0);
    unsigned char* matched_a = matched_out + a * num_t * num_dt;
    unsigned char* ignored_a = ignored_out + a * num_t * num_dt;
    for (Py_ssize_t t = 0; t < num_t; ++t) {
      for (Py_ssize_t d = 0; d < num_dt; ++d) {
        double best = std::min(thresholds[t], 1.0 - 1e-10);
        Py_ssize_t match = -1;  // index into `order`
        for (Py_ssize_t oi = 0; oi < num_gt; ++oi) {
          const Py_ssize_t g = order[oi];
          if (gt_matched[t * num_gt + oi] && !gt_iscrowd[g]) continue;
          // Once a real (non-ignored) match is held, ignored candidates
          // cannot improve it — and they are sorted last.
          if (match > -1 && !gt_ignore[order[match]] && gt_ignore[g]) break;
          const double iou = ious[d * num_gt + g];
          if (iou < best) continue;
          best = iou;
          match = oi;
        }
        if (match == -1) continue;
        matched_a[t * num_dt + d] = 1;
        ignored_a[t * num_dt + d] = gt_ignore[order[match]];
        gt_matched[t * num_gt + match] = 1;
      }
    }
    // Unmatched detections whose own area falls outside the range are
    // ignored (they would be matched under a different range).
    for (Py_ssize_t d = 0; d < num_dt; ++d) {
      const bool out = det_areas[d] < lo || det_areas[d] > hi;
      if (!out) continue;
      for (Py_ssize_t t = 0; t < num_t; ++t)
        if (!matched_a[t * num_dt + d]) ignored_a[t * num_dt + d] = 1;
    }
  }
}

struct BufferGuard {
  Py_buffer* bufs;
  int n;
  ~BufferGuard() {
    for (int i = 0; i < n; ++i) PyBuffer_Release(&bufs[i]);
  }
};

// match_image(det_boxes, gt_boxes, gt_iscrowd, gt_areas, area_ranges,
//             thresholds) -> (matched: bytes (A,T,M), ignored: bytes
//             (A,T,M), n_positive: bytes int64 (A,))
//
// det_boxes float64 (M,4) score-sorted descending (caller sorts/caps);
// gt_boxes float64 (G,4); gt_iscrowd uint8/bool (G,); gt_areas float64
// (G,); area_ranges float64 (A,2); thresholds float64 (T,). All
// C-contiguous.
PyObject* MatchImagePy(PyObject*, PyObject* args) {
  Py_buffer b[6];
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*", &b[0], &b[1], &b[2], &b[3],
                        &b[4], &b[5]))
    return nullptr;
  BufferGuard guard{b, 6};

  if (b[0].len % (4 * static_cast<Py_ssize_t>(sizeof(double))) != 0 ||
      b[1].len % (4 * static_cast<Py_ssize_t>(sizeof(double))) != 0 ||
      b[3].len % static_cast<Py_ssize_t>(sizeof(double)) != 0 ||
      b[4].len % (2 * static_cast<Py_ssize_t>(sizeof(double))) != 0 ||
      b[5].len % static_cast<Py_ssize_t>(sizeof(double)) != 0) {
    PyErr_SetString(PyExc_ValueError, "buffer sizes are not multiples of "
                                      "their element layouts");
    return nullptr;
  }
  const Py_ssize_t num_dt = b[0].len / (4 * sizeof(double));
  const Py_ssize_t num_gt = b[1].len / (4 * sizeof(double));
  const Py_ssize_t num_a = b[4].len / (2 * sizeof(double));
  const Py_ssize_t num_t = b[5].len / sizeof(double);
  if (static_cast<Py_ssize_t>(b[2].len) != num_gt ||
      b[3].len != num_gt * static_cast<Py_ssize_t>(sizeof(double))) {
    PyErr_SetString(PyExc_ValueError,
                    "ground-truth buffers disagree on length");
    return nullptr;
  }

  const Py_ssize_t mask_len = num_a * num_t * num_dt;
  PyObject* matched = PyBytes_FromStringAndSize(nullptr, mask_len);
  PyObject* ignored = PyBytes_FromStringAndSize(nullptr, mask_len);
  PyObject* npos = PyBytes_FromStringAndSize(
      nullptr, num_a * static_cast<Py_ssize_t>(sizeof(int64_t)));
  if (matched == nullptr || ignored == nullptr || npos == nullptr) {
    Py_XDECREF(matched);
    Py_XDECREF(ignored);
    Py_XDECREF(npos);
    return nullptr;
  }
  std::memset(PyBytes_AS_STRING(matched), 0, mask_len);
  std::memset(PyBytes_AS_STRING(ignored), 0, mask_len);

  MatchImage(static_cast<const double*>(b[0].buf), num_dt,
             static_cast<const double*>(b[1].buf),
             static_cast<const unsigned char*>(b[2].buf),
             static_cast<const double*>(b[3].buf), num_gt,
             static_cast<const double*>(b[4].buf), num_a,
             static_cast<const double*>(b[5].buf), num_t,
             reinterpret_cast<unsigned char*>(PyBytes_AS_STRING(matched)),
             reinterpret_cast<unsigned char*>(PyBytes_AS_STRING(ignored)),
             reinterpret_cast<int64_t*>(PyBytes_AS_STRING(npos)));

  PyObject* out = PyTuple_Pack(3, matched, ignored, npos);
  Py_DECREF(matched);
  Py_DECREF(ignored);
  Py_DECREF(npos);
  return out;
}

PyMethodDef kMethods[] = {
    {"match_image", MatchImagePy, METH_VARARGS,
     "Greedy COCO matching for one (image, category) across all area "
     "ranges and IoU thresholds."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_native_coco_eval",
    "Native COCO-protocol matcher core.", -1, kMethods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

extern "C" PyMODINIT_FUNC PyInit__native_coco_eval() {
  return PyModule_Create(&kModule);
}
