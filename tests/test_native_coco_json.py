"""Native COCO instances-JSON parser vs the pure-Python path.

The C++ extension (native/coco_json.cc) must produce a bit-identical
annotation dict — including degenerate-box fixes, 3-decimal rounding,
area sort and diagnostics — on a synthetic instances file that exercises
escapes, nested segmentation arrays, scientific notation and the
degenerate/negative-coordinate branches (vtu.py:82-220 semantics).
"""

import json

import numpy as np
import pytest

from vision_transformer_detector.data import annotations as ann


def synthetic_instances():
    rng = np.random.default_rng(7)
    annotations = []
    for i in range(500):
        image_id = int(rng.integers(1, 40))
        w = float(np.round(rng.uniform(0, 120), 2))
        h = float(np.round(rng.uniform(0, 120), 2))
        if i % 37 == 0:
            w = 0.0          # degenerate width branch
        elif i % 41 == 0:
            h = 0.0          # degenerate height branch
        x = float(np.round(rng.uniform(-2, 500), 2))  # some negative coords
        y = float(np.round(rng.uniform(0, 500), 2))
        annotations.append({
            "segmentation": [[float(v) for v in rng.uniform(0, 600, 8)]],
            "area": w * h,
            "iscrowd": int(i % 19 == 0),
            "image_id": image_id,
            "bbox": [x, y, w, h],
            "category_id": int(rng.integers(1, 91)),
            "id": 10_000 + i,
        })
    return {
        "info": {"description": "synthetic \"escaped\" \\ test\n set",
                 "version": 1.0e0, "year": 2026, "nested": {"a": [1, [2]]}},
        "licenses": [{"url": "http://example.com/?a=b&c=d", "id": 1}],
        "images": [{"id": i, "file_name": f"{i:012d}.jpg",
                    "height": 480, "width": 640} for i in range(1, 41)],
        "annotations": annotations,
        "categories": [{"supercategory": "thing", "id": c,
                        "name": f"cat-{c}"} for c in range(1, 91)],
    }


@pytest.fixture
def instances_path(tmp_path):
    path = tmp_path / "instances_synthetic.json"
    path.write_text(json.dumps(synthetic_instances()))
    return str(path)


needs_native = pytest.mark.skipif(
    not ann.native_parser_available(),
    reason="native extension not built (tools/build_native.sh)")


@needs_native
def test_native_matches_python(instances_path):
    d_py = ann.build_annotations_from_instances(
        instances_path, use_native=False)
    d_nat = ann.build_annotations_from_instances(
        instances_path, use_native=True)
    assert d_py.keys() == d_nat.keys()
    for key in d_py:
        assert len(d_py[key]) == len(d_nat[key])
        np.testing.assert_array_equal(
            np.asarray(d_py[key], np.float64),
            np.asarray(d_nat[key], np.float64), err_msg=f"image {key}")


@needs_native
def test_native_diagnostics_match(instances_path):
    diag_py = ann.AnnotationDiagnostics()
    diag_nat = ann.AnnotationDiagnostics()
    ann.build_annotations_from_instances(
        instances_path, use_native=False, diagnostics=diag_py)
    ann.build_annotations_from_instances(
        instances_path, use_native=True, diagnostics=diag_nat)
    assert diag_py.summary() == diag_nat.summary()
    assert diag_py.summary()["fixed_boxes"] > 0
    assert diag_py.summary()["negative_coordinates"] > 0
    assert diag_py.fixed_boxes == diag_nat.fixed_boxes
    assert diag_py.negative_coordinates == diag_nat.negative_coordinates


@needs_native
def test_native_area_sort_descending_and_ascending(instances_path):
    for descending in (True, False):
        d = ann.build_annotations_from_instances(
            instances_path, use_native=True, area_descending=descending)
        for rows in d.values():
            areas = [r[-1] for r in rows]
            expected = sorted(areas, reverse=descending)
            assert areas == expected


@needs_native
def test_native_rejects_malformed():
    from vision_transformer_detector._native import _native_coco_json

    with pytest.raises(ValueError):
        _native_coco_json.parse_instances(b'{"annotations": [{"bbox": }]}')


@needs_native
def test_native_rejects_short_bbox():
    # The pure-Python path raises on unpacking a <4-element bbox; the
    # native parser must error too, not silently zero-fill (ADVICE r2).
    from vision_transformer_detector._native import _native_coco_json

    for bad in (b'[1.0, 2.0]', b'[]', b'[1, 2, 3, 4, 5]'):
        doc = (b'{"annotations": [{"image_id": 1, "category_id": 2, '
               b'"bbox": ' + bad + b'}]}')
        with pytest.raises(ValueError):
            _native_coco_json.parse_instances(doc)


@needs_native
def test_native_locale_independent_numbers(instances_path):
    # strtod honors LC_NUMERIC; std::from_chars must not. Simulate a
    # comma-decimal host locale and require identical parses.
    import locale

    baseline = ann.build_annotations_from_instances(
        instances_path, use_native=True)
    for loc in ("de_DE.UTF-8", "fr_FR.UTF-8", "C.UTF-8"):
        try:
            locale.setlocale(locale.LC_NUMERIC, loc)
        except locale.Error:
            continue
        try:
            again = ann.build_annotations_from_instances(
                instances_path, use_native=True)
        finally:
            locale.setlocale(locale.LC_NUMERIC, "C")
        assert again == baseline


@needs_native
def test_native_handles_minimal_and_empty():
    from vision_transformer_detector._native import _native_coco_json

    ids, cats, boxes, n = _native_coco_json.parse_instances(
        b'{"annotations": []}')
    assert n == 0
    ids, cats, boxes, n = _native_coco_json.parse_instances(b'{}')
    assert n == 0


@needs_native
def test_native_accepts_overflowing_literals_like_python():
    # Python's json parses 1e400 as inf; the native parser must not
    # reject it (std::from_chars reports out-of-range; we clamp to
    # +/-inf like strtod — code-review round-3 finding).
    from vision_transformer_detector._native import _native_coco_json

    doc = (b'{"annotations": [{"image_id": 1, "category_id": 2, '
           b'"area": 1e400, "bbox": [1.0, 2.0, 3.0, 4.0]}]}')
    ids, cats, boxes, n = _native_coco_json.parse_instances(doc)
    assert n == 1


@needs_native
def test_native_rejects_missing_required_keys():
    # The pure-Python path KeyErrors on a missing image_id/category_id/
    # bbox; the native parser must error too, not zero-fill.
    from vision_transformer_detector._native import _native_coco_json

    for missing in (b'{"category_id": 2, "bbox": [1.0, 2.0, 3.0, 4.0]}',
                    b'{"image_id": 1, "bbox": [1.0, 2.0, 3.0, 4.0]}',
                    b'{"image_id": 1, "category_id": 2}'):
        with pytest.raises(ValueError):
            _native_coco_json.parse_instances(
                b'{"annotations": [' + missing + b']}')


@needs_native
def test_native_rejects_out_of_int64_range_ids():
    # static_cast of an out-of-range double to int64 is UB in C++; the
    # parser must fail explicitly instead (the Python path would keep an
    # arbitrary-precision int the framework cannot represent either).
    from vision_transformer_detector._native import _native_coco_json

    for value in (b"1e30", b"-1e30", b"NaN"):
        doc = (b'{"annotations": [{"image_id": ' + value +
               b', "category_id": 2, "bbox": [1.0, 2.0, 3.0, 4.0]}]}')
        with pytest.raises(ValueError):
            _native_coco_json.parse_instances(doc)


@needs_native
def test_native_tolerates_python_json_literals_in_skipped_fields():
    # json.loads accepts Infinity/-Infinity/NaN by default; a skipped
    # field holding one must not fail the parse where Python succeeds.
    from vision_transformer_detector._native import _native_coco_json

    doc = (b'{"info": {"x": Infinity, "y": -Infinity, "z": NaN}, '
           b'"annotations": [{"image_id": 1, "category_id": 2, '
           b'"score": NaN, "bbox": [1.0, 2.0, 3.0, 4.0]}]}')
    ids, cats, boxes, n = _native_coco_json.parse_instances(doc)
    assert n == 1
