"""Pin the standalone public helpers that nothing else routes through:
their semantics are part of the API surface, and an unreferenced helper
with a drifted contract is worse than no helper."""

import json

import numpy as np


def test_select_detections_matches_metric_positivity():
    """Strictly-greater thresholds, exactly like the metric's positivity
    test (vtd.py:1378-1384): objectness == threshold is NOT kept, class
    confidence derives from distance-to-nearest-integer."""
    import jax.numpy as jnp

    from vision_transformer_detector.ops.decode import (
        classification_confidence, select_detections)

    decoded = np.zeros((1, 4, 6), np.float32)
    decoded[0, 0] = (0.9, 5.0, 10, 10, 5, 5)    # kept: conf 1.0
    decoded[0, 1] = (0.5, 5.0, 10, 10, 5, 5)    # objectness AT threshold
    decoded[0, 2] = (0.9, 5.25, 10, 10, 5, 5)   # class conf 0.5 AT thresh
    decoded[0, 3] = (0.9, 5.2, 10, 10, 5, 5)    # class conf 0.6 > 0.5
    keep, class_id, conf = select_detections(jnp.asarray(decoded))
    np.testing.assert_array_equal(np.asarray(keep)[0],
                                  [True, False, False, True])
    np.testing.assert_array_equal(np.asarray(class_id)[0], [5, 5, 5, 5])
    assert abs(float(conf[0, 3]) - 0.6) < 1e-5  # (0.5 - |5.2-5|) / 0.5
    # classification_confidence is the shared primitive.
    assert float(classification_confidence(jnp.float32(5.25))) == 0.5


def test_detected_coco_ids_default_table():
    from vision_transformer_detector.data.categories import (
        CATEGORY_NAMES_TO_DETECT, detected_coco_ids)

    ids = detected_coco_ids()
    assert len(ids) == len(CATEGORY_NAMES_TO_DETECT) == 80
    assert ids[0] == 1  # person
    assert detected_coco_ids(["person", "car"]) == [1, 3]


def test_annotations_dict_save_load_roundtrip(tmp_path):
    from vision_transformer_detector.data.annotations import (
        load_annotations_dict, save_annotations_dict)

    d = {"42": [[1, 16.0, 16.0, 8.0, 8.0, 64.0]]}
    path = str(tmp_path / "ann.json")
    save_annotations_dict(d, path)
    assert load_annotations_dict(path) == d
    assert json.load(open(path)) == d  # plain-JSON on disk


def test_is_quantized_discriminates_layers():
    from vision_transformer_detector.kernels.quantization import (
        is_quantized)

    assert is_quantized({"kernel_q": 1, "scale": 2, "bias": 3})
    assert not is_quantized({"kernel": 1, "bias": 3})
    assert not is_quantized(np.zeros(3))
