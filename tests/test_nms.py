"""On-device NMS / top-k postprocessing vs a NumPy greedy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from vision_transformer_detector.ops.nms import (
    detection_scores,
    non_max_suppression,
    postprocess_detections,
    top_k_detections,
)


def _numpy_nms(boxes, scores, class_ids, iou_threshold, per_class):
    """Greedy reference NMS (cxcyhw)."""
    def iou_np(a, b):
        ax0, ax1 = a[0] - a[3] / 2, a[0] + a[3] / 2
        ay0, ay1 = a[1] - a[2] / 2, a[1] + a[2] / 2
        bx0, bx1 = b[0] - b[3] / 2, b[0] + b[3] / 2
        by0, by1 = b[1] - b[2] / 2, b[1] + b[2] / 2
        iw = max(0.0, min(ax1, bx1) - max(ax0, bx0))
        ih = max(0.0, min(ay1, by1) - max(ay0, by0))
        inter = iw * ih
        union = a[2] * a[3] + b[2] * b[3] - inter
        return inter / union if union > 0 else 0.0

    order = np.argsort(-scores)
    keep = np.zeros(len(scores), bool)
    suppressed = np.zeros(len(scores), bool)
    for idx in order:
        if suppressed[idx] or scores[idx] <= 0:
            continue
        keep[idx] = True
        for jdx in order:
            if jdx == idx or suppressed[jdx] or keep[jdx]:
                continue
            if per_class and class_ids[jdx] != class_ids[idx]:
                continue
            if iou_np(boxes[idx], boxes[jdx]) > iou_threshold:
                suppressed[jdx] = True
    return keep


def test_nms_suppresses_overlaps():
    boxes = jnp.asarray([[[50, 50, 20, 20],
                          [51, 51, 20, 20],     # overlaps box 0
                          [200, 200, 30, 30]]], jnp.float32)
    scores = jnp.asarray([[0.9, 0.8, 0.7]])
    classes = jnp.asarray([[1, 1, 2]])
    keep = non_max_suppression(boxes, scores, classes, iou_threshold=0.5)
    np.testing.assert_array_equal(np.asarray(keep[0]), [True, False, True])


def test_nms_per_class_keeps_other_classes():
    boxes = jnp.asarray([[[50, 50, 20, 20],
                          [51, 51, 20, 20]]], jnp.float32)
    scores = jnp.asarray([[0.9, 0.8]])
    classes = jnp.asarray([[1, 2]])
    keep = non_max_suppression(boxes, scores, classes, per_class=True)
    np.testing.assert_array_equal(np.asarray(keep[0]), [True, True])
    keep = non_max_suppression(boxes, scores, classes, per_class=False)
    np.testing.assert_array_equal(np.asarray(keep[0]), [True, False])


@pytest.mark.parametrize("per_class", [True, False])
def test_nms_matches_numpy_oracle(per_class):
    rng = np.random.default_rng(0)
    n = 24
    boxes = np.stack([
        rng.uniform(20, 600, n), rng.uniform(20, 600, n),
        rng.uniform(10, 120, n), rng.uniform(10, 120, n)], axis=1
    ).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    classes = rng.integers(0, 3, n).astype(np.int32)
    keep = non_max_suppression(
        boxes[None], jnp.asarray(scores)[None], jnp.asarray(classes)[None],
        iou_threshold=0.45, per_class=per_class)
    expected = _numpy_nms(boxes, scores, classes, 0.45, per_class)
    np.testing.assert_array_equal(np.asarray(keep[0]), expected)


def test_top_k_detections():
    decoded = np.zeros((1, 5, 6), np.float32)
    decoded[0, :, 0] = [0.9, 0.2, 0.95, 0.5, 0.1]   # objectness
    decoded[0, :, 1] = [3.0, 1.0, 7.0, 2.0, 0.0]    # exact class -> conf 1
    decoded[0, :, 2:] = [100, 100, 20, 20]
    scores, classes, boxes = top_k_detections(jnp.asarray(decoded), k=2)
    np.testing.assert_allclose(np.asarray(scores[0]), [0.95, 0.9], rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(classes[0]), [7, 3])
    assert boxes.shape == (1, 2, 4)


def test_postprocess_detections_pipeline():
    decoded = np.zeros((1, 4, 6), np.float32)
    decoded[0, 0] = (0.9, 5.0, 50, 50, 20, 20)
    decoded[0, 1] = (0.8, 5.0, 51, 51, 20, 20)   # suppressed by 0
    decoded[0, 2] = (0.7, 9.0, 200, 200, 30, 30)
    decoded[0, 3] = (0.0, 5.0, 10, 10, 5, 5)     # zero score
    scores, classes, boxes, valid = postprocess_detections(
        jnp.asarray(decoded), k=3, iou_threshold=0.5)
    np.testing.assert_array_equal(np.asarray(valid[0]), [True, True, False])
    np.testing.assert_array_equal(np.asarray(classes[0, :2]), [5, 9])


def test_detection_scores_combines_confidences():
    decoded = np.zeros((1, 2, 6), np.float32)
    decoded[0, 0] = (0.8, 4.0, 0, 0, 0, 0)      # class conf 1
    decoded[0, 1] = (1.0, 4.25, 0, 0, 0, 0)     # class conf 0.5
    scores = detection_scores(jnp.asarray(decoded))
    np.testing.assert_allclose(np.asarray(scores[0]), [0.8, 0.5], rtol=1e-6)
