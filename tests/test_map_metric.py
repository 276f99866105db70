"""The 13 mAP oracles from the reference test suite.

Each case reproduces testcases_vision_transformer_detector.py:11-734 with
its exact expected value; these are the bit-compat acceptance tests for the
metric (SURVEY.md §4). Predictions are fed already-decoded via the
``use_transform_predictions=False`` seam, exactly like the reference tests.
"""

import numpy as np
import pytest

from vision_transformer_detector.config import DetectorConfig
from vision_transformer_detector.metrics.mean_average_precision import (
    MeanAveragePrecision,
)

SHAPE = (10, 6)


def empty_labels(batch: int) -> np.ndarray:
    label = np.ones((batch, *SHAPE), np.float32) * -8.0
    label[..., 0] = 0.0
    return label


@pytest.fixture()
def mean_ap() -> MeanAveragePrecision:
    return MeanAveragePrecision(DetectorConfig())


def run(mean_ap, label, prediction):
    mean_ap.reset_state()
    mean_ap.update_state(y_true=label, y_pred=prediction,
                         use_transform_predictions=False)
    return float(mean_ap.result())


def test_1_one_image_one_category(mean_ap):
    """Perfect single-box match -> mAP 1 (testcases:49-89)."""
    label = empty_labels(1)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    assert run(mean_ap, label, label) == pytest.approx(1.0)


def test_2_one_image_two_categories(mean_ap):
    """Two perfect boxes of two classes -> mAP 1 (testcases:91-142)."""
    label = empty_labels(1)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    label[0, 2] = (1, 78, 9.5, 9.5, 5, 5)
    assert run(mean_ap, label, label) == pytest.approx(1.0)


def test_3_one_image_low_iou(mean_ap):
    """IoU 0.64 passes 3 of 10 thresholds -> mAP 0.3 (testcases:144-195)."""
    label = empty_labels(1)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    prediction = label.copy()
    prediction[..., -4:] = (9.5, 9.5, 8, 8)
    assert run(mean_ap, label, prediction) == pytest.approx(0.3)


def test_4_one_image_zero_ap(mean_ap):
    """IoU 0.49 < 0.5 -> no match -> mAP 0 (testcases:197-248)."""
    label = empty_labels(1)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    prediction = label.copy()
    prediction[..., -4:] = (9.5, 9.5, 7, 7)
    assert run(mean_ap, label, prediction) == pytest.approx(0.0)


def test_5_1_one_image_low_objectness(mean_ap):
    """Objectness 0.49 below threshold -> mAP 0 (testcases:250-303)."""
    label = empty_labels(1)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    prediction = label.copy()
    prediction[0, 1, 0] = 0.49
    assert run(mean_ap, label, prediction) == pytest.approx(0.0)


def test_5_2_two_predictions_one_false_positive(mean_ap):
    """Perfect match + extra false positive -> mAP 0.75
    (testcases:305-370)."""
    label = empty_labels(1)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    prediction = label.copy()
    prediction[0, 2] = (0.51, 79, 10.2, 10.2, 9.9, 9.9)
    assert run(mean_ap, label, prediction) == pytest.approx(0.75)


def test_6_one_image_low_classification_confidence(mean_ap):
    """Class confidence 0.49 below threshold -> mAP 0 (testcases:372-426)."""
    label = empty_labels(1)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    prediction = label.copy()
    prediction[0, 1, 1] = 79.255
    assert run(mean_ap, label, prediction) == pytest.approx(0.0)


def test_7_two_images_one_category(mean_ap):
    """Two images, both perfect -> mAP 1 (testcases:428-471)."""
    label = empty_labels(2)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    label[1, 5] = label[0, 1]
    assert run(mean_ap, label, label) == pytest.approx(1.0)


def test_8_two_images_one_zero_ap(mean_ap):
    """One image IoU 1, one image IoU 0.49 -> mAP 0.375
    (testcases:473-530)."""
    label = empty_labels(2)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    label[1, 0] = label[0, 1]
    prediction = label.copy()
    prediction[1, 0, 1] = 79.001
    prediction[1, 0, -4:] = (9.5, 9.5, 7, 7)
    assert run(mean_ap, label, prediction) == pytest.approx(0.375)


def test_9_one_objectness_below_threshold(mean_ap):
    """One perfect box + one objectness 0.49 -> mAP 0.5
    (testcases:532-585)."""
    label = empty_labels(2)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    label[1, 0] = label[0, 1]
    prediction = label.copy()
    prediction[1, 0, 0] = 0.49
    assert run(mean_ap, label, prediction) == pytest.approx(0.5)


def test_10_classification_confidence_below_threshold(mean_ap):
    """One perfect box + one class confidence 0.4 -> mAP 0.5
    (testcases:587-641)."""
    label = empty_labels(2)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    label[1, 0] = label[0, 1]
    prediction = label.copy()
    prediction[1, 0, 1] = 79.3
    assert run(mean_ap, label, prediction) == pytest.approx(0.5)


def test_11_two_categories_two_images(mean_ap):
    """Class APs 0.375 and 1 -> mAP 0.6875 (testcases:643-710)."""
    label = empty_labels(2)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    label[0, 2] = (1, 78, 10.2, 10.2, 10, 10)
    label[1] = label[0]
    prediction = label.copy()
    prediction[0, 1, 1] = 79.005
    prediction[0, 1, -4:] = (9.5, 9.5, 7, 7)
    assert run(mean_ap, label, prediction) == pytest.approx(0.6875)


def test_12_reset_metric(mean_ap):
    """reset_state zeroes all three state tensors (testcases:713-734)."""
    label = empty_labels(1)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    run(mean_ap, label, label)  # populate state first
    mean_ap.reset_state()
    assert np.all(mean_ap.latest_positive_bboxes == 0)
    assert np.all(mean_ap.labels_quantity_per_image == 0)
    assert not mean_ap.showed_up_classes.any()
    assert float(mean_ap.result()) == pytest.approx(0.0)


def test_streaming_over_batches(mean_ap):
    """Updates accumulate across calls: feeding test-8's two images in two
    separate batches must give the same 0.375."""
    label = empty_labels(2)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    label[1, 0] = label[0, 1]
    prediction = label.copy()
    prediction[1, 0, 1] = 79.001
    prediction[1, 0, -4:] = (9.5, 9.5, 7, 7)

    mean_ap.reset_state()
    mean_ap.update_state(label[:1], prediction[:1],
                         use_transform_predictions=False)
    mean_ap.update_state(label[1:], prediction[1:],
                         use_transform_predictions=False)
    assert float(mean_ap.result()) == pytest.approx(0.375)
