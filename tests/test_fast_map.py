"""Jitted on-device mAP vs the host NumPy oracle.

The host implementation (metrics/mean_average_precision.py) passes the 13
reference oracles; here the jitted twin must match it on those oracles and
on randomized prediction streams (including multi-batch streaming with ring
evictions)."""

import numpy as np
import pytest

from vision_transformer_detector.config import DetectorConfig
from vision_transformer_detector.metrics.fast_map import (
    JitMeanAveragePrecision)
from vision_transformer_detector.metrics.mean_average_precision import (
    MeanAveragePrecision)

CFG = DetectorConfig()
SHAPE = (10, 6)


def empty_labels(batch):
    label = np.ones((batch, *SHAPE), np.float32) * -8.0
    label[..., 0] = 0.0
    return label


def both(label, prediction, batches=None):
    """Run both metrics on the same stream, return (numpy, jit) results."""
    host = MeanAveragePrecision(CFG)
    device = JitMeanAveragePrecision(CFG)
    stream = batches if batches is not None else [(label, prediction)]
    for y_true, y_pred in stream:
        host.update_state(y_true, y_pred, use_transform_predictions=False)
        device.update_state(y_true, y_pred, use_transform_predictions=False)
    return float(host.result()), float(device.result())


# ---- the 13 oracle scenarios, asserted against their expected values ------

def oracle_case(name):
    label = empty_labels(1)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    if name == "perfect":
        return label, label.copy(), 1.0
    if name == "two_categories":
        label[0, 2] = (1, 78, 9.5, 9.5, 5, 5)
        return label, label.copy(), 1.0
    if name == "iou_064":
        pred = label.copy(); pred[..., -4:] = (9.5, 9.5, 8, 8)
        return label, pred, 0.3
    if name == "iou_049":
        pred = label.copy(); pred[..., -4:] = (9.5, 9.5, 7, 7)
        return label, pred, 0.0
    if name == "low_objectness":
        pred = label.copy(); pred[0, 1, 0] = 0.49
        return label, pred, 0.0
    if name == "false_positive":
        pred = label.copy(); pred[0, 2] = (0.51, 79, 10.2, 10.2, 9.9, 9.9)
        return label, pred, 0.75
    if name == "low_class_conf":
        pred = label.copy(); pred[0, 1, 1] = 79.255
        return label, pred, 0.0
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "perfect", "two_categories", "iou_064", "iou_049",
    "low_objectness", "false_positive", "low_class_conf"])
def test_single_image_oracles(name):
    label, pred, expected = oracle_case(name)
    host, device = both(label, pred)
    assert host == pytest.approx(expected)
    assert device == pytest.approx(expected, abs=1e-6)


def test_two_image_oracles():
    label = empty_labels(2)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    label[1, 0] = label[0, 1]
    pred = label.copy()
    pred[1, 0, 1] = 79.001
    pred[1, 0, -4:] = (9.5, 9.5, 7, 7)
    host, device = both(label, pred)
    assert host == pytest.approx(0.375)
    assert device == pytest.approx(0.375, abs=1e-6)


def test_two_categories_two_images():
    label = empty_labels(2)
    label[0, 1] = (1, 79, 10.2, 10.2, 10, 10)
    label[0, 2] = (1, 78, 10.2, 10.2, 10, 10)
    label[1] = label[0]
    pred = label.copy()
    pred[0, 1, 1] = 79.005
    pred[0, 1, -4:] = (9.5, 9.5, 7, 7)
    host, device = both(label, pred)
    assert host == pytest.approx(0.6875)
    assert device == pytest.approx(0.6875, abs=1e-6)


# ---- randomized equivalence ------------------------------------------------

def random_stream(seed, batches=3, batch_size=2, num_classes=6):
    """Plausible detection streams: boxes jittered around labels, a few
    classes, some empty slots, some below-threshold predictions."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        label = np.full((batch_size, 17, 6), -8.0, np.float32)
        label[..., 0] = 0.0
        pred = label.copy()
        for b in range(batch_size):
            n = int(rng.integers(0, 6))
            for s in range(n):
                cls = float(rng.integers(0, num_classes))
                h, w = rng.uniform(20, 120, 2)
                cx = rng.uniform(w / 2, 608 - w / 2)
                cy = rng.uniform(h / 2, 608 - h / 2)
                label[b, s] = (1, cls, cx, cy, h, w)
                # prediction: jittered box, sometimes wrong class/low conf
                jitter = rng.uniform(0.7, 1.3)
                obj = float(rng.uniform(0.3, 1.0))
                cls_pred = cls + float(rng.uniform(-0.6, 0.6))
                pred[b, s] = (obj, cls_pred, cx + rng.uniform(-15, 15),
                              cy + rng.uniform(-15, 15), h * jitter,
                              w * jitter)
            # occasional extra false positive
            if rng.uniform() < 0.5:
                s = 16
                pred[b, s] = (float(rng.uniform(0.5, 1.0)),
                              float(rng.integers(0, num_classes)),
                              300, 300, 50, 50)
        out.append((label, pred))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_randomized_equivalence(seed):
    stream = random_stream(seed)
    host, device = both(None, None, batches=stream)
    assert device == pytest.approx(host, abs=1e-5)


def test_ring_eviction_equivalence():
    """More related images than the ring holds (> latest_related_images)
    exercises eviction on both sides."""
    stream = random_stream(7, batches=6, batch_size=2, num_classes=2)
    host, device = both(None, None, batches=stream)
    assert device == pytest.approx(host, abs=1e-5)


def test_reset_state():
    metric = JitMeanAveragePrecision(CFG)
    label, pred, _ = oracle_case("perfect")
    metric.update_state(label, pred, use_transform_predictions=False)
    metric.reset_state()
    assert metric.result() == pytest.approx(0.0)


def test_boundary_class_ids():
    """Classes 0 and 79 (the -8 sentinel must not collide with class 0)."""
    label = empty_labels(2)
    label[0, 0] = (1, 0, 100.0, 100.0, 50.0, 50.0)
    label[1, 0] = (1, 79, 200.0, 200.0, 40.0, 40.0)
    pred = label.copy()
    host, device = both(label, pred)
    assert host == pytest.approx(1.0)
    assert device == pytest.approx(1.0, abs=1e-6)


def test_empty_stream():
    """No labels, no positive predictions anywhere -> mAP 0, no NaN."""
    label = empty_labels(2)
    host, device = both(label, label.copy())
    assert host == pytest.approx(0.0)
    assert device == pytest.approx(0.0, abs=1e-6)


def test_many_objects_same_class():
    """More same-class labels than bboxes_per_image exercises the match cap
    (vtd.py:1754-1758)."""
    rng = np.random.default_rng(11)
    label = np.full((1, 17, 6), -8.0, np.float32)
    label[..., 0] = 0.0
    for s in range(17):
        h, w = rng.uniform(20, 60, 2)
        cx = 30.0 + s * 33.0
        cy = 300.0
        label[0, s] = (1, 7, cx, cy, h, w)
    pred = label.copy()
    # jitter some boxes below/above the IoU threshold
    pred[0, ::2, -2:] *= 0.65
    host, device = both(label, pred)
    assert device == pytest.approx(host, abs=1e-5)


@pytest.mark.parametrize("seed", [10, 20, 30])
def test_randomized_equivalence_more_classes(seed):
    stream = random_stream(seed, batches=4, batch_size=3, num_classes=80)
    host, device = both(None, None, batches=stream)
    assert device == pytest.approx(host, abs=1e-5)


def test_max_iou_tie_equivalence():
    """Two predictions tie at max IoU with one label box: the reference
    (vtd.py:1694-1752) removes ALL tied boxes and takes the first one's
    confidence. The jitted matcher must agree with the host oracle
    (round-1 advisor finding: argmax-only removal diverged)."""
    label = empty_labels(1)
    label[0, 0] = (1, 5, 100.0, 100.0, 40.0, 40.0)
    label[0, 1] = (1, 5, 300.0, 300.0, 30.0, 30.0)

    pred = empty_labels(1)
    pred[..., :] = -8.0
    # Slots 0 and 1: identical boxes (exact IoU tie) overlapping label 0,
    # different class confidences (5.1 vs 4.9 -> conf 0.8).
    pred[0, 0] = (0.9, 5.1, 100.0, 100.0, 40.0, 40.0)
    pred[0, 1] = (0.9, 4.9, 100.0, 100.0, 40.0, 40.0)
    # Slot 2 matches label 1.
    pred[0, 2] = (0.9, 5.0, 300.0, 300.0, 30.0, 30.0)

    host, device = both(label, pred)
    assert device == pytest.approx(host, abs=1e-6)
    # The tie consumed BOTH boxes: no leftover false positive, so with both
    # labels matched perfectly at high IoU the AP is well above zero.
    assert host > 0.5


def test_inert_padding_rows_are_noop():
    """Multi-process eval pads uneven rounds with (EMPTY labels, zero
    decoded) rows (parallel.data.synced_global_eval_batches); the design
    depends on such a row being an exact metric no-op, wherever it lands
    in the stream and in nonzero-AP states."""
    label = empty_labels(2)
    label[0, 0] = (1, 5, 100.0, 100.0, 40.0, 40.0)
    label[1, 0] = (1, 7, 200.0, 200.0, 60.0, 60.0)
    pred = empty_labels(2)
    pred[..., :] = -8.0
    pred[0, 0] = (0.9, 5.0, 102.0, 102.0, 38.0, 38.0)
    pred[0, 1] = (0.8, 5.0, 300.0, 300.0, 20.0, 20.0)  # false positive
    pred[1, 0] = (0.9, 7.0, 200.0, 200.0, 60.0, 60.0)

    pad_label = empty_labels(1)
    pad_label[..., 0] = -8.0  # fully EMPTY_SLOT rows, as the padder emits
    pad_pred = np.zeros((1, *SHAPE), np.float32)  # objectness 0

    plain = JitMeanAveragePrecision(CFG)
    plain.update_state(label, pred, use_transform_predictions=False)
    want = plain.result()
    assert want > 0.0  # meaningful state, not the all-zero degenerate

    padded = JitMeanAveragePrecision(CFG)
    padded.update_state(np.concatenate([pad_label, label[:1], pad_label]),
                        np.concatenate([pad_pred, pred[:1], pad_pred]),
                        use_transform_predictions=False)
    padded.update_state(np.concatenate([label[1:], pad_label]),
                        np.concatenate([pred[1:], pad_pred]),
                        use_transform_predictions=False)
    assert padded.result() == pytest.approx(want, abs=1e-6)


def test_differing_label_and_prediction_slot_counts():
    """The host twin accepts labels and predictions with different slot
    counts (its reference tests use 10-slot labels against 17-slot
    predictions); the jitted metric must too — the matcher broadcasts
    each label box to the PREDICTION slot count, not the label's."""
    label = empty_labels(2)                      # (2, 10, 6)
    label[0, 0] = (1, 5, 100.0, 100.0, 40.0, 40.0)
    label[1, 0] = (1, 7, 200.0, 200.0, 60.0, 60.0)

    pred = np.full((2, 17, 6), -8.0, np.float32)  # (2, 17, 6)
    pred[..., 0] = 0.0
    pred[0, 0] = (0.9, 5.0, 102.0, 102.0, 38.0, 38.0)
    pred[0, 1] = (0.8, 5.0, 300.0, 300.0, 20.0, 20.0)  # false positive
    pred[1, 0] = (0.9, 7.0, 200.0, 200.0, 60.0, 60.0)

    host = MeanAveragePrecision(CFG)
    device = JitMeanAveragePrecision(CFG)
    host.update_state(label, pred, use_transform_predictions=False)
    device.update_state(label, pred, use_transform_predictions=False)
    assert float(device.result()) == pytest.approx(
        float(host.result()), abs=1e-6)
    assert float(host.result()) > 0.0


def test_non_integral_label_category_marks_truncated_class():
    """The host oracle truncates label categories (astype(np.int32)) when
    marking showed_up classes; the jitted metric must mark the same class
    for a non-integral (corrupt/interpolated) category like 2.4."""
    label = empty_labels(1)
    label[0, 0] = (1, 2.4, 100.0, 100.0, 40.0, 40.0)
    pred = empty_labels(1)
    pred[..., :] = -8.0
    pred[0, 0] = (0.9, 5.0, 200.0, 200.0, 30.0, 30.0)  # unrelated class

    host, device = both(label, pred)
    assert device == pytest.approx(host, abs=1e-6)
