"""Real-annotation end-to-end slice (VERDICT round-1 item 6).

Drives the full D2->D9->M17 path on REAL annotation content from the
reference's shipped val_annotations_dict.json: load the dict, render
deterministic JPEGs at the aspect ratios the annotations imply, run the
public dataset factory, golden-check the label tensors, and push
label-derived predictions through the streaming mAP (deterministic 1.0).
Reference path: vtu.py:82-220 (dict), vtu.py:268-507 (labels),
vtd.py:1268-2060 (metric)."""

import json
import os

import numpy as np
import pytest

from real_annotation_fixture import (
    GOLDEN_LABELS_PATH,
    PICKED_IDS,
    VAL_DICT_PATH,
    build_image_dir,
    canvas_size,
)
from vision_transformer_detector import api
from vision_transformer_detector.config import DetectorConfig
from vision_transformer_detector.data.annotations import (
    labels_from_annotations, load_annotations_dict)
from vision_transformer_detector.metrics.mean_average_precision import (
    MeanAveragePrecision)

pytestmark = pytest.mark.skipif(
    not os.path.exists(VAL_DICT_PATH),
    reason="reference val_annotations_dict.json not mounted")

CFG = DetectorConfig()  # reference 608px


@pytest.fixture(scope="module")
def annotations():
    return load_annotations_dict(VAL_DICT_PATH)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory, annotations):
    root = tmp_path_factory.mktemp("real_val_images")
    build_image_dir(str(root), annotations)
    return str(root)


def test_labels_match_committed_golden(annotations):
    """Label tensors from real val annotations match the committed golden
    (regenerate with the snippet in the golden file's sibling README or by
    re-running the labels below after an intentional change)."""
    golden = np.load(GOLDEN_LABELS_PATH)
    for image_id in PICKED_IDS:
        records = annotations[image_id]
        labels = labels_from_annotations(
            records, canvas_size(records), CFG)
        np.testing.assert_allclose(
            labels, golden[image_id], atol=1e-5, err_msg=image_id)


def test_pipeline_yields_golden_labels(annotations, image_dir):
    """The public dataset factory (coco_data_vision_transformer) produces
    exactly the golden labels when fed the rendered JPEGs + real dict."""
    golden = np.load(GOLDEN_LABELS_PATH)
    ds = api.coco_data_vision_transformer(
        image_dir, annotations, images_range=(0, len(PICKED_IDS)),
        batch_size=len(PICKED_IDS), config=CFG)
    batches = list(ds)
    assert len(batches) == 1
    images, labels = batches[0]
    assert images.shape == (len(PICKED_IDS), 608, 608, 3)
    assert float(images.min()) >= -1.0 and float(images.max()) <= 1.0
    # Dataset order is sorted by filename = sorted by int id = PICKED_IDS
    # order (ids were picked ascending).
    for i, image_id in enumerate(PICKED_IDS):
        np.testing.assert_allclose(labels[i], golden[image_id], atol=1e-5,
                                   err_msg=image_id)


def test_metric_on_real_labels_is_deterministically_one(annotations):
    """Feeding each image's golden labels back as decoded predictions must
    score mAP 1.0: every box matches itself at IoU 1.0 with integer class
    values (class confidence 1.0)."""
    golden = np.load(GOLDEN_LABELS_PATH)
    metric = MeanAveragePrecision(CFG)
    for image_id in PICKED_IDS:
        labels = golden[image_id][None]  # (1, 17, 6)
        metric.update_state(labels, labels.copy(),
                            use_transform_predictions=False)
    assert float(metric.result()) == pytest.approx(1.0)

    # The jitted metric agrees on the same real-annotation stream.
    from vision_transformer_detector.metrics.fast_map import (
        JitMeanAveragePrecision)
    fast = JitMeanAveragePrecision(CFG)
    for image_id in PICKED_IDS:
        labels = golden[image_id][None]
        fast.update_state(labels, labels.copy(),
                          use_transform_predictions=False)
    assert fast.result() == pytest.approx(1.0, abs=1e-6)


@pytest.mark.slow
def test_cli_evaluate_on_real_annotations(annotations, image_dir, tmp_path,
                                          capsys):
    """CLI `evaluate` runs the whole stack (pipeline -> model -> decode ->
    streaming mAP) over the real annotation content."""
    from vision_transformer_detector.cli import main

    ann_path = str(tmp_path / "val_subset.json")
    with open(ann_path, "w") as f:
        json.dump({k: annotations[k] for k in PICKED_IDS}, f)

    main(["evaluate", "--preset", "tiny_96", "--batch-size", "2",
          "--val-images", image_dir, "--val-annotations", ann_path,
          "--checkpoint-dir", str(tmp_path / "ckpt")])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= result["mAP"] <= 1.0
