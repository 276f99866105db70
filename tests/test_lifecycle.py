"""Full deployment lifecycle in one test: CLI train -> checkpoint ->
CLI export (StableHLO bundle, baked postprocess) -> HTTP serving from the
frozen artifact -> official COCO-protocol scoring of the served responses.

Every stage here is covered pairwise elsewhere (test_cli, test_export,
test_serving, test_coco_eval); this test proves the stages compose with
real files and real sockets between them — the workflow a production user
actually runs (README quickstart: train, export, serve --from-export).
"""

import io
import json
import urllib.request

import numpy as np
import pytest

from vision_transformer_detector.cli import main


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from PIL import Image, ImageDraw

    root = tmp_path_factory.mktemp("coco_lifecycle")
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(7)
    annotations = {}
    for i in range(4):
        img = Image.new("RGB", (96, 80), (20, 30, 40))
        draw = ImageDraw.Draw(img)
        x0, y0 = int(rng.integers(5, 40)), int(rng.integers(5, 30))
        w, h = 30, 28
        draw.rectangle((x0, y0, x0 + w, y0 + h), fill=(250, 220, 30))
        img.save(images / f"{i:012d}.jpg")
        annotations[str(i)] = [
            [1, x0 + w / 2, y0 + h / 2, float(h), float(w), float(w * h)]]
    (root / "ann.json").write_text(json.dumps(annotations))
    return {"images": images, "annotations": annotations, "root": root}


def test_train_export_serve_score(dataset, tmp_path, capsys):
    from vision_transformer_detector.data.categories import (
        COCO_ID_TO_MODEL_ID)
    from vision_transformer_detector.metrics.coco_eval import (
        CocoEvaluator)
    from vision_transformer_detector.serving import (
        DetectionServer, ExportedDetectionService)

    ckpt = str(tmp_path / "ckpt")
    artifact = str(tmp_path / "artifact")

    # 1. Train a couple of epochs through the CLI.
    main(["train", "--preset", "tiny_96", "--batch-size", "4",
          "--checkpoint-dir", ckpt,
          "--train-images", str(dataset["images"]),
          "--train-annotations", str(dataset["root"] / "ann.json"),
          "--epochs", "2", "--learning-rate", "1e-4"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(result["final_loss"])

    # 2. Export the trained checkpoint as a frozen multi-batch bundle
    #    with NMS/top-k baked into the graphs.
    main(["export", "--preset", "tiny_96", "--checkpoint-dir", ckpt,
          "--restore", "final", "--output-dir", artifact,
          "--batch-sizes", "1", "2", "--bake-postprocess",
          "--score-threshold", "-1.0"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["exported"] == artifact
    assert result["postprocess"]["score_threshold"] == -1.0

    # 3. Serve the artifact over real HTTP (the serving host path that
    #    never imports model-building code) and post every image.
    service = ExportedDetectionService(artifact, score_threshold=-1.0)
    server = DetectionServer(service, port=0, batching=True,
                             max_batch=2)
    responses = {}
    try:
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        for path in sorted(dataset["images"].iterdir()):
            req = urllib.request.Request(
                f"{base}/predict", data=path.read_bytes(),
                headers={"Content-Type": "image/jpeg"})
            with urllib.request.urlopen(req, timeout=120) as r:
                responses[path.stem.lstrip("0") or "0"] = json.loads(
                    r.read())
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        server.stop()

    assert stats["requests"]["ok"] == 4
    assert stats["batching"]["images_served"] == 4

    # 4. Score the served detections (original-frame pixels) against the
    #    dataset's ground truth with the official-protocol evaluator.
    evaluator = CocoEvaluator()
    for image_id, annotation_rows in dataset["annotations"].items():
        body = responses[image_id]
        assert body["image_size"] == {"height": 80, "width": 96}
        det_boxes, det_scores, det_categories = [], [], []
        for det in body["detections"]:
            box = det["box"]
            det_boxes.append((box["cx"] - box["w"] / 2.0,
                              box["cy"] - box["h"] / 2.0,
                              box["w"], box["h"]))
            det_scores.append(det["score"])
            det_categories.append(det["class_id"])
        gt_boxes = [(cx - w / 2.0, cy - h / 2.0, w, h)
                    for _, cx, cy, h, w, _ in annotation_rows]
        gt_categories = [COCO_ID_TO_MODEL_ID[int(row[0])]
                         for row in annotation_rows]
        gt_areas = [row[5] for row in annotation_rows]
        evaluator.add_image(
            gt_boxes=np.asarray(gt_boxes, np.float64).reshape(-1, 4),
            gt_categories=gt_categories, gt_areas=gt_areas,
            det_boxes=np.asarray(det_boxes, np.float64).reshape(-1, 4),
            det_scores=det_scores, det_categories=det_categories)
    summary = evaluator.evaluate().summarize()
    # A 2-epoch model has no accuracy to assert; the claim is that the
    # whole chain produces protocol-valid numbers.
    for key in ("AP", "AP50", "AR@1", "AR@100"):
        assert summary[key] == -1.0 or 0.0 <= summary[key] <= 1.0
    assert summary["AP"] <= summary["AP50"] or summary["AP50"] == -1.0
