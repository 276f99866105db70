"""Worked end-to-end walkthrough: dataset -> train -> evaluate -> plot ->
visualize -> export -> serve.

The reference's onboarding surface is its executable notebook
(vision_transformer_detector.ipynb cells 3-18: build the annotation dict,
construct the tf.data pipeline, train with the AP callback, plot the
curves, visualize detections, run predict). This script walks the same
arc through this package's public API, end to end on a throwaway
directory, with every stage's CLI equivalent noted inline.

It is sized to run green on a plain CPU in a couple of minutes
(tiny_96 preset, 16 images, 40 epochs) — enough to watch the loss fall
and every artifact get produced, not to converge; for the reference's
actual AP-1.0 overfit trajectory run examples/overfit_demo.py:

    python examples/end_to_end.py [--workdir DIR] [--epochs 40]

Prints one JSON line per stage and a final summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import urllib.request

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def stage(name, **info):
    print(json.dumps({"stage": name, **info}), flush=True)


# ---------------------------------------------------------------------------
# Stage 1 — build a small detection dataset ON DISK.
#
# The reference starts from COCO instances JSON + image files and builds its
# "annotation dict" {image_id: [[category, cx, cy, h, w, area], ...]}
# (vision_transformer_utilities.py:82-220). Here we synthesise 16 images —
# each a textured background with 1-3 solid rectangles — write them as
# JPEGs, and record matching annotations in the same dict format.
# CLI equivalent for real COCO: the dict ships as JSON and loads with
# data.annotations.load_annotations_dict / build_annotations_from_instances.
# ---------------------------------------------------------------------------
def build_dataset(image_dir: str, count: int = 16, seed: int = 3):
    from PIL import Image

    # Real COCO category ids (person=1, car=3, dog=18): labels_from_
    # annotations maps them through the embedded 80-category table.
    categories = [1, 3, 18]
    rng = np.random.default_rng(seed)
    os.makedirs(image_dir, exist_ok=True)
    annotations = {}
    for i in range(count):
        h, w = int(rng.integers(80, 160)), int(rng.integers(80, 160))
        img = rng.integers(20, 90, (h, w, 3)).astype(np.uint8)
        records = []
        for _ in range(int(rng.integers(1, 4))):
            bh = float(rng.uniform(h * 0.25, h * 0.6))
            bw = float(rng.uniform(w * 0.25, w * 0.6))
            cy = float(rng.uniform(bh / 2 + 1, h - bh / 2 - 1))
            cx = float(rng.uniform(bw / 2 + 1, w - bw / 2 - 1))
            cat = int(rng.choice(categories))
            y0, y1 = int(cy - bh / 2), int(cy + bh / 2)
            x0, x1 = int(cx - bw / 2), int(cx + bw / 2)
            img[y0:y1, x0:x1] = (40 * cat % 200 + 30, 90 * cat % 200 + 30,
                                 150 * cat % 200 + 30)
            # Annotation record: [category, cx, cy, h, w, area] in
            # ORIGINAL-image pixels, area-sorted like the reference's.
            records.append([cat, cx, cy, bh, bw, bh * bw])
        records.sort(key=lambda r: -r[5])
        image_id = 1000 + i
        Image.fromarray(img).save(
            os.path.join(image_dir, f"{image_id:012d}.jpg"), quality=92)
        annotations[str(image_id)] = records
    return annotations


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workdir", default=None,
                        help="output directory (default: a temp dir)")
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--images", type=int, default=16)
    args = parser.parse_args()

    workdir = args.workdir or tempfile.mkdtemp(prefix="vtd_e2e_")
    image_dir = os.path.join(workdir, "images")

    from vision_transformer_detector.config import (
        LossConfig, TrainConfig, get_config)
    from vision_transformer_detector.data.annotations import (
        save_annotations_dict, load_annotations_dict)
    from vision_transformer_detector.data.pipeline import (
        CocoDetectionDataset, list_image_paths)

    annotations = build_dataset(image_dir, args.images)
    ann_path = os.path.join(workdir, "annotations.json")
    save_annotations_dict(annotations, ann_path)     # ships as plain JSON
    annotations = load_annotations_dict(ann_path)    # ... and loads back
    stage("dataset", images=args.images, dir=image_dir,
          annotations=ann_path)

    # -----------------------------------------------------------------
    # Stage 2 — train with eval cadence + best-AP checkpointing.
    # The reference notebook's cell 7: model.fit with SaveModelHighestAP
    # (warm-up epochs, eval every skip_epochs, keep the best-AP weights).
    # CLI: python -m vision_transformer_detector.cli train \
    #          --train-images ... --train-annotations ... --preset tiny_96
    # -----------------------------------------------------------------
    from vision_transformer_detector.train.trainer import Trainer

    config = get_config("tiny_96")
    train_config = TrainConfig(
        learning_rate=3e-4, batch_size=4, epochs=args.epochs,
        epochs_warm_up=10, skip_epochs=10)
    metrics_path = os.path.join(workdir, "metrics.jsonl")
    trainer = Trainer(config, LossConfig(), train_config,
                      steps_per_epoch=args.images // 4,
                      checkpoint_dir=os.path.join(workdir, "ckpt"),
                      metrics_path=metrics_path)
    state = trainer.init_state()

    paths = list_image_paths(image_dir)
    train_data = CocoDetectionDataset(paths, annotations, config,
                                      batch_size=4, num_workers=2)
    eval_data = CocoDetectionDataset(paths, annotations, config,
                                     batch_size=4, num_workers=2)
    state = trainer.fit(state, train_data, epochs=args.epochs,
                        eval_data=eval_data)
    stage("train", epochs=args.epochs, best_ap=trainer.best_ap,
          final_loss=trainer.loss_record[-1])

    # -----------------------------------------------------------------
    # Stage 3 — standalone evaluation (notebook cell 15's evaluate).
    # CLI: ... evaluate --val-images ... --restore best
    # -----------------------------------------------------------------
    from vision_transformer_detector.train.trainer import evaluate_map

    final_map = evaluate_map(state["params"], eval_data, config)
    stage("evaluate", mAP=round(float(final_map), 4))

    # -----------------------------------------------------------------
    # Stage 4 — plot the training curves (notebook cells 10-13's plotly
    # loss/AP charts; utils/plotting mirrors scatters_plot).
    # CLI: ... plot --metrics metrics.jsonl --output curves.html
    # -----------------------------------------------------------------
    from vision_transformer_detector.utils.plotting import (
        plot_training_curves)

    curves = plot_training_curves(
        metrics_path, os.path.join(workdir, "curves.html"))
    stage("plot", written=curves)

    # -----------------------------------------------------------------
    # Stage 5 — visualize predictions + interactive contact sheet
    # (the reference's cv2 viewer, vtd.py:2187-2456, as files).
    # CLI: ... visualize --images ... --contact-sheet sheet.html
    # -----------------------------------------------------------------
    from vision_transformer_detector.data.pipeline import (
        load_and_letterbox_image)
    from vision_transformer_detector.train.trainer import (
        make_predict_step)
    from vision_transformer_detector.utils.visualize import (
        visualize_predictions, write_contact_sheet)

    predict_step = make_predict_step(config)
    batch = np.stack([load_and_letterbox_image(p, config)[0]
                      for p in paths[:4]])
    raw = np.asarray(predict_step(state["params"], batch))
    pngs = visualize_predictions(
        batch, raw, os.path.join(workdir, "viz"),
        objectness_threshold=0.0, classification_threshold=0.0,
        config=config)
    sheet = write_contact_sheet(
        pngs, os.path.join(workdir, "viz", "sheet.html"),
        title="end_to_end demo detections")
    stage("visualize", pngs=len(pngs), contact_sheet=sheet)

    # -----------------------------------------------------------------
    # Stage 6 — export a frozen inference artifact and reload it.
    # (Beyond the reference: its deployment story was re-running the
    # notebook. The artifact is StableHLO + weights + config, loadable
    # without the package's model code.)
    # CLI: ... export --output-dir artifact --batch-size 4
    # -----------------------------------------------------------------
    from vision_transformer_detector.export import (
        load_exported, save_exported)
    from vision_transformer_detector.ops.decode import (
        transform_predictions)

    artifact_dir = save_exported(
        os.path.join(workdir, "artifact"), state["params"], config,
        batch_size=4)
    exported = load_exported(artifact_dir)
    # The artifact bakes forward + transform_predictions: it emits
    # DECODED (B, max_objects, 6) detections, not raw logits.
    live = np.asarray(transform_predictions(
        predict_step(state["params"], batch), config))
    frozen = np.asarray(exported(batch))
    np.testing.assert_allclose(frozen, live, rtol=2e-4, atol=2e-4)
    stage("export", dir=artifact_dir,
          max_abs_diff=float(np.max(np.abs(frozen - live))))

    # -----------------------------------------------------------------
    # Stage 7 — serve one HTTP request against the trained weights.
    # CLI: ... serve --restore best --port 8000
    # -----------------------------------------------------------------
    from vision_transformer_detector.serving import (
        DetectionServer, DetectionService)

    service = DetectionService(config, state["params"],
                               score_threshold=-1.0)
    server = DetectionServer(service, port=0)  # ephemeral port
    server.start()
    try:
        with open(paths[0], "rb") as f:
            payload = f.read()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/predict", data=payload,
            headers={"Content-Type": "image/jpeg"})
        with urllib.request.urlopen(req, timeout=120) as r:
            response = json.loads(r.read())
    finally:
        server.stop()
    stage("serve", detections=len(response["detections"]),
          image_size=response["image_size"])

    print(json.dumps({
        "workdir": workdir,
        "best_ap": trainer.best_ap,
        "final_mAP": round(float(final_map), 4),
        "artifacts": ["images/", "annotations.json", "metrics.jsonl",
                      "ckpt/", "curves.html", "viz/", "artifact/"],
        "ok": True,
    }))


if __name__ == "__main__":
    main()
