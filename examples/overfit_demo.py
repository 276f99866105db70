"""Reproduce the reference's headline run: overfit 8 images to AP ~1.0.

The reference trains its 608px detector on 8 COCO images for 12,502 epochs
(batch 8, lr 8e-5) and reaches best AP 1.00 in 1.9 hours on its GPU
(ipynb cells 7-9; BASELINE.md). This script runs the same configuration on
one accelerator. Without COCO files mounted it synthesises 8 deterministic
images with solid-color boxes — the overfit dynamics (can the model +
loss + metric drive AP to 1 on a fixed batch) are the same.

Usage: python examples/overfit_demo.py [--epochs N] [--image-size 608]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthetic_coco_batch(config, batch_size=8, seed=7):
    """Deterministic images with 1-3 solid rectangles + matching labels."""
    rng = np.random.default_rng(seed)
    h, w = config.image_size
    images = np.full((batch_size, h, w, 3), -0.9, np.float32)
    labels = np.full((batch_size, config.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    for i in range(batch_size):
        for s in range(int(rng.integers(1, 4))):
            bh = float(rng.uniform(h * 0.15, h * 0.5))
            bw = float(rng.uniform(w * 0.15, w * 0.5))
            cy = float(rng.uniform(bh / 2 + 2, h - bh / 2 - 2))
            cx = float(rng.uniform(bw / 2 + 2, w - bw / 2 - 2))
            color = rng.uniform(-0.5, 1.0, 3)
            y0, y1 = int(cy - bh / 2), int(cy + bh / 2)
            x0, x1 = int(cx - bw / 2), int(cx + bw / 2)
            images[i, y0:y1, x0:x1] = color
            labels[i, s] = (1.0, float(rng.integers(0, config.num_classes)),
                            cx, cy, bh, bw)
    return images, labels


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=12_502)
    parser.add_argument("--image-size", type=int, default=608)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--learning-rate", type=float, default=8e-5)
    parser.add_argument("--eval-every", type=int, default=500)
    parser.add_argument("--warm-up", type=int, default=500)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--train-flash", action="store_true",
                        help="route TRAINING attention through the flash "
                             "custom-VJP (the reference_608 preset "
                             "default; 88 -> 56 ms/step measured)")
    parser.add_argument("--bf16-moments", action="store_true",
                        help="bf16 Adam moment state (stochastic-rounded "
                             "nu; train/optimizer.py)")
    parser.add_argument("--epochs-per-call", type=int, default=1,
                        help="device-resident training window: run K "
                             "epochs per dispatch via lax.scan "
                             "(make_multi_step) — amortises the "
                             "per-epoch host round-trip; pick a divisor of --eval-every to "
                             "avoid extra scan compiles")
    parser.add_argument("--metrics", default="overfit_metrics.jsonl")
    args = parser.parse_args()

    from vision_transformer_detector.utils.runtime import (
        enable_compilation_cache)

    enable_compilation_cache()

    from vision_transformer_detector.config import (
        DetectorConfig, LossConfig, TrainConfig)
    from vision_transformer_detector.train.trainer import Trainer

    config = DetectorConfig(
        image_size=(args.image_size, args.image_size),
        compute_dtype="bfloat16" if args.bf16 else "float32",
        train_use_flash_attention=True if args.train_flash else None)
    # The reference's measured loss hyperparameters (ipynb cell 7).
    loss_config = LossConfig(coefficient=9.0, exponent=2.0,
                             weight_classification=0.0074, weight_ciou=4.5)
    moments = "bfloat16" if args.bf16_moments else None
    train_config = TrainConfig(
        learning_rate=args.learning_rate, epochs=args.epochs,
        epochs_warm_up=args.warm_up, skip_epochs=args.eval_every,
        adam_mu_dtype=moments, adam_nu_dtype=moments)

    trainer = Trainer(config, loss_config, train_config,
                      metrics_path=args.metrics)
    state = trainer.init_state()

    images, labels = synthetic_coco_batch(config, args.batch_size)
    data = [(images, labels)]

    tic = time.time()
    state = trainer.fit(state, data, epochs=args.epochs, eval_data=data,
                        epochs_per_call=args.epochs_per_call)
    toc = time.time()

    result = {
        "best_ap": trainer.best_ap,
        "ap_record": trainer.ap_record,
        "final_loss": trainer.loss_record[-1],
        "epochs": args.epochs,
        "hours_spent": round((toc - tic) / 3600, 3),
        "epochs_per_second": round(args.epochs / (toc - tic), 2),
        "reference_hours": 1.9,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
