"""Input-pipeline throughput: native C++ decode vs PIL.

Generates synthetic JPEGs once, then times single-image and batch decode
paths. The reference's pipeline was GIL-bound tf.py_function work
(SURVEY.md §3.1); this quantifies the native core's headroom (which scales
with host cores — this container has one).

Usage: python tools/bench_pipeline.py [--images 64] [--size 640]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--images", type=int, default=64)
    parser.add_argument("--size", type=int, default=640)
    parser.add_argument("--source-size", type=int, default=480)
    args = parser.parse_args()

    import numpy as np
    from PIL import Image

    from vision_transformer_detector.config import DetectorConfig
    from vision_transformer_detector.data import pipeline

    config = DetectorConfig(image_size=(args.size, args.size))
    rng = np.random.default_rng(0)

    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i in range(args.images):
            arr = rng.integers(0, 255,
                               (args.source_size, args.source_size * 4 // 3,
                                3), np.uint8)
            path = os.path.join(tmp, f"{i:012d}.jpg")
            Image.fromarray(arr).save(path, quality=90)
            paths.append(path)

        rows = {}
        for use_native in ((True, False)
                           if pipeline.native_available() else (False,)):
            tic = time.perf_counter()
            for path in paths:
                pipeline.load_and_letterbox_image(
                    path, config, normalize=False, use_native=use_native)
            seconds = time.perf_counter() - tic
            rows["native" if use_native else "pil"] = round(
                args.images / seconds, 1)

        if pipeline.native_available():
            from vision_transformer_detector._native import (
                _native_pipeline)
            blobs = [open(p, "rb").read() for p in paths]
            tic = time.perf_counter()
            _native_pipeline.decode_letterbox_batch(
                blobs, args.size, args.size, os.cpu_count() or 1)
            rows["native_batch"] = round(
                args.images / (time.perf_counter() - tic), 1)

        print(json.dumps({
            "images": args.images,
            "target_px": args.size,
            "throughput_img_s": rows,
            "native_built": pipeline.native_available(),
            "host_cores": os.cpu_count(),
        }))


if __name__ == "__main__":
    main()
