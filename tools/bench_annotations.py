"""Benchmark: native COCO instances-JSON parser vs Python json.load.

Generates a synthetic instances file with realistic per-annotation
segmentation payloads (the bulk of the real 450 MB train file), then
times ``build_annotations_from_instances`` both ways and verifies the
outputs match. CPU-only.

Usage: python tools/bench_annotations.py [--annotations 100000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthesize(path: str, n_annotations: int, n_images: int) -> int:
    rng = np.random.default_rng(0)
    annotations = []
    for i in range(n_annotations):
        w = float(np.round(rng.uniform(1, 200), 2))
        h = float(np.round(rng.uniform(1, 200), 2))
        seg = [[float(v) for v in np.round(rng.uniform(0, 640, 28), 2)]]
        annotations.append({
            "segmentation": seg,
            "area": round(w * h, 2),
            "iscrowd": 0,
            "image_id": int(rng.integers(1, n_images + 1)),
            "bbox": [float(np.round(rng.uniform(0, 440), 2)),
                     float(np.round(rng.uniform(0, 440), 2)), w, h],
            "category_id": int(rng.integers(1, 91)),
            "id": i,
        })
    doc = {
        "info": {"description": "synthetic bench"},
        "images": [{"id": i, "file_name": f"{i:012d}.jpg",
                    "height": 480, "width": 640}
                   for i in range(1, n_images + 1)],
        "annotations": annotations,
        "categories": [{"id": c, "name": f"cat-{c}",
                        "supercategory": "thing"} for c in range(1, 91)],
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return os.path.getsize(path)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--annotations", type=int, default=100_000)
    parser.add_argument("--images", type=int, default=20_000)
    args = parser.parse_args()

    from vision_transformer_detector.data import annotations as ann

    if not ann.native_parser_available():
        raise SystemExit("native parser not built; run tools/build_native.sh")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "instances_bench.json")
        size = synthesize(path, args.annotations, args.images)
        print(json.dumps({"file_mb": round(size / 1e6, 1),
                          "annotations": args.annotations}), flush=True)

        tic = time.perf_counter()
        d_py = ann.build_annotations_from_instances(path, use_native=False)
        t_py = time.perf_counter() - tic

        tic = time.perf_counter()
        d_nat = ann.build_annotations_from_instances(path, use_native=True)
        t_nat = time.perf_counter() - tic

        assert d_py.keys() == d_nat.keys()
        for key in d_py:
            assert d_py[key] == d_nat[key], f"mismatch at image {key}"

        print(json.dumps({
            "python_s": round(t_py, 2),
            "native_s": round(t_nat, 2),
            "speedup": round(t_py / t_nat, 2),
            "python_mb_s": round(size / 1e6 / t_py, 1),
            "native_mb_s": round(size / 1e6 / t_nat, 1),
            "outputs_identical": True,
        }))


if __name__ == "__main__":
    main()
