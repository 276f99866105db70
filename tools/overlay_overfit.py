"""Overlay the overfit trajectory against the reference's recorded run.

The reference's only measured training run (ipynb cell 7 stream output,
TF 2.9.1, single GPU, 2022-09-18) logged 13 (epoch, eval-loss, AP) points
at epochs 500, 1500, ..., 12500 with LR decays at 1000/10000/11000. This
tool reads a matched-configuration run's metrics jsonl (from
examples/overfit_demo.py --eval-every 1000) and writes the loss + AP
overlay chart plus a side-by-side table, confirming the training dynamics
carry over (VERDICT round-1 item 7).

Usage: python tools/overlay_overfit.py --metrics artifacts/overfit_r2_metrics.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# ipynb cell 7 stream output: "Checking the AP after epoch N" + eval line.
REFERENCE_TRAJECTORY = [
    # (epoch, eval_loss, AP)
    (500, 2.9804, 0.4522),
    (1500, 1.0112, 0.7930),
    (2500, 0.6949, 0.8625),
    (3500, 0.5426, 0.8643),
    (4500, 0.3680, 0.8984),
    (5500, 0.4938, 0.9043),
    (6500, 0.4679, 0.9020),
    (7500, 0.3168, 0.9225),
    (8500, 0.2650, 0.9467),
    (9500, 0.2098, 0.9760),
    (10500, 0.0484, 0.9987),
    (11500, 0.0353, 1.0000),
    (12500, 0.0322, 0.9991),
]


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--metrics", required=True,
                        help="jsonl from examples/overfit_demo.py "
                             "--eval-every 1000")
    parser.add_argument("--output",
                        default="artifacts/overlay_overfit.html")
    args = parser.parse_args()

    from vision_transformer_detector.utils.plotting import (
        read_metrics, scatters_plot)

    epochs, losses, ap_epochs, aps = read_metrics(args.metrics)
    loss_at = dict(zip(epochs, losses))
    ap_at = dict(zip(ap_epochs, aps))

    ref_e = [e for e, _, _ in REFERENCE_TRAJECTORY]
    ref_loss = [l for _, l, _ in REFERENCE_TRAJECTORY]
    ref_ap = [a for _, _, a in REFERENCE_TRAJECTORY]

    ours_e = [e for e in ref_e if e in loss_at]
    scatters = [
        (ref_e, ref_loss, "reference loss (TF/GPU 2022)"),
        (ours_e, [loss_at[e] for e in ours_e], "this repo loss"),
        (ref_e, ref_ap, "reference AP"),
        ([e for e in ref_e if e in ap_at],
         [ap_at[e] for e in ref_e if e in ap_at], "this repo AP"),
    ]
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    path = scatters_plot(
        scatters,
        ("8-image overfit: loss + AP vs the reference's recorded run",
         "epoch", "loss / AP"),
        args.output)

    rows = []
    for e, rl, ra in REFERENCE_TRAJECTORY:
        rows.append({"epoch": e, "ref_loss": rl,
                     "our_loss": round(loss_at.get(e, float("nan")), 4),
                     "ref_ap": ra,
                     "our_ap": round(ap_at.get(e, float("nan")), 4)})
    print(json.dumps({"plot": path, "table": rows}, indent=1))


if __name__ == "__main__":
    main()
