"""Summarise a jax.profiler Chrome trace: device-op time by kernel name.

Reads the ``*.trace.json.gz`` a ``utils.profiling.trace`` capture writes and
prints the top-N device ops aggregated by (lightly normalised) name, plus
per-category totals — the quick answer to "where does the step time go"
without TensorBoard.

Usage: python tools/analyze_trace.py artifacts/trace_l16_640 [--top 25]
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re


def find_trace_file(path: str) -> str:
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(
        os.path.join(path, "**", "*.trace.json.gz"), recursive=True))
    if not hits:
        raise FileNotFoundError(f"no *.trace.json.gz under {path}")
    return hits[-1]


_CATEGORIES = (
    ("flash-attn fwd", re.compile(r"flash_kernel|flash_attention")),
    ("pallas bwd", re.compile(r"fused_bwd|flash_bwd")),
    ("fused ffn", re.compile(r"ffn_kernel|fused_dense")),
    ("attn bwd (chunked map)", re.compile(r"while|scan|map", re.I)),
    ("matmul fusion", re.compile(r"^(fusion|loop_fusion|input_fusion)")),
    ("convolution/dot", re.compile(r"convolution|dot|custom-call")),
    ("copy/transpose", re.compile(r"copy|transpose|bitcast")),
)


def categorize(name: str) -> str:
    for label, pat in _CATEGORIES:
        if pat.search(name):
            return label
    return "other"


def normalize(name: str) -> str:
    return re.sub(r"[.\d]+$", "", name)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("trace", help="trace dir or .trace.json.gz file")
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--raw", action="store_true",
                        help="don't collapse numbered op variants "
                             "(fusion.123 stays distinct)")
    args = parser.parse_args()

    path = find_trace_file(args.trace)
    with gzip.open(path, "rt") as f:
        data = json.load(f)

    events = data.get("traceEvents", [])
    # Device tracks: pid names containing "/device" (host python threads
    # are excluded so host-side dispatch doesn't double-count).
    pid_names = {e["pid"]: e["args"].get("name", "")
                 for e in events
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
    device_pids = {pid for pid, name in pid_names.items()
                   if "/device" in name.lower()}

    by_op = collections.Counter()
    by_cat = collections.Counter()
    total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in device_pids:
            continue
        raw_name = e.get("name", "?")
        # Parent spans: the profiler emits one enclosing "jit_<fn>(<id>)"
        # event per executable launch PLUS its child per-op events —
        # counting both double-counts every millisecond and buries the
        # real ops under a 50% "other" row (seen on the round-3b b16
        # trace). Module-launch spans carry a "(digits)" suffix.
        if re.fullmatch(r"jit_.*\(\d+\)", raw_name):
            continue
        dur = e.get("dur", 0) / 1e3  # us -> ms
        name = raw_name if args.raw else normalize(raw_name)
        by_op[name] += dur
        by_cat[categorize(name)] += dur
        total += dur

    print(f"trace: {path}")
    print(f"device pids: {sorted(device_pids)} "
          f"({[pid_names[p] for p in sorted(device_pids)]})")
    print(f"total device op time: {total:.1f} ms\n")
    print("by category:")
    for cat, ms in by_cat.most_common():
        print(f"  {ms:9.2f} ms  {100 * ms / max(total, 1e-9):5.1f}%  {cat}")
    print(f"\ntop {args.top} ops:")
    for name, ms in by_op.most_common(args.top):
        print(f"  {ms:9.2f} ms  {100 * ms / max(total, 1e-9):5.1f}%  {name}")


if __name__ == "__main__":
    main()
