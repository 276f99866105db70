"""On-device detection postprocessing: top-k selection and NMS.

The reference model needs neither (anchor-free fixed slots, explicitly no
dedup — vision_transformer_detector.py:1189-1191, 2430), but the framework
API provides both per the north star ("score top-k and NMS postprocessing
run fully on-device", BASELINE.json): static shapes, no host round-trips,
usable inside any jitted serving path.

Boxes are cxcyhw like everywhere else in the framework; IoU is the
EPSILON-guarded kernel from ops/geometry.py.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from .decode import classification_confidence
from .geometry import iou


def detection_scores(decoded: jnp.ndarray) -> jnp.ndarray:
    """Combined score = objectness * class confidence for decoded
    ``(..., max_objects, 6)`` predictions (thresholding semantics of the
    metric use both, vtd.py:1378-1384; the product is the serving-friendly
    scalar ranking)."""
    # classification_confidence is already in [0, 1] by construction
    # (|v - round(v)| <= 0.5), so no clipping is needed.
    return decoded[..., 0] * classification_confidence(decoded[..., 1])


@functools.partial(jax.jit, static_argnames=("k",))
def top_k_detections(decoded: jnp.ndarray, k: int
                     ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Top-k detections per image by combined score.

    Args:   decoded ``(B, N, 6)``.
    Returns ``(scores (B, k), class_ids (B, k) int32, boxes (B, k, 4))``.
    """
    scores = detection_scores(decoded)
    top_scores, indices = jax.lax.top_k(scores, k)
    classes = jnp.round(
        jnp.take_along_axis(decoded[..., 1], indices, axis=-1)
    ).astype(jnp.int32)
    boxes = jnp.take_along_axis(
        decoded[..., 2:], indices[..., None], axis=-2)
    return top_scores, classes, boxes


def _nms_single(boxes: jnp.ndarray, scores: jnp.ndarray,
                iou_threshold: float, score_threshold: float,
                class_ids: jnp.ndarray, per_class: bool) -> jnp.ndarray:
    """Greedy NMS keep-mask for one image (N boxes, static shape).

    Sorted-score greedy suppression expressed as a fori_loop over the score
    ranking; the O(N^2) IoU matrix is small — for detector-sized
    N (tens to hundreds) this is far cheaper than any host round-trip.
    """
    n = boxes.shape[0]
    order = jnp.argsort(-scores)
    boxes_sorted = boxes[order]
    scores_sorted = scores[order]
    classes_sorted = class_ids[order]

    # ops.geometry.iou is elementwise over aligned boxes; broadcast to the
    # full (N, N, 4) pairing explicitly.
    iou_matrix = iou(
        jnp.broadcast_to(boxes_sorted[:, None, :], (n, n, 4)),
        jnp.broadcast_to(boxes_sorted[None, :, :], (n, n, 4)))
    if per_class:
        same_class = classes_sorted[:, None] == classes_sorted[None, :]
        iou_matrix = jnp.where(same_class, iou_matrix, 0.0)

    def body(i, keep):
        # Suppress j > i when kept box i overlaps j above threshold.
        suppress = (iou_matrix[i] > iou_threshold) & (
            jnp.arange(n) > i) & keep[i]
        return keep & ~suppress

    keep0 = scores_sorted > score_threshold
    keep_sorted = jax.lax.fori_loop(0, n, body, keep0)

    inverse = jnp.argsort(order)
    return keep_sorted[inverse]


@functools.partial(
    jax.jit,
    static_argnames=("per_class",))
def non_max_suppression(boxes: jnp.ndarray, scores: jnp.ndarray,
                        class_ids: jnp.ndarray,
                        iou_threshold: float = 0.5,
                        score_threshold: float = 0.0,
                        per_class: bool = True) -> jnp.ndarray:
    """Batched greedy NMS -> boolean keep mask (static shapes).

    Args:
      boxes ``(B, N, 4)`` cxcyhw, scores ``(B, N)``, class_ids ``(B, N)``.
      per_class: only suppress within the same class (the usual detector
        semantics); False for class-agnostic NMS.
    Returns ``(B, N)`` bool keep mask aligned with the input order.
    """
    fn = functools.partial(_nms_single, iou_threshold=iou_threshold,
                           score_threshold=score_threshold,
                           per_class=per_class)
    return jax.vmap(
        lambda b, s, c: fn(b, s, class_ids=c))(boxes, scores, class_ids)


@functools.partial(
    jax.jit,
    static_argnames=("k", "per_class"))
def postprocess_detections(decoded: jnp.ndarray, k: int = 17,
                           iou_threshold: float = 0.5,
                           score_threshold: float = 0.0,
                           per_class: bool = True):
    """Full on-device postprocess: scores -> NMS -> top-k.

    Returns ``(scores, class_ids, boxes, valid)`` each with leading
    ``(B, k)`` — suppressed slots have score 0 and valid False. One fused
    XLA program; feed it the output of ops.decode.transform_predictions.
    """
    scores = detection_scores(decoded)
    class_ids = jnp.round(decoded[..., 1]).astype(jnp.int32)
    boxes = decoded[..., 2:]
    keep = non_max_suppression(boxes, scores, class_ids,
                               iou_threshold=iou_threshold,
                               score_threshold=score_threshold,
                               per_class=per_class)
    masked_scores = jnp.where(keep, scores, 0.0)
    top_scores, indices = jax.lax.top_k(masked_scores, k)
    top_classes = jnp.take_along_axis(class_ids, indices, axis=-1)
    top_boxes = jnp.take_along_axis(boxes, indices[..., None], axis=-2)
    valid = top_scores > 0.0
    return top_scores, top_classes, top_boxes, valid
