"""Box geometry kernels: elementwise IoU, enclosing-box diagonal, CIoU.

Reimplements the reference's geometry stack with identical numerics:
  * ``iou`` — vision_transformer_detector.py:761-875 (4-edge sort trick,
    EPSILON-guarded division),
  * ``enclosing_diagonal`` — vision_transformer_detector.py:878-943,
  * ``ciou`` — vision_transformer_detector.py:946-1015 (arXiv 1911.08287
    eqs 6, 8, 9, 10, 11).

All functions operate elementwise over aligned ``(..., 4)`` boxes in
``(center_x, center_y, height, width)`` order and reduce away the last axis.
Everything is computed in float32 regardless of the pipeline compute dtype:
the reference documents fp16 overflow hazards in area math
(vision_transformer_detector.py:862-864), and these ops are elementwise
and cheap, so there is no reason to run them in bf16.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import EPSILON


def _safe_sqrt(x: jnp.ndarray) -> jnp.ndarray:
    """sqrt with a zero gradient at 0 instead of inf.

    sqrt'(0) = inf; multiplied by a 0 mask downstream that becomes NaN and
    poisons the whole gradient (the classic masked-loss trap). The
    double-where pattern keeps forward values identical and makes the
    backward exact-zero at x == 0.
    """
    positive = x > 0
    safe = jnp.where(positive, x, 1.0)
    return jnp.where(positive, jnp.sqrt(safe), 0.0)


def _edges(bbox: jnp.ndarray):
    """(left, right, top, bottom) edges from a cxcyhw box (vtd.py:790-806)."""
    cx = bbox[..., -4]
    cy = bbox[..., -3]
    h = bbox[..., -2]
    w = bbox[..., -1]
    return cx - w / 2, cx + w / 2, cy - h / 2, cy + h / 2


def iou(label_bbox: jnp.ndarray, prediction_bbox: jnp.ndarray) -> jnp.ndarray:
    """Elementwise IoU over aligned ``(..., 4)`` cxcyhw boxes.

    Matches vision_transformer_detector.py:761-875 exactly: intersecting
    pairs are detected with the 4-condition test, edge coordinates of
    non-intersecting pairs are zeroed before the sort so their
    "intersection" contributes 0 area, and the division is EPSILON-guarded.
    Returns a tensor with the last axis reduced away.
    """
    label_bbox = jnp.asarray(label_bbox, jnp.float32)
    prediction_bbox = jnp.asarray(prediction_bbox, jnp.float32)

    l_left, l_right, l_top, l_bottom = _edges(label_bbox)
    p_left, p_right, p_top, p_bottom = _edges(prediction_bbox)

    # Two rectangles intersect iff all four conditions hold (vtd.py:786-822).
    intersects = (
        (l_left < p_right) & (l_right > p_left)
        & (l_top < p_bottom) & (l_bottom > p_top)
    )

    horizontal_edges = jnp.stack([l_top, l_bottom, p_top, p_bottom], axis=-1)
    vertical_edges = jnp.stack([l_left, l_right, p_left, p_right], axis=-1)

    # Zero out edges of non-intersecting pairs (vtd.py:839-845), then sort:
    # the two middle edges delimit the intersection (vtd.py:847-854).
    mask = intersects[..., None]
    horizontal_edges = jnp.where(mask, horizontal_edges, 0.0)
    vertical_edges = jnp.where(mask, vertical_edges, 0.0)
    horizontal_edges = jnp.sort(horizontal_edges, axis=-1)
    vertical_edges = jnp.sort(vertical_edges, axis=-1)

    intersection_h = horizontal_edges[..., -2] - horizontal_edges[..., -3]
    intersection_w = vertical_edges[..., -2] - vertical_edges[..., -3]
    intersection_area = intersection_h * intersection_w

    prediction_area = prediction_bbox[..., -1] * prediction_bbox[..., -2]
    label_area = label_bbox[..., -1] * label_bbox[..., -2]
    union_area = prediction_area + label_area - intersection_area

    return intersection_area / (union_area + EPSILON)


def enclosing_diagonal(label_bbox: jnp.ndarray,
                       prediction_bbox: jnp.ndarray) -> jnp.ndarray:
    """Diagonal length of the smallest enclosing box (vtd.py:878-943)."""
    label_bbox = jnp.asarray(label_bbox, jnp.float32)
    prediction_bbox = jnp.asarray(prediction_bbox, jnp.float32)

    l_left, l_right, l_top, l_bottom = _edges(label_bbox)
    p_left, p_right, p_top, p_bottom = _edges(prediction_bbox)

    horizontal_edges = jnp.stack([l_top, l_bottom, p_top, p_bottom], axis=-1)
    vertical_edges = jnp.stack([l_left, l_right, p_left, p_right], axis=-1)

    # max - min across the four candidate edges (vtd.py:923-932); a sort is
    # unnecessary for the extrema, and min/max fuse better under XLA.
    enclosing_h = (jnp.max(horizontal_edges, axis=-1)
                   - jnp.min(horizontal_edges, axis=-1))
    enclosing_w = (jnp.max(vertical_edges, axis=-1)
                   - jnp.min(vertical_edges, axis=-1))

    return _safe_sqrt(enclosing_h * enclosing_h + enclosing_w * enclosing_w)


def ciou(label_bbox: jnp.ndarray, prediction_bbox: jnp.ndarray,
         get_diou: bool = False) -> jnp.ndarray:
    """CIoU loss per arXiv 1911.08287 (vtd.py:946-1015).

    ``loss = 1 - IoU + rho^2/c^2 + alpha * v``. With ``get_diou=True``
    returns ``DIoU = IoU - rho^2/c^2`` instead (vtd.py:1011-1013).
    """
    label_bbox = jnp.asarray(label_bbox, jnp.float32)
    prediction_bbox = jnp.asarray(prediction_bbox, jnp.float32)

    iou_value = iou(label_bbox, prediction_bbox)

    # rho: euclidean distance between centers (vtd.py:965-971).
    deltas = label_bbox[..., :2] - prediction_bbox[..., :2]
    rho = _safe_sqrt(jnp.sum(deltas * deltas, axis=-1))

    c_diagonal = enclosing_diagonal(label_bbox, prediction_bbox)

    # Eq. 6 (vtd.py:977-979).
    r_diou = jnp.square(rho / (c_diagonal + EPSILON))

    if get_diou:
        return iou_value - r_diou

    # Eq. 9: aspect-ratio consistency v (vtd.py:985-999). Note the reference
    # uses atan(width / height) for both boxes.
    atan_label = jnp.arctan(
        label_bbox[..., -1] / (label_bbox[..., -2] + EPSILON))
    atan_pred = jnp.arctan(
        prediction_bbox[..., -1] / (prediction_bbox[..., -2] + EPSILON))
    v_aspect = jnp.square(atan_label - atan_pred) * 4.0 / np.float32(np.pi**2)

    # Eq. 11 (vtd.py:1001-1003).
    alpha = v_aspect / ((1.0 - iou_value) + v_aspect + EPSILON)

    # Eqs. 8 and 10 (vtd.py:1005-1009).
    return 1.0 - iou_value + r_diou + alpha * v_aspect
