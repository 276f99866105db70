"""Official COCO-protocol evaluator oracles.

Two lines of defense, since pycocotools cannot be installed here:
  1. hand-derived AP/AR values for constructed scenes (each expectation
     worked out from the protocol definition in the test comment), and
  2. a literal transcription of the COCOeval algorithm (nested python
     loops, no vectorization — written independently of the library's
     implementation) cross-checked on randomized scenes.
"""

import numpy as np
import pytest

from vision_transformer_detector.metrics.coco_eval import (
    AREA_RANGES, CocoEvaluator, IOU_THRESHOLDS, RECALL_THRESHOLDS,
    detections_from_decoded, ground_truth_from_labels, iou_xywh,
    update_from_fixed_slots)


def single_image(gt_boxes, det_boxes, det_scores, gt_cats=None,
                 det_cats=None, **kwargs):
    ev = CocoEvaluator()
    gt_boxes = np.asarray(gt_boxes, float).reshape(-1, 4)
    det_boxes = np.asarray(det_boxes, float).reshape(-1, 4)
    ev.add_image(
        gt_boxes=gt_boxes,
        gt_categories=gt_cats if gt_cats is not None
        else np.zeros(len(gt_boxes), int),
        det_boxes=det_boxes,
        det_scores=det_scores,
        det_categories=det_cats if det_cats is not None
        else np.zeros(len(det_boxes), int),
        **kwargs)
    return ev.evaluate()


# ----------------------------------------------------------------------
# IoU semantics


def test_iou_basic_and_crowd():
    dt = [[0, 0, 10, 10]]
    gt = [[0, 5, 10, 10], [0, 0, 10, 10]]
    got = iou_xywh(dt, gt)
    np.testing.assert_allclose(got, [[50 / 150, 1.0]])
    # Crowd: intersection over the DETECTION area only.
    got = iou_xywh(dt, gt, gt_iscrowd=[True, False])
    np.testing.assert_allclose(got, [[50 / 100, 1.0]])


def test_iou_zero_area_guard():
    got = iou_xywh([[0, 0, 0, 0]], [[0, 0, 0, 0]])
    assert got[0, 0] == 0.0


# ----------------------------------------------------------------------
# Hand-derived protocol oracles


def test_perfect_match_is_ap1():
    res = single_image([[10, 10, 50, 40]], [[10, 10, 50, 40]], [0.9])
    s = res.summarize()
    assert s["AP"] == 1.0
    assert s["AP50"] == 1.0
    assert s["AP75"] == 1.0
    assert s["AR@1"] == 1.0


def test_iou_point6_passes_three_thresholds():
    # gt (0,0,10,10), det (0,0,10,6): inter 60, union 100 -> IoU 0.6,
    # which matches at t in {.50,.55,.60} -> per-threshold AP 1, others 0
    # -> mAP = 3/10.
    res = single_image([[0, 0, 10, 10]], [[0, 0, 10, 6]], [0.9])
    s = res.summarize()
    assert s["AP"] == pytest.approx(0.3)
    assert s["AP50"] == 1.0
    assert s["AP75"] == 0.0


def test_low_iou_is_zero():
    # IoU 1/3 < 0.5 -> unmatched at every threshold -> AP 0 (and the
    # detection is a false positive, not ignored: its area is in range).
    res = single_image([[0, 0, 10, 10]], [[0, 5, 10, 10]], [0.9])
    assert res.summarize()["AP"] == 0.0


def test_false_positive_after_all_tps_is_free():
    # TP at score .9, FP at score .1: recall reaches 1.0 while precision
    # is still 1.0, and the 101-point interpolation reads the envelope at
    # recalls <= 1.0 -> AP 1.0 (the trailing FP costs nothing, the
    # protocol's known property).
    res = single_image([[0, 0, 10, 10]],
                       [[0, 0, 10, 10], [50, 50, 10, 10]], [0.9, 0.1])
    assert res.summarize()["AP"] == 1.0


def test_false_positive_before_tp_halves_ap():
    # FP outranks the TP: cumulative precision at recall 1.0 is 1/2 and
    # at recall 0 the envelope is also 1/2 -> every interpolation point
    # reads 0.5 -> AP 0.5.
    res = single_image([[0, 0, 10, 10]],
                       [[0, 0, 10, 10], [50, 50, 10, 10]], [0.1, 0.9])
    assert res.summarize()["AP"] == pytest.approx(0.5)


def test_missed_gt_truncates_recall():
    # 2 gts, 1 perfect det: recall 0.5 at precision 1. Interpolated
    # precision is 1 for the 51 recall thresholds <= 0.5 and 0 above ->
    # AP = 51/101.
    res = single_image([[0, 0, 10, 10], [50, 50, 10, 10]],
                       [[0, 0, 10, 10]], [0.9])
    assert res.summarize()["AP"] == pytest.approx(51 / 101)


def test_max_dets_caps_recall():
    # Two perfect dets on two gts: AR@1 can only use the top-scoring det
    # -> 0.5; AR@10/@100 recover both -> 1.0. AP at maxDets=100 is 1.0.
    res = single_image([[0, 0, 10, 10], [50, 50, 10, 10]],
                       [[0, 0, 10, 10], [50, 50, 10, 10]], [0.9, 0.8])
    s = res.summarize()
    assert s["AR@1"] == 0.5
    assert s["AR@10"] == 1.0
    assert s["AR@100"] == 1.0
    assert s["AP"] == 1.0


def test_area_ranges_bucket_and_ignore():
    # A 10x10 gt (area 100) is "small"; a matched det of the same size.
    # In the medium/large buckets the gt is ignored AND the matching det
    # (same area, out of range when unmatched... here it matches the
    # ignored gt so it is ignored too) -> those buckets stay undefined
    # (-1, no positives).
    res = single_image([[0, 0, 10, 10]], [[0, 0, 10, 10]], [0.9])
    s = res.summarize()
    assert s["AP_small"] == 1.0
    assert s["AP_medium"] == -1.0
    assert s["AP_large"] == -1.0
    assert s["AR_small"] == 1.0


def test_small_fp_does_not_pollute_large_bucket():
    # Large gt (100x100) perfectly matched; an extra unmatched small det
    # (8x8). In the "large" bucket the small det's own area is out of
    # range -> ignored, AP_large stays 1.0. In "all" it is a trailing FP
    # (score-ranked below the TP) -> AP still 1.0.
    res = single_image([[0, 0, 100, 100]],
                       [[0, 0, 100, 100], [300, 300, 8, 8]], [0.9, 0.5])
    s = res.summarize()
    assert s["AP_large"] == 1.0
    assert s["AP_small"] == -1.0   # no small gt anywhere
    assert s["AP"] == 1.0


def test_crowd_absorbs_detections_without_penalty():
    # One real gt + one crowd region. Det A matches the real gt; det B
    # lies fully inside the crowd (IoF = 1 > every threshold) -> B is
    # ignored, not a false positive -> AP 1.0.
    res = single_image(
        [[0, 0, 10, 10], [100, 100, 50, 50]],
        [[0, 0, 10, 10], [110, 110, 10, 10]], [0.9, 0.8],
        gt_iscrowd=[False, True])
    assert res.summarize()["AP"] == 1.0


def test_crowd_matches_multiple_detections():
    # Crowd ground truth is never consumed: BOTH dets inside it are
    # ignored (with no real gt, every bucket has zero positives -> -1).
    res = single_image(
        [[100, 100, 50, 50]],
        [[110, 110, 10, 10], [120, 120, 10, 10]], [0.9, 0.8],
        gt_iscrowd=[True])
    assert res.summarize()["AP"] == -1.0


def test_prefers_higher_iou_gt_and_consumes_it():
    # Det A (score .9) overlaps gt1 at IoU 1.0 and gt2 at ~0.53; it takes
    # gt1. Det B (score .8) identical boxes -> gt1 is consumed, B matches
    # gt2 only at IoU .53 -> passes t=.50 only... at t=.50: A->gt1,
    # B->gt2 (both TP, recall 1, precision 1). At t>=.55: B unmatched
    # (FP after TP, free), gt2 unmatched -> recall 0.5 -> AP 51/101.
    # mAP = (1 + 9*(51/101)) / 10.
    gt = [[0, 0, 10, 10], [0, 3, 10, 10]]
    dets = [[0, 0, 10, 10], [0, 0, 10, 10]]
    res = single_image(gt, dets, [0.9, 0.8])
    want = (1.0 + 9 * (51 / 101)) / 10
    assert res.summarize()["AP"] == pytest.approx(want)
    # sanity: the cross-class IoU really is in [.50, .55)
    assert 0.5 <= iou_xywh(dets[:1], gt[1:])[0, 0] < 0.55


def test_categories_are_independent_and_averaged():
    # Class 0: perfect (AP 1). Class 1: det misses (AP 0). Class 2 has a
    # det but NO gt -> excluded from the mean (not counted as 0).
    ev = CocoEvaluator()
    ev.add_image(
        gt_boxes=[[0, 0, 10, 10], [50, 50, 10, 10]],
        gt_categories=[0, 1],
        det_boxes=[[0, 0, 10, 10], [80, 80, 10, 10], [0, 0, 5, 5]],
        det_scores=[0.9, 0.9, 0.9],
        det_categories=[0, 1, 2])
    assert ev.evaluate().summarize()["AP"] == pytest.approx(0.5)


def test_streaming_over_images_matches_concatenation():
    # The same scene split across two images scores identically to the
    # protocol run on the union (per-image evaluation, global ranking).
    a_gt, a_det = [[0, 0, 10, 10]], [[0, 0, 10, 6]]
    b_gt, b_det = [[20, 20, 8, 8]], [[20, 20, 8, 8]]
    ev = CocoEvaluator()
    ev.add_image(gt_boxes=a_gt, gt_categories=[0], det_boxes=a_det,
                 det_scores=[0.9], det_categories=[0])
    ev.add_image(gt_boxes=b_gt, gt_categories=[0], det_boxes=b_det,
                 det_scores=[0.8], det_categories=[0])
    s = ev.evaluate().summarize()
    # t <= .60: both match -> AP 1. t > .60: only image b's det matches,
    # and it is ranked BELOW image a's false positive (0.8 < 0.9):
    # pr=[0, 1/2], rc=[0, 1/2] -> envelope .5 for recall <= .5 ->
    # AP = 51 * 0.5 / 101.
    want = (3 * 1.0 + 7 * (51 * 0.5 / 101)) / 10
    assert s["AP"] == pytest.approx(want)


def test_reset_state():
    ev = CocoEvaluator()
    ev.add_image(gt_boxes=[[0, 0, 10, 10]], gt_categories=[0],
                 det_boxes=[[0, 0, 10, 10]], det_scores=[0.9],
                 det_categories=[0])
    assert ev.evaluate().summarize()["AP"] == 1.0
    ev.reset_state()
    ev.add_image(gt_boxes=[[0, 0, 10, 10]], gt_categories=[0],
                 det_boxes=[[50, 50, 10, 10]], det_scores=[0.9],
                 det_categories=[0])
    assert ev.evaluate().summarize()["AP"] == 0.0


# ----------------------------------------------------------------------
# Literal-transcription twin (independent implementation), randomized
# cross-check.


def _twin_evaluate_image(gts, dets, iou_thrs, area_rng, max_det):
    """COCOeval.evaluateImg transcribed as literal loops over dicts."""
    for g in gts:
        g["_ignore"] = 1 if (g["iscrowd"] or g["area"] < area_rng[0]
                             or g["area"] > area_rng[1]) else 0
    gtind = sorted(range(len(gts)), key=lambda i: gts[i]["_ignore"])
    gts = [gts[i] for i in gtind]
    dtind = sorted(range(len(dets)), key=lambda i: -dets[i]["score"])
    dets = [dets[i] for i in dtind][:max_det]
    ious = iou_xywh([d["bbox"] for d in dets], [g["bbox"] for g in gts],
                    [g["iscrowd"] for g in gts]) if gts and dets else (
        np.zeros((len(dets), len(gts))))
    T, G, D = len(iou_thrs), len(gts), len(dets)
    gtm = np.zeros((T, G)); dtm = np.zeros((T, D))
    gt_ig = np.array([g["_ignore"] for g in gts])
    dt_ig = np.zeros((T, D))
    for tind, t in enumerate(iou_thrs):
        for dind in range(D):
            iou = min([t, 1 - 1e-10]); m = -1
            for gind in range(G):
                if gtm[tind, gind] > 0 and not gts[gind]["iscrowd"]:
                    continue
                if m > -1 and gt_ig[m] == 0 and gt_ig[gind] == 1:
                    break
                if ious[dind, gind] < iou:
                    continue
                iou = ious[dind, gind]; m = gind
            if m == -1:
                continue
            dt_ig[tind, dind] = gt_ig[m]
            dtm[tind, dind] = 1
            gtm[tind, m] = 1 + dind
    a = np.array([d["area"] < area_rng[0] or d["area"] > area_rng[1]
                  for d in dets]).reshape(1, -1)
    dt_ig = np.logical_or(dt_ig, np.logical_and(
        dtm == 0, np.repeat(a, T, 0)))
    return {"dtMatches": dtm, "dtIgnore": dt_ig,
            "dtScores": [d["score"] for d in dets],
            "gtIgnore": gt_ig}


def _twin_full(images, categories, iou_thrs, rec_thrs, area_rngs,
               max_dets):
    """COCOeval.accumulate transcribed (precision tensor only)."""
    T, R = len(iou_thrs), len(rec_thrs)
    K, A, M = len(categories), len(area_rngs), len(max_dets)
    precision = -np.ones((T, R, K, A, M))
    recall = -np.ones((T, K, A, M))
    for k, cat in enumerate(categories):
        for a, rng in enumerate(area_rngs):
            per_img = []
            for img in images:
                gts = [dict(g) for g in img["gts"] if g["cat"] == cat]
                dets = [dict(d) for d in img["dets"] if d["cat"] == cat]
                if not gts and not dets:
                    continue
                per_img.append(_twin_evaluate_image(
                    gts, dets, iou_thrs, rng, max(max_dets)))
            for m, max_det in enumerate(max_dets):
                if not per_img:
                    continue
                scores = np.concatenate(
                    [e["dtScores"][:max_det] for e in per_img])
                inds = np.argsort(-scores, kind="mergesort")
                dtm = np.concatenate(
                    [e["dtMatches"][:, :max_det] for e in per_img],
                    axis=1)[:, inds]
                dt_ig = np.concatenate(
                    [e["dtIgnore"][:, :max_det] for e in per_img],
                    axis=1)[:, inds]
                gt_ig = np.concatenate([e["gtIgnore"] for e in per_img])
                npig = np.count_nonzero(gt_ig == 0)
                if npig == 0:
                    continue
                tps = np.logical_and(dtm, np.logical_not(dt_ig))
                fps = np.logical_and(
                    np.logical_not(dtm), np.logical_not(dt_ig))
                tp_sum = np.cumsum(tps, axis=1).astype(float)
                fp_sum = np.cumsum(fps, axis=1).astype(float)
                for t in range(T):
                    tp, fp = tp_sum[t], fp_sum[t]
                    nd = len(tp)
                    rc = tp / npig
                    pr = tp / (fp + tp + np.spacing(1))
                    q = np.zeros(R)
                    recall[t, k, a, m] = rc[-1] if nd else 0
                    pr = pr.tolist()
                    for i in range(nd - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    inds2 = np.searchsorted(rc, rec_thrs, side="left")
                    try:
                        for ri, pi in enumerate(inds2):
                            q[ri] = pr[pi]
                    except IndexError:
                        pass
                    precision[t, :, k, a, m] = np.array(q)
    return precision, recall


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_randomized_cross_check_vs_literal_transcription(seed):
    rng = np.random.default_rng(seed)
    n_images, n_cats = 5, 3
    images = []
    ev = CocoEvaluator()
    for _ in range(n_images):
        n_gt = int(rng.integers(0, 8))
        n_dt = int(rng.integers(0, 12))
        gts = []
        for _ in range(n_gt):
            wh = rng.uniform(2, 120, 2)
            xy = rng.uniform(0, 400, 2)
            gts.append({"bbox": [*xy, *wh], "area": wh[0] * wh[1],
                        "iscrowd": bool(rng.random() < 0.15),
                        "cat": int(rng.integers(0, n_cats))})
        dets = []
        for _ in range(n_dt):
            if gts and rng.random() < 0.7:   # perturb a gt box
                base = gts[int(rng.integers(0, n_gt))]
                bbox = np.array(base["bbox"]) + rng.normal(0, 6, 4)
                bbox[2:] = np.clip(bbox[2:], 1, None)
                cat = base["cat"] if rng.random() < 0.8 else int(
                    rng.integers(0, n_cats))
            else:
                wh = rng.uniform(2, 120, 2)
                bbox = np.array([*rng.uniform(0, 400, 2), *wh])
                cat = int(rng.integers(0, n_cats))
            dets.append({"bbox": bbox.tolist(),
                         "area": bbox[2] * bbox[3],
                         "score": float(rng.random()), "cat": cat})
        images.append({"gts": gts, "dets": dets})
        ev.add_image(
            gt_boxes=[g["bbox"] for g in gts] or np.zeros((0, 4)),
            gt_categories=[g["cat"] for g in gts],
            gt_iscrowd=[g["iscrowd"] for g in gts],
            gt_areas=[g["area"] for g in gts],
            det_boxes=[d["bbox"] for d in dets] or np.zeros((0, 4)),
            det_scores=[d["score"] for d in dets],
            det_categories=[d["cat"] for d in dets])

    got = ev.evaluate()
    want_p, want_r = _twin_full(
        images, sorted({c for img in images
                        for c in ([g["cat"] for g in img["gts"]]
                                  + [d["cat"] for d in img["dets"]])}),
        IOU_THRESHOLDS, RECALL_THRESHOLDS,
        list(AREA_RANGES.values()), list(CocoEvaluator().max_dets))
    np.testing.assert_allclose(got.precision, want_p, atol=1e-12)
    np.testing.assert_allclose(got.recall, want_r, atol=1e-12)


# ----------------------------------------------------------------------
# Fixed-slot adapters


def test_ground_truth_from_labels_respects_empty_slots():
    labels = np.full((17, 6), -8.0, np.float32)
    labels[:, 0] = 0.0
    labels[0] = (1, 5, 100, 60, 20, 40)   # cx=100 cy=60 h=20 w=40
    labels[1] = (1, 2, 10, 10, 4, 4)
    boxes, cats = ground_truth_from_labels(labels)
    assert boxes.shape == (2, 4)
    np.testing.assert_allclose(boxes[0], [80, 50, 40, 20])
    assert list(cats) == [5, 2]


def test_detections_from_decoded_thresholds():
    decoded = np.zeros((3, 6))
    decoded[0] = (0.9, 5.0, 100, 60, 20, 40)   # confident, exact class
    decoded[1] = (0.9, 5.4, 100, 60, 20, 40)   # class conf (0.5-0.4)/.5=.2
    decoded[2] = (0.3, 5.0, 100, 60, 20, 40)   # low objectness
    boxes, scores, cats = detections_from_decoded(decoded)
    assert len(scores) == 3                    # default: keep everything
    boxes, scores, cats = detections_from_decoded(
        decoded, objectness_threshold=0.5, class_confidence_threshold=0.5)
    assert len(scores) == 1
    np.testing.assert_allclose(boxes[0], [80, 50, 40, 20])
    assert cats[0] == 5 and scores[0] == 0.9


def test_update_from_fixed_slots_perfect_predictions():
    labels = np.full((2, 17, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    labels[0, 0] = (1, 5, 100, 60, 20, 40)
    labels[0, 1] = (1, 9, 300, 300, 50, 50)
    labels[1, 0] = (1, 5, 50, 50, 30, 30)
    decoded = labels.copy()    # detections identical to ground truth
    decoded[..., 0] = np.where(np.isclose(labels[..., 0], 1.0), 0.95, 0.0)
    decoded[..., 1:] = np.where(labels[..., 1:] == -8.0, 0.0,
                                labels[..., 1:])
    ev = CocoEvaluator()
    update_from_fixed_slots(ev, labels, decoded,
                            objectness_threshold=0.5,
                            class_confidence_threshold=0.5)
    s = ev.evaluate().summarize()
    assert s["AP"] == 1.0
    assert s["AR@100"] == 1.0


def test_update_from_fixed_slots_shape_guard():
    ev = CocoEvaluator()
    with pytest.raises(ValueError):
        update_from_fixed_slots(ev, np.zeros((2, 17, 6)),
                                np.zeros((3, 17, 6)))


def test_real_annotation_golden_perfect_detector_scores_ap1():
    """The committed real COCO val labels (608px letterboxed) fed as both
    ground truth and perfect detections must score AP 1.0 under the
    official protocol."""
    data = np.load("tests/golden/real_val_labels_608.npz")
    ev = CocoEvaluator()
    for key in data.files:
        labels = data[key][None]
        decoded = labels.copy()
        decoded[..., 0] = np.where(
            np.isclose(labels[..., 0], 1.0), 0.9, 0.0)
        decoded[..., 1:] = np.where(labels[..., 1:] == -8.0, 0.0,
                                    labels[..., 1:])
        update_from_fixed_slots(ev, labels, decoded,
                                objectness_threshold=0.5)
    s = ev.evaluate().summarize()
    assert s["AP"] == 1.0
    assert s["AP50"] == 1.0


def test_original_frame_evaluation_roundtrip(tmp_path):
    """evaluate_coco_protocol_original_frame: a detector that predicts
    exactly the letterboxed ground truth must score AP 1.0 after the
    inverse letterbox back to source pixels — validating the coordinate
    round-trip AND that areas come from the annotation dict (original
    frame), not the resized frame."""
    import jax
    from PIL import Image

    from vision_transformer_detector.config import DetectorConfig
    from vision_transformer_detector.data.annotations import (
        letterbox_boxes)
    from vision_transformer_detector.metrics.coco_eval import (
        evaluate_coco_protocol_original_frame)

    cfg = DetectorConfig(
        image_size=(64, 64), patch_size=16, embedding_dim=16, num_heads=2,
        key_dim=8, encoder_blocks=1, encoder_mlp_layers=2,
        head_last_units=16, head_layers=1)

    images = tmp_path / "img"
    images.mkdir()
    # Non-square sources on both sides of the aspect ratio.
    sizes = {1: (80, 120), 2: (100, 60)}      # id -> (h, w)
    annotations = {}
    for img_id, (h, w) in sizes.items():
        Image.new("RGB", (w, h), (10, 20, 30)).save(
            images / f"{img_id:012d}.jpg")
        # [coco_cat, cx, cy, h, w, area] in ORIGINAL pixels; category 1
        # (person) and 3 (car) are both in the detected-80 table; one
        # unmapped category (COCO id 83 has no model id) must be skipped.
        annotations[str(img_id)] = [
            [1, w * 0.4, h * 0.5, h * 0.4, w * 0.3, 12.0],
            [3, w * 0.7, h * 0.3, h * 0.2, w * 0.2, 3000.0],
            [83, w * 0.5, h * 0.5, 10.0, 10.0, 100.0],
        ]

    def fake_eval_step(params, batch):
        # Emit decoded predictions AT the letterboxed gt boxes, in the
        # order list_image_paths yields the images (sorted by filename).
        out = np.zeros((batch.shape[0], cfg.max_objects, 6), np.float32)
        for i, img_id in enumerate(sorted(sizes)):
            h, w = sizes[img_id]
            rows = [r for r in annotations[str(img_id)] if r[0] != 83]
            boxes = np.asarray([[r[1], r[2], r[3], r[4]] for r in rows],
                               np.float32)  # cx, cy, h, w original
            lb = letterbox_boxes(
                np.stack([boxes[:, 0], boxes[:, 1], boxes[:, 2],
                          boxes[:, 3]], axis=-1)[:, [0, 1, 2, 3]],
                (h, w), cfg.image_size)
            # letterbox_boxes maps (cx, cy) in cols 0-1 and scales all 4;
            # cols 2-3 here are (h, w) magnitudes -> same 1/scale factor.
            from vision_transformer_detector.data.annotations import (
                letterbox_params)
            scale, _, _ = letterbox_params((h, w), cfg.image_size)
            for j, r in enumerate(rows):
                model_cat = {1: 0, 3: 2}[r[0]]
                out[i, j] = (0.9, model_cat, lb[j, 0], lb[j, 1],
                             r[3] / scale, r[4] / scale)
        return out

    dump = tmp_path / "results.json"
    summary = evaluate_coco_protocol_original_frame(
        params=None, image_dir=str(images), annotations=annotations,
        config=cfg, batch_size=2, eval_step=fake_eval_step,
        objectness_threshold=0.5, dump_detections=str(dump))
    assert summary["AP"] == 1.0
    assert summary["AP50"] == 1.0
    # Areas come from the dict: one tiny (12 px^2 -> small) and one
    # medium (3000 px^2) gt per image.
    assert summary["AP_small"] == 1.0
    assert summary["AP_medium"] == 1.0
    assert summary["AP_large"] == -1.0

    # --dump-detections: standard COCO results format in ORIGINAL
    # pixels with COCO category ids (re-scorable with pycocotools).
    import json as json_mod
    results = json_mod.load(open(dump))
    assert len(results) == 4          # 2 detections per image
    assert {r["image_id"] for r in results} == {1, 2}
    assert all(set(r) == {"image_id", "category_id", "bbox", "score"}
               for r in results)
    assert {r["category_id"] for r in results} == {1, 3}   # COCO ids
    person = next(r for r in results
                  if r["image_id"] == 1 and r["category_id"] == 1)
    h, w = sizes[1]
    x, y, bw, bh = person["bbox"]     # top-left x, y, width, height
    assert x == pytest.approx(w * 0.4 - w * 0.3 / 2, abs=0.51)
    assert y == pytest.approx(h * 0.5 - h * 0.4 / 2, abs=0.51)
    assert bw == pytest.approx(w * 0.3, abs=0.51)
    assert bh == pytest.approx(h * 0.4, abs=0.51)
    assert person["score"] == pytest.approx(0.9, abs=1e-3)


def test_per_category_breakdown():
    ev = CocoEvaluator()
    ev.add_image(
        gt_boxes=[[0, 0, 10, 10], [50, 50, 10, 10]],
        gt_categories=[0, 1],
        det_boxes=[[0, 0, 10, 10], [80, 80, 10, 10], [0, 0, 5, 5]],
        det_scores=[0.9, 0.9, 0.9],
        det_categories=[0, 1, 2])
    per = ev.evaluate().per_category()
    assert per[0] == 1.0          # perfect
    assert per[1] == 0.0          # missed
    assert per[2] == -1.0         # no ground truth -> undefined
    per50 = ev.evaluate().per_category(iou=0.5)
    assert per50[0] == 1.0


@pytest.mark.parametrize("seed", [11, 12])
def test_randomized_cross_check_with_score_ties(seed):
    """Duplicate scores exercise the protocol's STABLE descending sort
    (mergesort in COCOeval): the vectorized evaluator must order tied
    detections identically to the literal transcription."""
    rng = np.random.default_rng(seed)
    images = []
    ev = CocoEvaluator()
    score_pool = [0.9, 0.7, 0.7, 0.7, 0.5, 0.5]   # heavy ties
    for _ in range(4):
        n_gt = int(rng.integers(1, 5))
        n_dt = int(rng.integers(2, 7))
        gts = []
        for _ in range(n_gt):
            wh = rng.uniform(4, 60, 2)
            gts.append({"bbox": [*rng.uniform(0, 200, 2), *wh],
                        "area": wh[0] * wh[1], "iscrowd": False,
                        "cat": 0})
        dets = []
        for _ in range(n_dt):
            base = gts[int(rng.integers(0, n_gt))]
            bbox = np.array(base["bbox"]) + rng.normal(0, 4, 4)
            bbox[2:] = np.clip(bbox[2:], 1, None)
            dets.append({"bbox": bbox.tolist(),
                         "area": bbox[2] * bbox[3],
                         "score": float(rng.choice(score_pool)),
                         "cat": 0})
        images.append({"gts": gts, "dets": dets})
        ev.add_image(
            gt_boxes=[g["bbox"] for g in gts],
            gt_categories=[0] * n_gt,
            gt_iscrowd=[False] * n_gt,
            gt_areas=[g["area"] for g in gts],
            det_boxes=[d["bbox"] for d in dets],
            det_scores=[d["score"] for d in dets],
            det_categories=[0] * n_dt)
    got = ev.evaluate()
    want_p, want_r = _twin_full(
        images, [0], IOU_THRESHOLDS, RECALL_THRESHOLDS,
        list(AREA_RANGES.values()), list(CocoEvaluator().max_dets))
    np.testing.assert_allclose(got.precision, want_p, atol=1e-12)
    np.testing.assert_allclose(got.recall, want_r, atol=1e-12)


needs_native = pytest.mark.skipif(
    not __import__(
        "vision_transformer_detector.metrics.coco_eval",
        fromlist=["native_matcher_available"]).native_matcher_available(),
    reason="native matcher not built (tools/build_native.sh)")


@needs_native
def test_native_matcher_bit_equal_randomized():
    """native/coco_eval.cc vs the pure-NumPy matcher: EXACT array
    equality (same IEEE-double operation order), on scenes with crowds,
    tied scores, tied IoUs, degenerate zero-area boxes, empty images and
    det-only / gt-only categories."""
    for seed in (3, 11, 42):
        evs = {flag: CocoEvaluator(use_native=flag)
               for flag in (True, False)}
        rng = np.random.default_rng(seed)
        for _ in range(120):
            n_gt = int(rng.integers(0, 8))
            n_dt = int(rng.integers(0, 25))
            gt_boxes = rng.uniform(0, 500, (n_gt, 4))
            gt_boxes[:, 2:] = rng.uniform(0, 120, (n_gt, 2))  # some 0-area
            dt_boxes = rng.uniform(0, 500, (n_dt, 4))
            dt_boxes[:, 2:] = rng.uniform(0, 120, (n_dt, 2))
            kwargs = dict(
                gt_boxes=gt_boxes,
                gt_categories=rng.integers(1, 12, n_gt),
                det_boxes=dt_boxes,
                det_categories=rng.integers(1, 12, n_dt),
                # Two-decimal scores force ranking ties.
                det_scores=np.round(rng.uniform(0, 1, n_dt), 2),
                gt_iscrowd=rng.uniform(size=n_gt) < 0.2)
            for ev in evs.values():
                ev.add_image(**kwargs)
        got = evs[True].evaluate()
        want = evs[False].evaluate()
        np.testing.assert_array_equal(got.precision, want.precision)
        np.testing.assert_array_equal(got.recall, want.recall)


@needs_native
def test_native_matcher_duplicate_boxes_and_identical_ious():
    """Adversarial tie case: several detections with IDENTICAL boxes and
    scores against identical ground truths — the greedy matcher's
    last-max-wins / first-det-first ordering must agree exactly."""
    gt = np.array([[10.0, 10, 20, 20], [10, 10, 20, 20]])
    det = np.array([[10.0, 10, 20, 20]] * 3)
    results = []
    for flag in (True, False):
        ev = CocoEvaluator(use_native=flag)
        ev.add_image(gt_boxes=gt, gt_categories=[1, 1],
                     det_boxes=det, det_categories=[1, 1, 1],
                     det_scores=[0.5, 0.5, 0.5])
        results.append(ev.evaluate())
    np.testing.assert_array_equal(results[0].precision,
                                  results[1].precision)
    np.testing.assert_array_equal(results[0].recall, results[1].recall)
    assert results[0].ap(iou=0.5) == pytest.approx(1.0)


def test_use_native_flag_validation():
    from vision_transformer_detector.metrics import coco_eval as ce

    if ce.native_matcher_available():
        assert CocoEvaluator().use_native is True
        assert CocoEvaluator(use_native=False).use_native is False
    else:
        assert CocoEvaluator().use_native is False
        with pytest.raises(RuntimeError):
            CocoEvaluator(use_native=True)


def _write_json(path, payload):
    import json
    with open(path, "w") as f:
        json.dump(payload, f)
    return str(path)


def test_score_coco_results_instances_format(tmp_path):
    """Standalone scorer on a full instances JSON: perfect detections +
    one crowd-only detection (ignored, not a false positive) + a result
    for an unknown image (dropped) -> AP = AR = 1.0."""
    from vision_transformer_detector.metrics.coco_eval import (
        score_coco_results)

    gt = {
        "images": [{"id": 1}, {"id": 2}],
        "annotations": [
            {"image_id": 1, "category_id": 1, "bbox": [10, 10, 40, 40],
             "area": 1600.0, "iscrowd": 0, "id": 1},
            {"image_id": 2, "category_id": 1, "bbox": [5, 5, 30, 30],
             "area": 900.0, "iscrowd": 0, "id": 2},
            {"image_id": 2, "category_id": 1, "bbox": [200, 200, 90, 90],
             "area": 8100.0, "iscrowd": 1, "id": 3},
        ],
        "categories": [{"id": 1, "name": "person"}],
    }
    results = [
        {"image_id": 1, "category_id": 1, "bbox": [10, 10, 40, 40],
         "score": 0.9},
        {"image_id": 2, "category_id": 1, "bbox": [5, 5, 30, 30],
         "score": 0.8},
        # Overlaps only the crowd region: matched-to-ignored, never a FP.
        {"image_id": 2, "category_id": 1, "bbox": [210, 210, 70, 70],
         "score": 0.95},
        # Unknown image id: dropped (pycocotools restricts to GT images).
        {"image_id": 999, "category_id": 1, "bbox": [0, 0, 10, 10],
         "score": 0.99},
    ]
    summary = score_coco_results(
        _write_json(tmp_path / "gt.json", gt),
        _write_json(tmp_path / "dt.json", results))
    assert summary["AP"] == pytest.approx(1.0)
    assert summary["AP50"] == pytest.approx(1.0)
    assert summary["AR@100"] == pytest.approx(1.0)


def test_score_coco_results_dict_format_and_misses(tmp_path):
    """Annotation-dict ground truth (center-format rows, string image
    ids vs int result ids) with one missed ground truth."""
    from vision_transformer_detector.metrics.coco_eval import (
        score_coco_results)

    gt = {
        "7": [[3, 30.0, 30.0, 20.0, 20.0, 400.0],
              [3, 100.0, 100.0, 10.0, 10.0, 100.0]],
        "8": [[3, 50.0, 50.0, 40.0, 40.0, 1600.0]],
    }
    results = [
        # xywh of the first row: center (30,30), h=w=20 -> (20,20,20,20).
        {"image_id": 7, "category_id": 3, "bbox": [20, 20, 20, 20],
         "score": 0.9},
        {"image_id": 8, "category_id": 3, "bbox": [30, 30, 40, 40],
         "score": 0.7},
    ]
    summary = score_coco_results(
        _write_json(tmp_path / "gt.json", gt),
        _write_json(tmp_path / "dt.json", results))
    # 2 of 3 ground truths found at every IoU threshold, no FPs:
    # precision envelope = 1 up to recall 2/3 -> AP = 67/101.
    assert summary["AP"] == pytest.approx(67 / 101, abs=1e-9)
    assert summary["AR@100"] == pytest.approx(2 / 3, abs=1e-9)


def test_score_coco_results_rejects_bad_results(tmp_path):
    from vision_transformer_detector.metrics.coco_eval import (
        score_coco_results)

    gt = {"7": [[3, 30.0, 30.0, 20.0, 20.0, 400.0]]}
    with pytest.raises(ValueError):
        score_coco_results(
            _write_json(tmp_path / "gt.json", gt),
            _write_json(tmp_path / "dt.json", {"not": "a list"}))


def test_per_category_breakdown_in_summary(tmp_path):
    from vision_transformer_detector.metrics.coco_eval import (
        score_coco_results)

    gt = {
        "images": [{"id": 1}],
        "annotations": [
            {"image_id": 1, "category_id": 1, "bbox": [10, 10, 40, 40],
             "area": 1600.0, "iscrowd": 0, "id": 1},
            {"image_id": 1, "category_id": 2, "bbox": [100, 100, 40, 40],
             "area": 1600.0, "iscrowd": 0, "id": 2},
        ],
        "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}],
    }
    results = [{"image_id": 1, "category_id": 1,
                "bbox": [10, 10, 40, 40], "score": 0.9}]  # cat 2 missed
    import json as _json
    gt_p = tmp_path / "g.json"; gt_p.write_text(_json.dumps(gt))
    dt_p = tmp_path / "d.json"; dt_p.write_text(_json.dumps(results))
    summary = score_coco_results(str(gt_p), str(dt_p), per_category=True)
    per = summary["AP_per_category"]
    assert per["1"] == pytest.approx(1.0)
    assert per["2"] == pytest.approx(0.0)
    assert summary["AP"] == pytest.approx(0.5)


def test_detections_from_decoded_ranks_by_combined_score():
    """The ranking score is objectness * class_confidence (the framework's
    canonical detection score, ops/nms.py): a high-objectness slot with an
    ambiguous class regression must not outrank a confident detection."""
    decoded = np.zeros((2, 6))
    decoded[0] = (0.90, 5.45, 100, 60, 20, 40)  # class conf (0.5-0.45)/0.5
    decoded[1] = (0.85, 5.025, 100, 60, 20, 40)
    _, scores, _ = detections_from_decoded(decoded)
    np.testing.assert_allclose(scores, [0.90 * 0.1, 0.85 * 0.95],
                               rtol=1e-5)
    assert scores[1] > scores[0]


def test_ap_rejects_unevaluated_iou_threshold():
    """ap()/per_category() do exact threshold lookup: asking for AP@0.5
    from an evaluator run at custom thresholds must raise, not silently
    return the nearest threshold's AP; summarize() reports AP50/AP75 as
    None (JSON null; stable key set for external consumers) when those
    points were not evaluated."""
    ev = CocoEvaluator(iou_thresholds=[0.6, 0.7])
    ev.add_image(gt_boxes=[[0, 0, 10, 10]], gt_categories=[1],
                 det_boxes=[[0, 0, 10, 10]], det_scores=[0.9],
                 det_categories=[1])
    results = ev.evaluate()
    assert results.ap(iou=0.6) == pytest.approx(1.0)
    with pytest.raises(ValueError, match="not one of the evaluated"):
        results.ap(iou=0.5)
    with pytest.raises(ValueError, match="not one of the evaluated"):
        results.per_category(iou=0.75)
    s = results.summarize()
    assert s["AP50"] is None and s["AP75"] is None
    assert s["AP"] == pytest.approx(1.0)

    # Default thresholds keep the standard keys and exact lookup.
    ev2 = CocoEvaluator()
    ev2.add_image(gt_boxes=[[0, 0, 10, 10]], gt_categories=[1],
                  det_boxes=[[0, 0, 10, 10]], det_scores=[0.9],
                  det_categories=[1])
    s2 = ev2.evaluate().summarize()
    assert s2["AP50"] == 1.0 and s2["AP75"] == 1.0
