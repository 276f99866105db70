"""Data-layer tests: annotation dict building, letterbox geometry, label
tensors, pipeline batching — golden-checked against the shipped
val_annotations_dict.json where available."""

import os

import numpy as np
import pytest

from vision_transformer_detector.config import DetectorConfig
from vision_transformer_detector.data.annotations import (
    build_annotations_dict,
    labels_from_annotations,
    letterbox_params,
    load_annotations_dict,
)
from vision_transformer_detector.data.categories import (
    COCO_CATEGORIES,
    COCO_ID_TO_MODEL_ID,
    MODEL_ID_TO_NAME,
)
from vision_transformer_detector.data.pipeline import (
    CocoDetectionDataset,
    normalize_image,
    synthetic_batches,
)

CFG = DetectorConfig()
VAL_DICT_PATH = "/root/reference/val_annotations_dict.json"


def test_category_table():
    assert len(COCO_CATEGORIES) == 80
    # The model id of a category never changes (vtu.py:261-263):
    # toothbrush is 79 in the model, 90 in COCO (full_categories.csv last
    # row: "79.0,90.0,toothbrush,indoor"; COCO detection has no id 91).
    assert MODEL_ID_TO_NAME[79] == "toothbrush"
    assert COCO_ID_TO_MODEL_ID[90] == 79
    assert COCO_ID_TO_MODEL_ID[85] == 74  # clock
    assert 91 not in COCO_ID_TO_MODEL_ID
    assert MODEL_ID_TO_NAME[0] == "person"
    assert COCO_ID_TO_MODEL_ID[1] == 0


def test_category_table_matches_reference_csv():
    """Golden check of the full embedded table against the reference CSV."""
    csv_path = "/root/reference/full_categories.csv"
    if not os.path.exists(csv_path):
        pytest.skip("reference csv not mounted")
    with open(csv_path) as f:
        header = f.readline()
        assert "id_in_model" in header
        for line in f:
            model_id_s, coco_id_s, name, supercat = \
                line.rstrip("\n").split(",")
            model_id = int(float(model_id_s))
            coco_id = int(float(coco_id_s))
            assert COCO_CATEGORIES[model_id] == (coco_id, name, supercat)
            assert COCO_ID_TO_MODEL_ID[coco_id] == model_id


def test_build_annotations_dict():
    raw = {"annotations": [
        {"image_id": 139, "category_id": 1,
         "bbox": [10.0, 20.0, 30.0, 40.0]},           # area 1200
        {"image_id": 139, "category_id": 18,
         "bbox": [0.0, 0.0, 100.0, 50.0]},            # area 5000
        {"image_id": 285, "category_id": 3,
         "bbox": [5.0, 5.0, 0.0, 10.0]},              # degenerate width
    ]}
    result = build_annotations_dict(raw)
    # Sorted area-descending within each image (vtu.py:188-199).
    assert [a[0] for a in result["139"]] == [18, 1]
    # Center format (vtu.py:149-152): bbox [10,20,30,40] -> cx 25, cy 40,
    # h 40, w 30.
    assert result["139"][1] == [1, 25.0, 40.0, 40.0, 30.0, 1200.0]
    # Degenerate width fixed to 1 (vtu.py:154-166); center computed from
    # the ORIGINAL width before the fix, like the reference.
    assert result["285"][0] == [3, 5.0, 10.0, 10.0, 1, 10.0]


@pytest.mark.skipif(not os.path.exists(VAL_DICT_PATH),
                    reason="reference val dict not mounted")
def test_golden_val_annotations_dict():
    """Rebuilding from raw would need the COCO json; instead verify we can
    load the shipped dict and build labels from it (the BASELINE.json
    public-API requirement)."""
    annotations = load_annotations_dict(VAL_DICT_PATH)
    assert len(annotations) > 1000
    image_id, records = next(iter(annotations.items()))
    assert len(records[0]) == 6  # [cat, cx, cy, h, w, area]
    # Area-descending ordering holds.
    areas = [r[-1] for r in records]
    assert areas == sorted(areas, reverse=True)
    labels = labels_from_annotations(records, (480, 640), CFG)
    assert labels.shape == (17, 6)
    assert (labels[:, 0] == 1).sum() == min(len(records), 17)


def test_annotation_diagnostics():
    """Degenerate-box fixes and negative coordinates are reported
    (vtu.py:154-166, 182-186)."""
    from vision_transformer_detector.data.annotations import (
        AnnotationDiagnostics)

    raw = {"annotations": [
        {"image_id": 200365, "category_id": 53,
         "bbox": [5.0, 5.0, 10.0, 0.0]},              # degenerate height
        {"image_id": 285, "category_id": 3,
         "bbox": [5.0, 5.0, 0.0, 10.0]},              # degenerate width
        {"image_id": 42, "category_id": 1,
         "bbox": [-2.0, 3.0, 10.0, 10.0]},            # negative coordinate
        {"image_id": 42, "category_id": 2,
         "bbox": [1.0, 1.0, 4.0, 4.0]},               # clean
    ]}
    diag = AnnotationDiagnostics()
    build_annotations_dict(raw, diagnostics=diag)
    assert diag.summary() == {"fixed_boxes": 2, "negative_coordinates": 1}
    # Reference fixed_records row shape: [dim, index, image_id,
    # category_id, cx, cy] (vtu.py:158-166).
    assert diag.fixed_boxes[0] == ["Height", 0, "200365", 53, 10.0, 5.0]
    assert diag.fixed_boxes[1] == ["Width", 1, "285", 3, 5.0, 10.0]
    assert diag.negative_coordinates[0] == [2, "42", 1, -2.0, 3.0]


def test_letterbox_params():
    # Wide image: width-bound scale, vertical blanks (vtu.py:314-317).
    scale, blank_h, blank_w = letterbox_params((480, 640), (608, 608))
    assert scale == pytest.approx(640 / 608)
    assert blank_w == 0
    assert blank_h == pytest.approx((608 - 480 / scale) / 2)
    # Tall image: height-bound scale, horizontal blanks (vtu.py:320-323).
    scale, blank_h, blank_w = letterbox_params((640, 480), (608, 608))
    assert scale == pytest.approx(640 / 608)
    assert blank_h == 0
    # Square: no blanks.
    scale, blank_h, blank_w = letterbox_params((304, 304), (608, 608))
    assert scale == 0.5 and blank_h == 0 and blank_w == 0


def test_labels_from_annotations():
    # person (coco 1 -> model 0) and dog (coco 18 -> model 16)
    records = [
        [18, 320.0, 240.0, 100.0, 200.0, 20000.0],
        [1, 100.0, 100.0, 50.0, 50.0, 2500.0],
    ]
    labels = labels_from_annotations(records, (480, 640), CFG)
    scale, blank_h, _ = letterbox_params((480, 640), CFG.image_size)
    assert labels[0, 0] == 1 and labels[0, 1] == 16
    assert labels[0, 2] == pytest.approx(320.0 / scale)
    assert labels[0, 3] == pytest.approx(240.0 / scale + blank_h)
    assert labels[0, 4] == pytest.approx(100.0 / scale)  # height
    assert labels[0, 5] == pytest.approx(200.0 / scale)  # width
    # Empty slots: objectness 0, -8 elsewhere (vtu.py:497-505).
    assert labels[2, 0] == 0 and np.all(labels[2, 1:] == -8)


def test_labels_unknown_category_skipped():
    records = [[12, 10.0, 10.0, 5.0, 5.0, 25.0]]  # coco id 12 doesn't exist
    labels = labels_from_annotations(records, (100, 100), CFG)
    assert np.all(labels[:, 0] == 0)


def test_labels_overflow_truncated():
    records = [[1, 10.0, 10.0, 5.0, 5.0, 25.0]] * 30
    labels = labels_from_annotations(records, (608, 608), CFG)
    assert labels.shape == (17, 6)
    assert (labels[:, 0] == 1).all()


def test_normalize_image():
    img = np.array([[[0, 127, 255]]], np.uint8)
    out = normalize_image(img)
    np.testing.assert_allclose(out, [[[-1.0, 127 / 127.5 - 1, 1.0]]],
                               atol=1e-6)


def test_dataset_batching(tmp_path):
    """End-to-end file pipeline with synthetic JPEGs."""
    from PIL import Image

    paths = []
    for i in range(5):
        p = tmp_path / f"{i:012d}.jpg"
        Image.fromarray(
            np.random.randint(0, 255, (48, 64, 3), np.uint8)).save(p)
        paths.append(str(p))
    annotations = {str(i): [[1, 32.0, 24.0, 10.0, 10.0, 100.0]]
                   for i in range(5)}
    cfg = DetectorConfig(image_size=(64, 64))
    ds = CocoDetectionDataset(paths, annotations, cfg, batch_size=2)
    assert len(ds) == 2  # drop_remainder
    batches = list(ds)
    assert len(batches) == 2
    images, labels = batches[0]
    assert images.shape == (2, 64, 64, 3)
    assert images.min() >= -1.0 and images.max() <= 1.0
    assert labels.shape == (2, 17, 6)
    assert (labels[:, 0, 0] == 1).all()


def test_dataset_sharding(tmp_path):
    from PIL import Image

    paths = []
    for i in range(8):
        p = tmp_path / f"{i:012d}.jpg"
        Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(p)
        paths.append(str(p))
    cfg = DetectorConfig(image_size=(32, 32))
    shard0 = CocoDetectionDataset(paths, {}, cfg, batch_size=2,
                                  shard_index=0, num_shards=2)
    shard1 = CocoDetectionDataset(paths, {}, cfg, batch_size=2,
                                  shard_index=1, num_shards=2)
    assert len(shard0.image_paths) == 4
    assert set(shard0.image_paths).isdisjoint(shard1.image_paths)


def test_synthetic_batches():
    cfg = DetectorConfig(image_size=(64, 64))
    batches = list(synthetic_batches(cfg, batch_size=2, num_batches=3))
    assert len(batches) == 3
    images, labels = batches[0]
    assert images.shape == (2, 64, 64, 3)
    assert labels.shape == (2, 17, 6)
    assert (labels[..., 0] >= 0).all()


def _resumable_fixture(tmp_path, n=9):
    from PIL import Image

    from vision_transformer_detector.data.pipeline import (
        ResumableDataset)

    paths = []
    for i in range(n):
        p = tmp_path / f"{i:012d}.jpg"
        Image.fromarray(
            np.full((32, 32, 3), i * 20 % 255, np.uint8)).save(p)
        paths.append(str(p))
    annotations = {str(i): [[1, 16.0, 16.0, 8.0, 8.0, 64.0]]
                   for i in range(n)}
    cfg = DetectorConfig(image_size=(32, 32))
    return ResumableDataset(paths, annotations, cfg, batch_size=2, seed=3)


def test_resumable_dataset_deterministic(tmp_path):
    ds1 = _resumable_fixture(tmp_path)
    ds2 = _resumable_fixture(tmp_path)
    b1 = [img for img, _ in ds1]
    b2 = [img for img, _ in ds2]
    assert len(b1) == len(ds1) == 4  # 9 // 2
    for a, b in zip(b1, b2):
        np.testing.assert_array_equal(a, b)
    # Next epoch shuffles differently (deterministically).
    b1e2 = [img for img, _ in ds1]
    assert not all(np.array_equal(a, b) for a, b in zip(b1, b1e2))


def test_resumable_dataset_exact_resume(tmp_path):
    straight = _resumable_fixture(tmp_path)
    run_a = [img for img, _ in straight]          # epoch 0
    run_a += [img for img, _ in straight][:2]     # 2 batches of epoch 1

    # Consume 2 batches of epoch 0, checkpoint, resume in a NEW instance.
    first = _resumable_fixture(tmp_path)
    it = iter(first)
    consumed = [next(it)[0], next(it)[0]]
    state = first.get_state()
    assert state == {"epoch": 0, "batch": 2, "seed": 3}

    resumed = _resumable_fixture(tmp_path)
    resumed.set_state(state)
    rest = [img for img, _ in resumed]            # remainder of epoch 0
    rest += [img for img, _ in resumed][:2]       # 2 batches of epoch 1

    replay = consumed + rest
    assert len(replay) == len(run_a)
    for a, b in zip(run_a, replay):
        np.testing.assert_array_equal(a, b)


def test_resumable_dataset_rejects_wrong_seed(tmp_path):
    ds = _resumable_fixture(tmp_path)
    with pytest.raises(ValueError, match="seed"):
        ds.set_state({"epoch": 0, "batch": 1, "seed": 99})


def _paths_and_annotations(tmp_path, n=9, size=32):
    from PIL import Image
    paths = []
    for i in range(n):
        p = tmp_path / f"{i:012d}.jpg"
        Image.fromarray(
            np.full((size, size, 3), (i * 20 + 5) % 255, np.uint8)).save(p)
        paths.append(str(p))
    annotations = {str(i): [[1, 16.0, 16.0, 8.0, 8.0, 64.0]]
                   for i in range(n)}
    return paths, annotations, DetectorConfig(image_size=(size, size))


def test_abandoned_iteration_does_not_leak_producer(tmp_path):
    """Breaking out of iteration must stop the prefetch producer thread
    (round-3 review: the bounded q.put deadlocked forever)."""
    import threading
    import time

    from vision_transformer_detector.data.pipeline import (
        CocoDetectionDataset)

    paths, annotations, cfg = _paths_and_annotations(tmp_path)
    before = threading.active_count()
    ds = CocoDetectionDataset(paths, annotations, cfg, batch_size=1,
                              prefetch=1)
    for _ in zip(range(1), ds):   # abandon after one batch
        pass
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before + 1


def test_image_id_fallback_and_hidden_files(tmp_path):
    from PIL import Image

    from vision_transformer_detector.data.pipeline import (
        image_id_from_path, list_image_paths)

    assert image_id_from_path("/x/000000000139.jpg") == "139"
    assert image_id_from_path("/x/img_001.jpg") == "img_001"

    Image.new("RGB", (8, 8)).save(tmp_path / "000000000001.jpg")
    (tmp_path / "._000000000001.jpg").write_bytes(b"\x00\x05junk")
    (tmp_path / ".hidden.jpg").write_bytes(b"junk")
    paths = list_image_paths(str(tmp_path))
    assert len(paths) == 1 and paths[0].endswith("000000000001.jpg")


def test_resumable_sharding_is_stable_across_resume(tmp_path):
    """Shards partition the FULL epoch order; resuming mid-epoch must not
    change which examples belong to this shard (round-3 review)."""
    from vision_transformer_detector.data.pipeline import (
        ResumableDataset)

    paths, annotations, cfg = _paths_and_annotations(tmp_path, n=10)

    def make():
        return ResumableDataset(paths, annotations, cfg, batch_size=1,
                                shuffle=True, seed=3, shard_index=1,
                                num_shards=2)

    def collect(it, limit=None):
        out = []
        for images, labels in it:
            out.append(float(np.asarray(images).sum()))
            if limit and len(out) >= limit:
                break
        return out

    full = make()
    assert len(full) == len(paths[1::2])
    uninterrupted = collect(iter(full))
    assert len(uninterrupted) == len(paths[1::2])

    resumed = make()
    first = collect(iter(resumed), limit=2)
    state = resumed.get_state()
    fresh = make()
    fresh.set_state(state)
    rest = collect(iter(fresh))
    assert first + rest == uninterrupted


def test_trainer_prefetch_snapshots_resume_state(tmp_path):
    """Trainer._device_prefetch pulls one batch ahead; the checkpointable
    dataset state it exposes must lag to the batch the consumer actually
    holds (round-3 review: naive get_state() skipped a batch)."""
    from vision_transformer_detector.config import (LossConfig,
                                                        TrainConfig)
    from vision_transformer_detector.data.pipeline import (
        ResumableDataset)
    from vision_transformer_detector.train.trainer import Trainer

    paths, annotations, cfg_img = _paths_and_annotations(tmp_path, n=6)
    tiny = DetectorConfig(image_size=(32, 32), embedding_dim=8,
                          num_heads=2, key_dim=4, encoder_blocks=1,
                          encoder_mlp_layers=2, head_last_units=8,
                          head_layers=1)
    ds = ResumableDataset(paths, annotations, tiny, batch_size=1,
                          shuffle=False, seed=0)
    trainer = Trainer(tiny, LossConfig(), TrainConfig())
    seen = 0
    for images, labels in trainer._device_prefetch(ds):
        seen += 1
        # state-for-resume must point at the NEXT batch to train
        # (= seen), even though the dataset already produced seen+1.
        assert trainer.dataset_resume_state["batch"] == seen
        if seen == 3:
            break
    assert ds.get_state()["batch"] == 4   # one ahead, as documented


def test_resumable_shards_equalized_and_rotating(tmp_path):
    """Sharded ResumableDataset epochs: every shard yields the SAME
    number of batches (a one-image imbalance would desync multi-host
    train collectives), and under shuffle the dropped remainder ROTATES
    across epochs instead of permanently excluding the listing's tail."""
    from vision_transformer_detector.config import DetectorConfig
    from vision_transformer_detector.data.pipeline import (
        ResumableDataset)

    cfg = DetectorConfig(image_size=(16, 16))
    paths = [f"/fake/{i:012d}.jpg" for i in range(9)]  # 9 over 2 shards
    seen = [set(), set()]
    for shard in (0, 1):
        ds = ResumableDataset(paths, {}, cfg, batch_size=2, shuffle=True,
                              seed=7, shard_index=shard, num_shards=2)
        assert len(ds) == 2  # floor(9/2)=4 per shard -> 2 full batches
        for epoch in range(4):
            epoch_paths = ds._epoch_paths(epoch)
            assert len(epoch_paths) == 4  # equalized, not 5-vs-4
            seen[shard].update(epoch_paths)
    # Disjoint shards per epoch is guaranteed by the strided split; over
    # several shuffled epochs every image (incl. the listing's tail)
    # gets its turn somewhere.
    assert seen[0] | seen[1] == set(paths)


# ---------------------------------------------------------------------------
# Corrupt-input policy (the reference silently trusted tf.io.decode_image,
# vtu.py:418-449, and died with an opaque graph error on the first bad file;
# here the policy is explicit: typed error by default, skip+backfill opt-in).
# ---------------------------------------------------------------------------

def _corrupt_fixture(tmp_path, corrupt_indices, n=6):
    """n synthetic JPEGs with the given indices replaced by bad files."""
    from PIL import Image

    paths = []
    for i in range(n):
        p = tmp_path / f"{i:012d}.jpg"
        if i in corrupt_indices:
            kind = ["empty", "text", "truncated"][i % 3]
            if kind == "empty":
                p.write_bytes(b"")
            elif kind == "text":
                p.write_bytes(b"this is not a JPEG at all")
            else:
                good = tmp_path / "whole.jpg"
                Image.fromarray(
                    np.random.randint(0, 255, (64, 64, 3), np.uint8)
                ).save(good, quality=95)
                p.write_bytes(good.read_bytes()[:200])  # cut mid-scan
        else:
            Image.fromarray(
                np.full((32, 32, 3), i * 30 % 255, np.uint8)).save(p)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("kind", ["empty", "text", "truncated"])
def test_load_corrupt_image_raises_typed_error(tmp_path, kind):
    from vision_transformer_detector.data.pipeline import (
        CorruptImageError, load_and_letterbox_image)

    idx = {"empty": 0, "text": 1, "truncated": 2}[kind]
    path = _corrupt_fixture(tmp_path, {idx}, n=3)[idx]
    cfg = DetectorConfig(image_size=(32, 32))
    for use_native in (False, True):
        with pytest.raises(CorruptImageError) as err:
            load_and_letterbox_image(path, cfg, use_native=use_native)
        # The error names the offending file (the whole point).
        assert path in str(err.value)
        assert err.value.path == path


def test_dataset_on_corrupt_raise_default(tmp_path):
    from vision_transformer_detector.data.pipeline import (
        CorruptImageError)

    paths = _corrupt_fixture(tmp_path, {2})
    cfg = DetectorConfig(image_size=(32, 32))
    ds = CocoDetectionDataset(paths, {}, cfg, batch_size=2)
    with pytest.raises(CorruptImageError):
        list(ds)


def test_dataset_on_corrupt_skip_backfills(tmp_path):
    """skip drops the bad files, backfills so every batch is full, and
    records what it dropped."""
    paths = _corrupt_fixture(tmp_path, {1, 4}, n=8)  # 6 good files
    annotations = {str(i): [[1, 16.0, 16.0, 8.0, 8.0, 64.0]]
                   for i in range(8)}
    cfg = DetectorConfig(image_size=(32, 32))
    ds = CocoDetectionDataset(paths, annotations, cfg, batch_size=2,
                              drop_remainder=False, on_corrupt="skip")
    batches = list(ds)
    assert len(batches) == 3  # 6 good images / 2
    for images, labels in batches:
        assert images.shape == (2, 32, 32, 3)
        assert labels.shape == (2, 17, 6)
    assert sorted(ds.skipped_paths) == sorted([paths[1], paths[4]])
    # Good-file content survives in order: image 0 then 2 (1 dropped).
    reload0, _ = ds._load_one(paths[0])
    np.testing.assert_array_equal(batches[0][0][0], reload0)
    reload2, _ = ds._load_one(paths[2])
    np.testing.assert_array_equal(batches[0][0][1], reload2)


def test_dataset_on_corrupt_skip_drop_remainder(tmp_path):
    """With drop_remainder, the post-skip tail is dropped like any other
    partial batch."""
    paths = _corrupt_fixture(tmp_path, {0}, n=6)  # 5 good files
    cfg = DetectorConfig(image_size=(32, 32))
    ds = CocoDetectionDataset(paths, {}, cfg, batch_size=2,
                              drop_remainder=True, on_corrupt="skip")
    batches = list(ds)
    assert len(batches) == 2  # 5 good -> 2 full batches, tail dropped
    assert all(img.shape[0] == 2 for img, _ in batches)


def test_dataset_on_corrupt_validation(tmp_path):
    cfg = DetectorConfig(image_size=(32, 32))
    with pytest.raises(ValueError, match="on_corrupt"):
        CocoDetectionDataset([], {}, cfg, batch_size=2,
                             on_corrupt="ignore")


def test_resumable_rejects_skip(tmp_path):
    from vision_transformer_detector.data.pipeline import (
        ResumableDataset)

    cfg = DetectorConfig(image_size=(32, 32))
    with pytest.raises(ValueError, match="resume position"):
        ResumableDataset([], {}, cfg, batch_size=2, on_corrupt="skip")


def test_skip_mode_bounded_decode_window(tmp_path):
    """on_corrupt='skip' must not submit the whole corpus to the pool at
    once (review finding: eager Executor.map buffered every decoded
    image with no backpressure). Pin: while the consumer holds the
    iterator without draining, at most a bounded window of files has
    been decoded."""
    from vision_transformer_detector.data import pipeline as pl

    paths = _corrupt_fixture(tmp_path, set(), n=64)
    cfg = DetectorConfig(image_size=(32, 32))
    ds = pl.CocoDetectionDataset(paths, {}, cfg, batch_size=2,
                                 on_corrupt="skip", num_workers=2,
                                 prefetch=1)
    decoded = []
    real = pl.load_and_letterbox_image

    def counting(path, config, **kw):
        decoded.append(path)
        return real(path, config, **kw)

    pl.load_and_letterbox_image = counting
    try:
        it = iter(ds)
        next(it)  # one batch consumed; producer may prefetch a bit
        import time
        time.sleep(0.5)  # let any runaway submission drain
        # window = max(2*2, 2*4) = 8 in flight + prefetch queue (1 batch
        # of 2) + the consumed batch (2). Anything near 64 means the
        # whole corpus was submitted eagerly.
        assert len(decoded) <= 24, f"decoded {len(decoded)} of 64 eagerly"
        it.close()
    finally:
        pl.load_and_letterbox_image = real


def test_skip_mode_survives_decompression_bomb_and_dedups(tmp_path):
    """An oversized-header JPEG must be (a) rejected by the uniform
    dimension cap, (b) normalized to CorruptImageError so skip mode
    survives it, and (c) listed in skipped_paths ONCE across epochs."""
    import io

    from PIL import Image

    from vision_transformer_detector.data.pipeline import (
        CocoDetectionDataset, CorruptImageError, load_and_letterbox_image)

    # Real tiny JPEG with SOF0 dims patched huge (parses, then trips the
    # cap in native and the PIL twin alike).
    buf = io.BytesIO()
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(buf, "JPEG")
    data = bytearray(buf.getvalue())
    i = data.find(b"\xff\xc0")
    data[i + 5:i + 7] = (65500).to_bytes(2, "big")
    data[i + 7:i + 9] = (65500).to_bytes(2, "big")
    bomb = tmp_path / "000000000001.jpg"
    bomb.write_bytes(bytes(data))

    good = tmp_path / "000000000002.jpg"
    Image.fromarray(np.full((24, 24, 3), 90, np.uint8)).save(good)

    cfg = DetectorConfig(image_size=(32, 32))
    for use_native in (False, True):
        with pytest.raises(CorruptImageError):
            load_and_letterbox_image(str(bomb), cfg, use_native=use_native)

    ds = CocoDetectionDataset([str(bomb), str(good)], {}, cfg,
                              batch_size=1, drop_remainder=False,
                              on_corrupt="skip")
    for _epoch in range(3):
        batches = list(ds)
        assert len(batches) == 1  # bomb dropped, good image survives
    assert ds.skipped_paths == [str(bomb)]  # deduped across epochs


# ---------------------------------------------------------------------------
# Process-pool decode (round-5 verdict #8): full process isolation for
# GIL-hostile hosts, same semantics as the default thread pool.


def test_process_pool_matches_thread_pool(tmp_path):
    """pool='process' yields bit-identical batches to the thread pool
    (forkserver workers; per-worker state ships via the initializer)."""
    paths = _corrupt_fixture(tmp_path, set(), n=6)
    annotations = {f"{i:012d}".lstrip("0") or "0":
                   [[1, 16.0, 16.0, 8.0, 8.0, 64.0]] for i in range(6)}
    cfg = DetectorConfig(image_size=(32, 32))
    ds_t = CocoDetectionDataset(paths, annotations, cfg, batch_size=3,
                                num_workers=2)
    ds_p = CocoDetectionDataset(paths, annotations, cfg, batch_size=3,
                                num_workers=2, pool="process")
    batches_t, batches_p = list(ds_t), list(ds_p)
    assert len(batches_t) == len(batches_p) == 2
    for (ti, tl), (pi, pl) in zip(batches_t, batches_p):
        np.testing.assert_array_equal(ti, pi)
        np.testing.assert_array_equal(tl, pl)


def test_process_pool_corrupt_semantics(tmp_path):
    """CorruptImageError crosses the process boundary intact (its
    __reduce__): raise mode surfaces it with the path, skip mode counts
    and backfills exactly like the thread pool."""
    from vision_transformer_detector.data.pipeline import (
        CorruptImageError)

    paths = _corrupt_fixture(tmp_path, {1}, n=5)  # 4 good files
    cfg = DetectorConfig(image_size=(32, 32))
    ds = CocoDetectionDataset(paths, {}, cfg, batch_size=2,
                              on_corrupt="skip", num_workers=2,
                              pool="process")
    batches = list(ds)
    assert sum(b[0].shape[0] for b in batches) == 4
    assert ds.skipped_paths == [paths[1]]

    ds_raise = CocoDetectionDataset(paths, {}, cfg, batch_size=2,
                                    num_workers=1, pool="process")
    with pytest.raises(CorruptImageError) as err:
        list(ds_raise)
    assert paths[1] in str(err.value)


def test_pool_validation():
    cfg = DetectorConfig(image_size=(32, 32))
    with pytest.raises(ValueError, match="pool"):
        CocoDetectionDataset([], {}, cfg, pool="greenlet")


def test_labels_reject_non_integral_categories():
    """Corrupt (non-integral) category ids fail loudly at the pipeline
    boundary instead of silently truncating here while deflating that
    class's AP in the metric (round-4 advisor)."""
    from vision_transformer_detector.data.annotations import (
        labels_from_annotations)

    cfg = DetectorConfig(image_size=(32, 32))
    with pytest.raises(ValueError, match="non-integral category"):
        labels_from_annotations([[2.4, 16.0, 16.0, 8.0, 8.0, 64.0]],
                                (32, 32), cfg)
    # Integral floats are the normal JSON-parsed representation: fine.
    labels = labels_from_annotations([[2.0, 16.0, 16.0, 8.0, 8.0, 64.0]],
                                     (32, 32), cfg)
    assert labels[0, 0] == 1.0


def test_prefetch_iter_standalone():
    """prefetch_iter is a reusable utility (the protocol evaluator rides
    it): order preserved, producer exceptions re-raised on the consumer
    side, early abandonment does not deadlock the producer thread."""
    import threading

    from vision_transformer_detector.data.pipeline import prefetch_iter

    assert list(prefetch_iter(iter(range(10)), depth=2)) == list(range(10))

    def boom():
        yield 1
        raise RuntimeError("producer failed")

    it = prefetch_iter(boom(), depth=1)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        list(it)

    before = threading.active_count()
    it2 = prefetch_iter(iter(range(1000)), depth=1)
    assert next(it2) == 0
    it2.close()  # abandon mid-stream
    # The producer thread must wind down (stoppable put), not pin forever.
    import time
    for _ in range(50):
        if threading.active_count() <= before:
            break
        time.sleep(0.1)
    assert threading.active_count() <= before
