"""Native C++ decode/letterbox core vs the PIL path."""

import numpy as np
import pytest

from vision_transformer_detector.config import DetectorConfig
from vision_transformer_detector.data import pipeline

native = pytest.importorskip(
    "vision_transformer_detector._native._native_pipeline",
    reason="native extension not built (tools/build_native.sh)")


def _make_jpeg(tmp_path, shape=(48, 64), name="000000000042.jpg"):
    from PIL import Image

    rng = np.random.default_rng(0)
    # Smooth gradient + blocks: JPEG-friendly content so decode differences
    # between libjpeg paths stay tiny.
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([yy * 255 // h, xx * 255 // w,
                    ((yy + xx) * 255) // (h + w)], axis=-1).astype(np.uint8)
    img[10:30, 20:40] = rng.integers(0, 255, 3, np.uint8)
    path = tmp_path / name
    Image.fromarray(img).save(path, quality=95)
    return str(path)


def test_native_decode_shapes(tmp_path):
    path = _make_jpeg(tmp_path)
    cfg = DetectorConfig(image_size=(64, 64))
    canvas, (oh, ow) = pipeline.load_and_letterbox_image(
        path, cfg, normalize=False, use_native=True)
    assert canvas.shape == (64, 64, 3)
    assert canvas.dtype == np.uint8
    assert (oh, ow) == (48, 64)
    # Letterbox: 48x64 -> 48x64 resized, pad rows (64-48)//2=8 top/bottom.
    assert canvas[:8].max() == 0 and canvas[-8:].max() == 0
    assert canvas[8:-8].max() > 0


def test_native_close_to_pil(tmp_path):
    path = _make_jpeg(tmp_path)
    cfg = DetectorConfig(image_size=(96, 96))
    native_img, native_size = pipeline.load_and_letterbox_image(
        path, cfg, normalize=False, use_native=True)
    pil_img, pil_size = pipeline.load_and_letterbox_image(
        path, cfg, normalize=False, use_native=False)
    assert native_size == pil_size
    # Same decode (both libjpeg); resize filters differ (half-pixel bilinear
    # vs PIL triangle) so allow a loose but bounded pixel difference.
    diff = np.abs(native_img.astype(int) - pil_img.astype(int))
    assert float(np.mean(diff)) < 8.0
    assert np.mean(diff > 32) < 0.05


def test_native_batch_decode(tmp_path):
    paths = [_make_jpeg(tmp_path, name=f"{i:012d}.jpg") for i in range(4)]
    blobs = [open(p, "rb").read() for p in paths]
    results = native.decode_letterbox_batch(blobs, 64, 64, 2)
    assert len(results) == 4
    for canvas_bytes, oh, ow in results:
        assert (oh, ow) == (48, 64)
        canvas = np.frombuffer(canvas_bytes, np.uint8).reshape(64, 64, 3)
        assert canvas[8:-8].max() > 0


def test_native_invalid_jpeg_raises():
    with pytest.raises(ValueError):
        native.decode_letterbox(b"not a jpeg", 64, 64)


def test_dataset_uses_native(tmp_path):
    """The file pipeline end-to-end with the native decoder."""
    path = _make_jpeg(tmp_path)
    cfg = DetectorConfig(image_size=(64, 64))
    annotations = {"42": [[1, 32.0, 24.0, 10.0, 10.0, 100.0]]}
    ds = pipeline.CocoDetectionDataset([path], annotations, cfg,
                                       batch_size=1)
    images, labels = next(iter(ds))
    assert images.shape == (1, 64, 64, 3)
    assert labels[0, 0, 0] == 1


def test_native_letterbox_geometry_random_sizes(tmp_path):
    """Randomized source/target sizes: the native resize/pad geometry must
    land exactly where the Python path computes it (nearbyint ties-to-even
    == Python round; offsets (t-r)//2) — pads zero, content inside."""
    from PIL import Image

    rng = np.random.default_rng(3)
    for trial in range(12):
        oh, ow = int(rng.integers(8, 200)), int(rng.integers(8, 200))
        th, tw = int(rng.integers(32, 128)), int(rng.integers(32, 128))
        path = tmp_path / f"geom{trial}.jpg"
        Image.fromarray(np.full((oh, ow, 3), 255, np.uint8)).save(
            path, quality=100)
        cfg = DetectorConfig(image_size=(th, tw))
        canvas, size = pipeline.load_and_letterbox_image(
            str(path), cfg, normalize=False, use_native=True)
        assert size == (oh, ow)
        scale = max(oh / th, ow / tw)
        rh = max(1, round(oh / scale))
        rw = max(1, round(ow / scale))
        top, left = (th - rh) // 2, (tw - rw) // 2
        nz_rows = np.where(canvas.max(axis=(1, 2)) > 0)[0]
        nz_cols = np.where(canvas.max(axis=(0, 2)) > 0)[0]
        msg = f"trial {trial}: {oh}x{ow} -> {th}x{tw} (r {rh}x{rw})"
        assert nz_rows[0] == top and nz_rows[-1] == top + rh - 1, msg
        assert nz_cols[0] == left and nz_cols[-1] == left + rw - 1, msg


def test_cmyk_jpeg_falls_back_to_pil(tmp_path):
    """libjpeg cannot color-convert CMYK scans to RGB (real COCO contains
    Adobe-CMYK files); the loader must fall back to PIL instead of
    raising mid-epoch. Also proves test_native_invalid_jpeg_raises'
    error path doesn't swallow the corrupt-file case."""
    from PIL import Image

    from vision_transformer_detector.config import DetectorConfig
    from vision_transformer_detector.data.pipeline import (
        load_and_letterbox_image, native_available)

    path = tmp_path / "cmyk.jpg"
    Image.new("CMYK", (40, 30), (10, 200, 30, 5)).save(path, format="JPEG")
    cfg = DetectorConfig(image_size=(32, 32))
    canvas, (oh, ow) = load_and_letterbox_image(
        str(path), cfg, use_native=native_available())
    assert (oh, ow) == (30, 40)
    assert canvas.shape == (32, 32, 3)

    corrupt = tmp_path / "bad.jpg"
    corrupt.write_bytes(b"\xff\xd8 definitely not a jpeg")
    import pytest as _pytest
    with _pytest.raises(Exception):
        load_and_letterbox_image(str(corrupt), cfg,
                                 use_native=native_available())


# ---------------------------------------------------------------------------
# DCT-domain reduced-scale decode (fast_decode): libjpeg scale_num/8
# natively, PIL draft() in the fallback. Geometry/labels must be exact;
# pixel values are allowed a small bounded drift vs the exact path.
# ---------------------------------------------------------------------------

def _make_big_jpeg(tmp_path, shape=(480, 640), name="000000000777.jpg"):
    from PIL import Image

    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([yy * 255 // h, xx * 255 // w,
                    ((yy + xx) * 255) // (h + w)], axis=-1).astype(np.uint8)
    path = tmp_path / name
    Image.fromarray(img).save(path, quality=92)
    return str(path)


def test_fast_decode_noop_when_no_scaling_engages(tmp_path):
    """Target within 8/8 of the source (608px canvas from a 480x640 file):
    the scaled path must be BIT-IDENTICAL to the exact path — the training
    preset sees no pixel change from --fast-decode on COCO-sized files."""
    path = _make_big_jpeg(tmp_path)
    cfg = DetectorConfig(image_size=(608, 608))
    exact, size_e = pipeline.load_and_letterbox_image(
        path, cfg, normalize=False, use_native=True)
    fast, size_f = pipeline.load_and_letterbox_image(
        path, cfg, normalize=False, use_native=True, fast_decode=True)
    assert size_e == size_f == (480, 640)
    assert np.array_equal(exact, fast)


@pytest.mark.parametrize("target", [96, 224])
def test_fast_decode_geometry_exact_pixels_close(tmp_path, target):
    """Small canvas from a large source: scaling engages. The letterbox
    geometry (nonzero region, returned original dims) keys off the FULL
    header dims so it matches the exact path exactly; pixel values drift
    only by the resampling-chain change (measured max 3/255 on smooth
    content; bound loosely)."""
    path = _make_big_jpeg(tmp_path)
    cfg = DetectorConfig(image_size=(target, target))
    exact, size_e = pipeline.load_and_letterbox_image(
        path, cfg, normalize=False, use_native=True)
    fast, size_f = pipeline.load_and_letterbox_image(
        path, cfg, normalize=False, use_native=True, fast_decode=True)
    assert size_e == size_f == (480, 640)
    assert exact.shape == fast.shape
    # Identical zero-pad geometry.
    assert np.array_equal(exact.max(axis=(1, 2)) > 0,
                          fast.max(axis=(1, 2)) > 0)
    assert np.array_equal(exact.max(axis=(0, 2)) > 0,
                          fast.max(axis=(0, 2)) > 0)
    diff = np.abs(exact.astype(int) - fast.astype(int))
    assert float(diff.mean()) < 2.0
    assert int(diff.max()) <= 24


def test_fast_decode_pil_draft_fallback(tmp_path):
    """use_native=False rides PIL draft(); same contract as the native
    fast path: exact geometry/original dims, bounded pixel drift."""
    path = _make_big_jpeg(tmp_path)
    cfg = DetectorConfig(image_size=(128, 128))
    exact, size_e = pipeline.load_and_letterbox_image(
        path, cfg, normalize=False, use_native=False)
    fast, size_f = pipeline.load_and_letterbox_image(
        path, cfg, normalize=False, use_native=False, fast_decode=True)
    assert size_e == size_f == (480, 640)
    assert np.array_equal(exact.max(axis=(1, 2)) > 0,
                          fast.max(axis=(1, 2)) > 0)
    diff = np.abs(exact.astype(int) - fast.astype(int))
    assert float(diff.mean()) < 2.0
    assert int(diff.max()) <= 24


def test_fast_decode_dataset_labels_unchanged(tmp_path):
    """fast_decode must not move labels: they are a pure function of the
    FULL original dims, which the scaled decode preserves."""
    path = _make_big_jpeg(tmp_path)
    annotations = {"777": [[3, 320.0, 240.0, 64.0, 48.0, 3072.0]]}
    cfg = DetectorConfig(image_size=(96, 96))
    batches = {}
    for fast in (False, True):
        ds = pipeline.CocoDetectionDataset(
            [path], annotations, cfg, batch_size=1, fast_decode=fast)
        images, labels = next(iter(ds))
        batches[fast] = (images, labels)
    assert np.array_equal(batches[False][1], batches[True][1])
    assert np.abs(batches[False][0] - batches[True][0]).max() < 0.2


def test_fast_decode_batch_api(tmp_path):
    """The batch entry point honors the scaled flag (positional arg 5)."""
    path = _make_big_jpeg(tmp_path)
    blob = open(path, "rb").read()
    exact = native.decode_letterbox_batch([blob], 96, 96, 1)
    fast = native.decode_letterbox_batch([blob], 96, 96, 1, True)
    (cb_e, oh_e, ow_e), (cb_f, oh_f, ow_f) = exact[0], fast[0]
    assert (oh_e, ow_e) == (oh_f, ow_f) == (480, 640)
    a = np.frombuffer(cb_e, np.uint8).astype(int)
    b = np.frombuffer(cb_f, np.uint8).astype(int)
    assert np.abs(a - b).max() <= 24


def test_fast_decode_rejects_huge_header_bomb():
    """The decoded-size sanity cap must key off the FULL header dims in
    scaled mode too: a crafted 65500x65500 header would otherwise slip
    under the cap at scale 1/8 (8188x8188 ~ 201 MB RGB per call) and
    turn `serve --fast-decode` into a decode-bomb DoS."""
    import io

    from PIL import Image

    # A real tiny JPEG with its SOF0 dims patched to 65500x65500: the
    # header parses fine (unlike a truncated synthetic one, which would
    # fail before the cap is consulted), so the rejection below is the
    # cap itself — pinned by matching its message.
    buf = io.BytesIO()
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(buf, "JPEG")
    data = bytearray(buf.getvalue())
    i = data.find(b"\xff\xc0")
    assert i > 0, "no SOF0 marker in the fixture JPEG"
    data[i + 5:i + 7] = (65500).to_bytes(2, "big")   # height
    data[i + 7:i + 9] = (65500).to_bytes(2, "big")   # width
    bomb = bytes(data)
    for scaled in (False, True):
        with pytest.raises(ValueError, match="dimensions too large"):
            native.decode_letterbox(bomb, 224, 224, scaled)
