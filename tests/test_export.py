"""StableHLO export round-trip: artifact == live model.

The exported artifact (export.py) must reproduce the live forward+decode
(to AOT-vs-JIT fp tolerance - the AOT pipeline optimises differently),
reload without the model-building code path, and enforce its recorded
input shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vision_transformer_detector.config import DetectorConfig
from vision_transformer_detector.export import (load_exported,
                                                    save_exported)
from vision_transformer_detector.models.vit_detector import (forward,
                                                                 init_params)
from vision_transformer_detector.ops.decode import transform_predictions

TINY = DetectorConfig(
    image_size=(34, 34), embedding_dim=8, num_heads=2, key_dim=4,
    encoder_blocks=2, encoder_mlp_layers=2, head_last_units=8, head_layers=2)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    params = init_params(jax.random.PRNGKey(0), TINY)
    path = str(tmp_path_factory.mktemp("export") / "model")
    save_exported(path, params, TINY, batch_size=2)
    return path, params


def test_export_roundtrip_exact(artifact):
    path, params = artifact
    detector = load_exported(path)
    assert detector.batch_size == 2
    assert detector.config == TINY

    images = jax.random.uniform(jax.random.PRNGKey(1), (2, 34, 34, 3),
                                minval=-1, maxval=1)
    want = transform_predictions(forward(params, images, TINY), TINY)
    got = detector(images)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_export_rejects_wrong_batch(artifact):
    path, _ = artifact
    detector = load_exported(path)
    with pytest.raises(Exception):
        detector(jnp.zeros((3, 34, 34, 3)))


def test_export_multi_scale_head_params_roundtrip(tmp_path):
    """The npz unflattening handles list-valued pytree nodes (multi-scale
    head stores a LIST of dense layers)."""
    cfg = DetectorConfig(
        image_size=(64, 64), patch_size=16, embedding_dim=8, num_heads=2,
        key_dim=4, encoder_blocks=1, encoder_mlp_layers=1,
        head_last_units=8, head_layers=1, head_scales=(1, 2))
    params = init_params(jax.random.PRNGKey(0), cfg)
    path = str(tmp_path / "model")
    save_exported(path, params, cfg, batch_size=1)
    detector = load_exported(path)
    images = jax.random.uniform(jax.random.PRNGKey(1), (1, 64, 64, 3),
                                minval=-1, maxval=1)
    want = transform_predictions(forward(params, images, cfg), cfg)
    np.testing.assert_allclose(np.asarray(detector(images)),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_export_bundle_routes_by_request_size(tmp_path):
    """A multi-batch bundle serves any request size up to the largest
    exported graph: exact match, pad-up, and over-limit rejection."""
    params = init_params(jax.random.PRNGKey(0), TINY)
    path = str(tmp_path / "bundle")
    save_exported(path, params, TINY, batch_size=[1, 4])
    detector = load_exported(path)
    assert detector.batch_sizes == (1, 4)

    images = jax.random.uniform(jax.random.PRNGKey(1), (3, 34, 34, 3),
                                minval=-1, maxval=1)
    want = transform_predictions(forward(params, images, TINY), TINY)
    got = detector(images)          # request 3 -> padded to graph 4
    assert got.shape == (3, TINY.max_objects, 6)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)

    one = detector(images[:1])      # exact match to graph 1
    np.testing.assert_allclose(np.asarray(one), np.asarray(want[:1]),
                               rtol=1e-4, atol=1e-4)

    with pytest.raises(ValueError):
        detector(jnp.zeros((5, 34, 34, 3)))


def test_export_baked_postprocess_roundtrip(tmp_path):
    """`cli export --bake-postprocess` freezes NMS + top-k INTO the graph:
    the artifact returns the postprocess_detections tuple and records the
    spec in config.json; padding is sliced off every tuple leaf."""
    from vision_transformer_detector.export import normalize_postprocess
    from vision_transformer_detector.ops.nms import (
        postprocess_detections)

    params = init_params(jax.random.PRNGKey(0), TINY)
    path = str(tmp_path / "baked")
    spec = {"k": 5, "score_threshold": -1.0}
    save_exported(path, params, TINY, batch_size=[2], postprocess=spec)

    detector = load_exported(path)
    assert detector.postprocess == normalize_postprocess(spec)

    images = jax.random.uniform(jax.random.PRNGKey(1), (1, 34, 34, 3),
                                minval=-1, maxval=1)
    decoded = transform_predictions(forward(params, images, TINY), TINY)
    want = postprocess_detections(decoded, k=5, score_threshold=-1.0)

    got = detector(images)          # request 1 -> padded to graph 2
    assert isinstance(got, tuple) and len(got) == 4
    scores, classes, boxes, valid = got
    assert scores.shape == (1, 5)
    assert classes.shape == (1, 5)
    assert boxes.shape == (1, 5, 4)
    assert valid.shape == (1, 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32),
                                   rtol=1e-4, atol=1e-4)


def test_normalize_postprocess_rejects_unknown_keys():
    from vision_transformer_detector.export import normalize_postprocess

    assert normalize_postprocess(None) is None
    full = normalize_postprocess({})
    assert full == {"k": 17, "iou_threshold": 0.5, "score_threshold": 0.0,
                    "per_class": True}
    with pytest.raises(ValueError, match="unknown postprocess"):
        normalize_postprocess({"topk": 5})


def test_reexport_clears_stale_graphs(tmp_path):
    """Re-exporting into a reused directory must remove old graphs — the
    loader merges every model*.stablehlo it finds, so a stale one would
    still receive requests (ADVICE round 2)."""
    params = init_params(jax.random.PRNGKey(0), TINY)
    path = str(tmp_path / "reuse")
    save_exported(path, params, TINY, batch_size=[1, 4])
    assert load_exported(path).batch_sizes == (1, 4)

    # bundle -> single: model_b1/model_b4 must be gone
    save_exported(path, params, TINY, batch_size=2)
    assert load_exported(path).batch_sizes == (2,)

    # single -> bundle with different sizes: model.stablehlo must be gone
    save_exported(path, params, TINY, batch_size=[8])
    assert load_exported(path).batch_sizes == (8,)


def test_export_crash_before_swap_preserves_old_artifact(tmp_path,
                                                         monkeypatch):
    """A re-export that dies mid-write must leave the OLD artifact fully
    intact: every file (graphs, params.npz, config.json) is staged to
    tmp names and swapped only at the end. params.npz used to be
    rewritten in place AFTER the graph swap — a crash left new graphs
    silently serving stale weights (round-4 review)."""
    import os

    from vision_transformer_detector import export as export_mod

    params = init_params(jax.random.PRNGKey(0), TINY)
    path = str(tmp_path / "artifact")
    save_exported(path, params, TINY, batch_size=1)
    before = {name: os.path.getmtime(os.path.join(path, name))
              for name in os.listdir(path)}

    def boom(path_, params_):
        raise RuntimeError("disk full")

    monkeypatch.setattr(export_mod, "save_params_npz", boom, raising=False)
    # save_exported imports save_params_npz locally from utils.checkpoint.
    from vision_transformer_detector.utils import checkpoint as ckpt
    monkeypatch.setattr(ckpt, "save_params_npz", boom)
    params2 = init_params(jax.random.PRNGKey(1), TINY)
    with pytest.raises(RuntimeError, match="disk full"):
        save_exported(path, params2, TINY, batch_size=1)

    # Old artifact untouched (same mtimes for the REAL files) and loads.
    for name, mtime in before.items():
        assert os.path.getmtime(os.path.join(path, name)) == mtime
    detector = load_exported(path)
    x = np.zeros((1, 34, 34, 3), np.float32)
    np.testing.assert_allclose(
        np.asarray(detector(x)),
        np.asarray(transform_predictions(forward(params, jnp.asarray(x),
                                                 TINY), TINY)),
        atol=1e-4)


def test_exported_detector_normalizes_any_integer_dtype(artifact):
    """int32/int64 pixel arrays (numpy's default for python lists) get
    the same [-1,1] normalization as uint8 — a bare float cast used to
    feed the graph ~127x-out-of-range inputs."""
    path, _ = artifact
    detector = load_exported(path)
    pixels = np.random.default_rng(3).integers(
        0, 255, (2, 34, 34, 3))
    out_u8 = np.asarray(detector(pixels.astype(np.uint8)))
    out_i32 = np.asarray(detector(pixels.astype(np.int32)))
    out_i64 = np.asarray(detector(pixels))
    np.testing.assert_allclose(out_i32, out_u8, atol=1e-6)
    np.testing.assert_allclose(out_i64, out_u8, atol=1e-6)
