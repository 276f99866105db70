"""Reference-compatible API facade tests."""

import numpy as np
import pytest

from vision_transformer_detector import api
from vision_transformer_detector.config import DetectorConfig


@pytest.fixture(scope="module")
def detector():
    return api.create_vision_transformer_detector(
        input_shape=(68, 68, 3), patch_size=17, embedding_dim=12,
        encoder_num_heads=2, encoder_key_dim=6, encoder_mlp_quantities=2,
        encoder_repeat_times=1, mlp_head_last_units=8,
        mlp_head_dense_layers_quantity=1)


def test_factory_signature_and_predict(detector):
    images = np.zeros((2, 68, 68, 3), np.float32)
    raw = detector.predict(images)
    assert raw.shape == (2, 17, 6)
    decoded = detector.predict_decoded(images)
    assert decoded[..., 0].min() >= 0 and decoded[..., 0].max() <= 1
    assert detector.count_params() > 0


def test_call_like_keras_model(detector):
    images = np.zeros((1, 68, 68, 3), np.float32)
    out = detector(images, training=False)
    assert out.shape == (1, 17, 6)


def test_evaluate_returns_map(detector):
    images = np.zeros((2, 68, 68, 3), np.float32)
    labels = np.full((2, 17, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    labels[0, 0] = (1, 3, 34, 34, 20, 20)
    ap = detector.evaluate([(images, labels)])
    assert 0.0 <= ap <= 1.0


def test_save_load_roundtrip(detector, tmp_path):
    path = str(tmp_path / "weights.npz")
    detector.save(path)
    loaded = api.Detector.load(path, detector.config)
    images = np.zeros((1, 68, 68, 3), np.float32)
    np.testing.assert_array_equal(detector.predict(images),
                                  loaded.predict(images))


def test_my_custom_loss_reference_defaults():
    cfg = DetectorConfig()
    y_true = np.full((1, 17, 6), -8.0, np.float32)
    y_true[..., 0] = 0.0
    y_true[0, 0] = (1, 79, 100, 100, 50, 50)
    loss = api.my_custom_loss(y_true, y_true.copy(),
                              use_transform_predictions=False, config=cfg)
    assert float(loss) == pytest.approx(0.0, abs=1e-5)


def test_transform_predictions_default_config():
    raw = np.zeros((1, 17, 6), np.float32)
    decoded = np.asarray(api.transform_predictions(raw))
    # sigmoid(0) = 0.5 everywhere -> cx = 304 at 608px
    assert decoded[0, 0, 2] == pytest.approx(304.0)
    assert decoded[0, 0, 1] == pytest.approx(0.5 * 79)


def test_learning_rate_step_decay_pure():
    """Keras LearningRateScheduler convention: the CURRENT lr is fed back
    each epoch, and the decay fires only AT the exact boundary epochs
    (vtd.py:714-718 uses ==), so a single call never compounds decays."""
    kwargs = dict(epochs_first_lr_decay=10, epochs_second_lr_decay=20,
                  epochs_third_lr_decay=30, rate_lr_decay=0.1)
    assert api.learning_rate_step_decay(5, 1.0, **kwargs) == 1.0
    assert api.learning_rate_step_decay(10, 1.0, **kwargs) == pytest.approx(0.1)
    # Non-boundary epochs past a boundary leave the fed-back lr unchanged.
    assert api.learning_rate_step_decay(11, 0.1, **kwargs) == pytest.approx(0.1)
    assert api.learning_rate_step_decay(30, 0.1, **kwargs) == pytest.approx(0.01)
    assert api.learning_rate_step_decay(
        60, 1.0, allowed_decay_times=1, **kwargs) == 1.0

    # Simulated keras feedback loop over 70 epochs: three decays total, at
    # epochs 10, 30 (=10+20) and 60 (=10+20+30).
    lr = 1.0
    trajectory = {}
    for epoch in range(70):
        lr = api.learning_rate_step_decay(epoch, lr, **kwargs)
        trajectory[epoch] = lr
    assert trajectory[9] == 1.0
    assert trajectory[10] == pytest.approx(0.1)
    assert trajectory[29] == pytest.approx(0.1)
    assert trajectory[30] == pytest.approx(0.01)
    assert trajectory[59] == pytest.approx(0.01)
    assert trajectory[69] == pytest.approx(1e-3)

    # The optax schedule used for actual training matches the same
    # trajectory (one step per epoch).
    from vision_transformer_detector.config import TrainConfig
    from vision_transformer_detector.train.optimizer import (
        make_lr_schedule)
    schedule = make_lr_schedule(TrainConfig(
        learning_rate=1.0, epochs_first_lr_decay=10,
        epochs_second_lr_decay=20, epochs_third_lr_decay=30,
        rate_lr_decay=0.1))
    for epoch in (9, 10, 29, 30, 59, 69):
        assert float(schedule(epoch)) == pytest.approx(
            trajectory[epoch]), epoch


def test_check_weights(detector):
    max_weight = api.check_weights(detector)
    assert np.isfinite(max_weight)


def test_metric_alias_is_reference_metric():
    from vision_transformer_detector.metrics.mean_average_precision \
        import MeanAveragePrecision
    assert api.MeanAveragePrecision is MeanAveragePrecision
