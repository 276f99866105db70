"""run_sweep unit tests (the CLI sweep e2e lives in test_cli.py)."""

import json

import numpy as np
import pytest

from vision_transformer_detector.config import (
    DetectorConfig, LossConfig, TrainConfig)
from vision_transformer_detector.train.sweep import (
    expand_grid, run_sweep)

TINY = DetectorConfig(
    image_size=(34, 34), embedding_dim=8, num_heads=2, key_dim=4,
    encoder_blocks=1, encoder_mlp_layers=2, head_last_units=8, head_layers=1)


def _make_data(config, train_config):
    rng = np.random.default_rng(0)
    h, w = config.image_size
    images = rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
    labels = np.full((2, config.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    labels[0, 0] = (1, 5, 17.0, 17.0, 10.0, 10.0)
    return [(images, labels)], [(images, labels)]


def test_run_sweep_rejects_unsized_dataset(tmp_path):
    """A dataset without __len__ used to silently get steps_per_epoch=1,
    making LR decay boundaries count optimizer steps instead of epochs —
    every sweep point trained on a wrong schedule (round-4 review)."""
    def gen_data(config, train_config):
        return (b for b in _make_data(config, train_config)[0]), None

    with pytest.raises(TypeError, match="sized train dataset"):
        run_sweep({}, gen_data, base_config=TINY, epochs=1,
                  out_dir=str(tmp_path / "s"), plot=False)


def test_run_sweep_truncates_stale_records(tmp_path):
    """Re-running a sweep into the same out_dir starts a fresh
    records.jsonl; appending used to mix stale rows (duplicate 'run'
    indices) with artifacts the new run had overwritten."""
    out = str(tmp_path / "sweep")
    tc = TrainConfig(learning_rate=1e-4, epochs_warm_up=10_000,
                     skip_epochs=10_000)
    for _ in range(2):
        records = run_sweep({}, _make_data, base_config=TINY,
                            base_train_config=tc, epochs=1,
                            out_dir=out, plot=False)
    lines = [json.loads(line)
             for line in open(f"{out}/records.jsonl")]
    assert len(lines) == len(records) == 1
    assert lines[0]["run"] == 0
    assert expand_grid({}) == [{}]
