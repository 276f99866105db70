"""TF-weight carry-over at the FULL 608px reference configuration.

End-to-end: a reference-architecture .keras fixture (every layer under the
names the reference saves — vtd.py:151, 301, 353-369, 393, 454-493) is
converted, exported through save_params_npz, reloaded through
load_params_npz (the CLI --params-npz path), run forward, and the logits
are asserted against a committed golden to 1e-5 fp32.

No TensorFlow exists in this environment, so the fixture weights are
synthesized (deterministic PCG64); the committed golden therefore anchors
converter + forward NUMERICAL STABILITY for the carry-over path rather
than parity against a TF runtime — true parity against real reference
weights is a ROADMAP item gated on data availability.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("h5py")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from convert_tf_checkpoint import convert, read_keras_weights  # noqa: E402
from test_convert import _write_fake_keras  # noqa: E402

from vision_transformer_detector.config import DetectorConfig  # noqa: E402
from vision_transformer_detector.models.vit_detector import (  # noqa: E402
    count_params, forward)
from vision_transformer_detector.utils.checkpoint import (  # noqa: E402
    load_params_npz, save_params_npz)

GOLDEN_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "golden",
    "tf_carryover_logits_608.npz")

# Second anchor at a deliberately non-default config (round-5 verdict #7):
# non-square input (8x9 patch grid), deeper encoder, head_block_repeats=2
# (doubled anonymous dense pyramid) and dropout present in the config
# (inference forward must ignore it). Small enough to run in the fast tier.
VARIANT_CFG = DetectorConfig(
    image_size=(136, 153), patch_size=17, embedding_dim=16, num_heads=2,
    key_dim=8, encoder_blocks=3, encoder_mlp_layers=2, head_last_units=16,
    head_layers=2, head_block_repeats=2, dropout=0.1)
VARIANT_GOLDEN_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "golden",
    "tf_carryover_logits_variant.npz")


def _fixed_images(cfg, batch: int = 1) -> jnp.ndarray:
    h, w = cfg.image_size
    rng = np.random.default_rng(42)
    return jnp.asarray(
        rng.uniform(-1.0, 1.0, (batch, h, w, 3)).astype(np.float32))


def carryover_logits(tmp_dir: str, cfg: DetectorConfig = None) -> np.ndarray:
    """convert -> save npz -> load npz -> forward (reference 608 default)."""
    if cfg is None:
        cfg = DetectorConfig()  # the full measured reference config
        full = True
    else:
        full = False
    fake = _write_fake_keras(tmp_dir, cfg, glorot=True)
    params = convert(read_keras_weights(fake["path"]), cfg)
    if full:
        assert count_params(params) > 100_000_000  # genuinely the full model

    npz_path = os.path.join(str(tmp_dir), "converted.npz")
    save_params_npz(npz_path, params)
    from vision_transformer_detector.models.vit_detector import (
        init_params)
    template = init_params(jax.random.PRNGKey(1), cfg)
    loaded = load_params_npz(npz_path, template)

    logits = forward(loaded, _fixed_images(cfg), cfg)
    return np.asarray(logits)


@pytest.mark.slow
def test_full_reference_config_carryover_golden(tmp_path):
    logits = carryover_logits(tmp_path)
    assert logits.shape == (1, 17, 6)
    assert np.isfinite(logits).all()
    golden = np.load(GOLDEN_PATH)["logits"]
    np.testing.assert_allclose(logits, golden, atol=1e-5,
                               err_msg="carry-over forward drifted from "
                                       "the committed golden")


def test_variant_config_carryover_golden(tmp_path):
    """Same carry-over chain at the non-default VARIANT_CFG — anchors the
    converter on the signature axes the 608 run cannot exercise
    (non-square grid, head_block_repeats=2, dropout in config)."""
    logits = carryover_logits(tmp_path, VARIANT_CFG)
    assert logits.shape == (1, VARIANT_CFG.max_objects, 6)
    assert np.isfinite(logits).all()
    golden = np.load(VARIANT_GOLDEN_PATH)["logits"]
    np.testing.assert_allclose(logits, golden, atol=1e-5,
                               err_msg="variant carry-over forward "
                                       "drifted from the committed golden")


if __name__ == "__main__":
    # Regenerate the goldens (run from tests/ after an INTENTIONAL change):
    #   python test_tf_carryover.py
    import tempfile

    os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
    for path, cfg in ((GOLDEN_PATH, None),
                      (VARIANT_GOLDEN_PATH, VARIANT_CFG)):
        with tempfile.TemporaryDirectory() as td:
            from pathlib import Path
            logits = carryover_logits(Path(td), cfg)
        np.savez(path, logits=logits)
        print("golden written:", path, logits.reshape(-1)[:6])
