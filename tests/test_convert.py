"""TF->JAX weight converter against a synthetic keras-style .h5/.keras.

No TensorFlow in this environment, so the test fabricates an h5 with the
reference's layer naming scheme (vision_transformer_detector.py:151, 301,
353-369, 393, 454-493) and checks the converted pytree round-trips into the
model with the right values in the right places.
"""

import os
import sys
import zipfile

import jax
import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from convert_tf_checkpoint import (  # noqa: E402
    _natural_key, convert, read_keras_weights)

from vision_transformer_detector.config import DetectorConfig  # noqa: E402
from vision_transformer_detector.models.vit_detector import (  # noqa: E402
    init_params)

CFG = DetectorConfig(
    image_size=(68, 68), patch_size=17, embedding_dim=12, num_heads=2,
    key_dim=5, encoder_blocks=2, encoder_mlp_layers=2, head_last_units=8,
    head_layers=2)

# Every axis of the reference factory signature the converter must cover
# (create_vision_transformer_detector, vtd.py:498-506): dropout-active
# (keras Dropout layers own no weights, so the mapping is unchanged),
# deep head blocks (head_block_repeats > 1 multiplies the anonymous
# dense pyramid), and a non-square non-608 input (changes num_patches,
# the position embedding, and the head token width).
CFG_VARIANTS = {
    "base": CFG,
    "dropout": CFG.replace(dropout=0.1),
    "deep_head": CFG.replace(head_block_repeats=2),
    "nonsquare": CFG.replace(image_size=(68, 85)),
}


def _write_fake_keras(path, cfg, glorot: bool = False) -> dict:
    """Create model.weights.h5 inside a .keras-style zip with reference
    layer names; returns {h5_path: value} for later assertions.

    ``glorot=True`` scales weights by fan-in (needed for the full 608px
    reference config, where constant-scale random weights overflow through
    the 8-block pyramid)."""
    rng = np.random.default_rng(0)
    template = init_params(jax.random.PRNGKey(0), cfg)

    def rand_like(arr):
        shape = np.shape(arr)
        if glorot and len(shape) >= 2:
            scale = float(np.prod(shape[:-1])) ** -0.5
        elif glorot:
            scale = 0.05
        else:
            scale = 0.5
        return rng.normal(0, scale, shape).astype(np.float32)

    entries = {}

    def put(name, arr):
        entries[name] = arr

    root = "model_weights"
    put(f"{root}/linear_projection/kernel:0",
        rand_like(template["linear_projection"]["kernel"]))
    put(f"{root}/linear_projection/bias:0",
        rand_like(template["linear_projection"]["bias"]))
    put(f"{root}/position_encoding/position_embedding/embeddings:0",
        rand_like(np.zeros((cfg.num_patches, 1))))

    ln = 0
    for i in range(cfg.encoder_blocks):
        for which in ("ln1", "ln2"):
            suffix = "" if ln == 0 else f"_{ln}"
            put(f"{root}/layer_normalization{suffix}/gamma:0",
                rand_like(template["encoder"][i][which]["gamma"]))
            put(f"{root}/layer_normalization{suffix}/beta:0",
                rand_like(template["encoder"][i][which]["beta"]))
            ln += 1
        suffix = "" if i == 0 else f"_{i}"
        mha = template["encoder"][i]["mha"]
        for proj, tf_name in (("query", "query"), ("key", "key"),
                              ("value", "value"),
                              ("out", "attention_output")):
            put(f"{root}/multi_head_attention{suffix}/{tf_name}/kernel:0",
                rand_like(mha[proj]["kernel"]))
            put(f"{root}/multi_head_attention{suffix}/{tf_name}/bias:0",
                rand_like(mha[proj]["bias"]))
        for j in range(cfg.encoder_mlp_layers):
            put(f"{root}/MLP_{i + 1}_{j + 1}/kernel:0",
                rand_like(template["encoder"][i]["mlp"][j]["kernel"]))
            put(f"{root}/MLP_{i + 1}_{j + 1}/bias:0",
                rand_like(template["encoder"][i]["mlp"][j]["bias"]))

    # Anonymous head denses in creation order: token dense then pyramid.
    put(f"{root}/dense/kernel:0",
        rand_like(template["head_token_dense"]["kernel"]))
    put(f"{root}/dense/bias:0",
        rand_like(template["head_token_dense"]["bias"]))
    for k in range(len(template["head_mlp"])):
        put(f"{root}/dense_{k + 1}/kernel:0",
            rand_like(template["head_mlp"][k]["kernel"]))
        put(f"{root}/dense_{k + 1}/bias:0",
            rand_like(template["head_mlp"][k]["bias"]))
    put(f"{root}/MLP_Head_no_Sigmoid/kernel:0",
        rand_like(template["head_output"]["kernel"]))
    put(f"{root}/MLP_Head_no_Sigmoid/bias:0",
        rand_like(template["head_output"]["bias"]))

    h5_path = path / "model.weights.h5"
    with h5py.File(h5_path, "w") as f:
        for name, arr in entries.items():
            f.create_dataset(name, data=arr)
    keras_path = path / "model.keras"
    with zipfile.ZipFile(keras_path, "w") as zf:
        zf.write(h5_path, "model.weights.h5")
    return {"path": str(keras_path), "entries": entries, "root": root}


def test_natural_key_ordering():
    names = ["dense_10/kernel", "dense_2/kernel", "dense/kernel"]
    assert sorted(names, key=_natural_key) == [
        "dense/kernel", "dense_2/kernel", "dense_10/kernel"]


@pytest.mark.parametrize("variant", sorted(CFG_VARIANTS))
def test_convert_roundtrip(tmp_path, variant):
    cfg = CFG_VARIANTS[variant]
    fake = _write_fake_keras(tmp_path, cfg)
    weights = read_keras_weights(fake["path"])
    assert len(weights) == len(fake["entries"])

    params = convert(weights, cfg)
    root = fake["root"]
    np.testing.assert_array_equal(
        params["linear_projection"]["kernel"],
        fake["entries"][f"{root}/linear_projection/kernel:0"])
    np.testing.assert_array_equal(
        params["position_embedding"].reshape(-1),
        fake["entries"][
            f"{root}/position_encoding/position_embedding/embeddings:0"
        ].reshape(-1))
    # block 1 (index 1) ln2 comes from layer_normalization_3
    np.testing.assert_array_equal(
        params["encoder"][1]["ln2"]["gamma"],
        fake["entries"][f"{root}/layer_normalization_3/gamma:0"])
    np.testing.assert_array_equal(
        params["encoder"][1]["mha"]["out"]["kernel"],
        fake["entries"][
            f"{root}/multi_head_attention_1/attention_output/kernel:0"])
    np.testing.assert_array_equal(
        params["encoder"][0]["mlp"][1]["kernel"],
        fake["entries"][f"{root}/MLP_1_2/kernel:0"])
    np.testing.assert_array_equal(
        params["head_token_dense"]["kernel"],
        fake["entries"][f"{root}/dense/kernel:0"])
    np.testing.assert_array_equal(
        params["head_mlp"][1]["bias"],
        fake["entries"][f"{root}/dense_2/bias:0"])
    np.testing.assert_array_equal(
        params["head_output"]["kernel"],
        fake["entries"][f"{root}/MLP_Head_no_Sigmoid/kernel:0"])


@pytest.mark.parametrize("variant", sorted(CFG_VARIANTS))
def test_converted_params_run(tmp_path, variant):
    import jax.numpy as jnp

    from vision_transformer_detector.models.vit_detector import forward

    cfg = CFG_VARIANTS[variant]
    fake = _write_fake_keras(tmp_path, cfg)
    params = convert(read_keras_weights(fake["path"]), cfg)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    h, w = cfg.image_size
    logits = forward(params, jnp.zeros((1, h, w, 3)), cfg)
    assert logits.shape == (1, cfg.max_objects, 6)
    assert bool(jnp.all(jnp.isfinite(logits)))


def test_multiscale_head_cleanly_rejected(tmp_path):
    """The multi-scale head is a framework extension with no TF layer
    counterpart; the converter must refuse with an actionable message,
    not die needle-by-needle mid-mapping."""
    fake = _write_fake_keras(tmp_path, CFG)
    weights = read_keras_weights(fake["path"])
    with pytest.raises(ValueError, match="head_scales"):
        convert(weights, CFG.replace(head_scales=(1, 2)))


def test_deep_head_maps_every_repeat(tmp_path):
    """head_block_repeats=2 doubles the anonymous dense pyramid; the
    natural-sort mapping must land dense_{k} on head_mlp[k-1] past the
    lexicographic _9/_10 boundary too."""
    cfg = CFG.replace(head_block_repeats=2)
    fake = _write_fake_keras(tmp_path, cfg)
    params = convert(read_keras_weights(fake["path"]), cfg)
    root = fake["root"]
    n = len(params["head_mlp"])
    assert n == cfg.head_layers * 2
    for k in range(n):
        np.testing.assert_array_equal(
            params["head_mlp"][k]["kernel"],
            fake["entries"][f"{root}/dense_{k + 1}/kernel:0"])
