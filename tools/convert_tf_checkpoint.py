"""TF/Keras -> JAX weight converter for the reference detector.

The reference saves full Keras models to ``checkpoints/*.keras``
(SaveModelHighestAP, vision_transformer_detector.py:2142-2180). A ``.keras``
file is a zip archive whose ``model.weights.h5`` stores every layer's
variables; no TensorFlow is needed to read it — only h5py.

Layer-name mapping (reference names at vision_transformer_detector.py):
  linear_projection (vtd.py:297-301)      -> params['linear_projection']
  position_embedding (vtd.py:148-151)     -> params['position_embedding']
  layer_normalization* / multi_head_attention* (vtd.py:353-369, in creation
    order, two LNs + one MHA per block)   -> params['encoder'][i]['ln1/2',
                                             'mha']
  MLP_{i}_{j} (vtd.py:388-393)            -> params['encoder'][i-1]['mlp'][j-1]
  dense / dense_* in the head (vtd.py:454-486, creation order)
                                          -> params['head_token_dense'],
                                             params['head_mlp'][k]
  MLP_Head_no_Sigmoid (vtd.py:489-493)    -> params['head_output']

Keras Dense kernels are (in, out) like ours; keras MHA kernels are
(D, heads, key_dim) for q/k/v and (heads, key_dim, D) for the output
projection — also identical to our layout (models/vit_detector.py),
so the conversion is pure renaming, no transposes.

Usage:
  python tools/convert_tf_checkpoint.py model.keras out.npz \
      [--image-size 608] [--patch-size 17] ...
  then load with utils.checkpoint.load_params_npz against init_params(...).
"""

from __future__ import annotations

import argparse
import io
import zipfile
from typing import Dict

import numpy as np


def read_keras_weights(path: str) -> Dict[str, np.ndarray]:
    """Extract {layer_path: array} from a .keras zip (or a bare .h5)."""
    import h5py

    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            names = [n for n in zf.namelist() if n.endswith(".h5")]
            assert names, f"no .h5 member in {path}"
            data = io.BytesIO(zf.read(names[0]))
            handle = h5py.File(data, "r")
    else:
        handle = h5py.File(path, "r")

    weights: Dict[str, np.ndarray] = {}

    def visit(name, obj):
        import h5py as _h5
        if isinstance(obj, _h5.Dataset):
            weights[name] = np.asarray(obj)

    with handle as f:
        f.visititems(visit)
    return weights


def _natural_key(name: str):
    """Sort 'dense_10' after 'dense_9' (keras numbers anonymous layers;
    lexicographic order breaks past _9)."""
    import re
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", name)]


def _match(weights: Dict[str, np.ndarray], *needles: str):
    """All (name, array) whose path contains every needle, naturally
    sorted by name."""
    hits = sorted(
        ((k, v) for k, v in weights.items()
         if all(n in k for n in needles)),
        key=lambda kv: _natural_key(kv[0]))
    return hits


def convert(weights: Dict[str, np.ndarray], config) -> dict:
    """Rename reference weights into our parameter pytree.

    Supports the legacy Keras-2 HDF5 naming ('<layer>/kernel:0', the
    format TF 2.9 — the reference's pinned version (README.md:2-4) —
    writes). Keras 3's .keras archives use anonymous 'layers/<i>/vars/<j>'
    paths instead; detect that early with an actionable error rather
    than failing needle-by-needle (the reference cannot produce such an
    archive, and no genuine one exists in this environment to validate a
    speculative mapping against).
    """
    from vision_transformer_detector.models.vit_detector import (
        init_params)
    import jax

    if getattr(config, "head_scales", (1,)) != (1,):
        # The multi-scale head (one token-dense per pooling scale) is an
        # extension of this framework; the reference architecture
        # (vision_transformer_detector.py:417-495) has exactly one token
        # dense, so no TF checkpoint can carry multi-scale weights. Fail
        # before any needle matching with an actionable message instead
        # of a KeyError mid-mapping.
        raise ValueError(
            f"config.head_scales={config.head_scales}: the multi-scale "
            "detection head has no TF/Keras counterpart to convert from; "
            "convert with head_scales=(1,) (the reference architecture) "
            "or train the multi-scale head from scratch")

    if weights and not any("kernel" in k for k in weights):
        sample = sorted(weights)[:5]
        raise ValueError(
            "no 'kernel' datasets found — this looks like a Keras 3 "
            "'layers/<i>/vars/<j>' archive, not the Keras 2 (TF 2.9) "
            "naming this converter supports; re-save the checkpoint "
            f"with TF 2.9 model.save_weights. Sample paths: {sample}")

    template = init_params(jax.random.PRNGKey(0), config)

    def take(*needles, index=0, kind="kernel"):
        hits = [h for h in _match(weights, *needles) if kind in h[0]]
        assert len(hits) > index, (
            f"no match #{index} for {needles} [{kind}]; "
            f"have {[h[0] for h in hits]}")
        return hits[index][1]

    params = jax.tree_util.tree_map(np.asarray, template)

    params["linear_projection"]["kernel"] = take("linear_projection")
    params["linear_projection"]["bias"] = take("linear_projection",
                                               kind="bias")
    emb = [v for k, v in weights.items() if "position_embedding" in k]
    assert emb, "position_embedding not found"
    params["position_embedding"] = emb[0].reshape(
        template["position_embedding"].shape)

    n_blocks = len(params["encoder"])
    for i in range(n_blocks):
        block = params["encoder"][i]
        # Two LayerNorms per block, created ln1 then ln2 (vtd.py:353, 375).
        block["ln1"]["gamma"] = take("layer_normalization", index=2 * i,
                                     kind="gamma")
        block["ln1"]["beta"] = take("layer_normalization", index=2 * i,
                                    kind="beta")
        block["ln2"]["gamma"] = take("layer_normalization", index=2 * i + 1,
                                     kind="gamma")
        block["ln2"]["beta"] = take("layer_normalization", index=2 * i + 1,
                                    kind="beta")
        for proj, tf_name in (("query", "query"), ("key", "key"),
                              ("value", "value"),
                              ("out", "attention_output")):
            block["mha"][proj]["kernel"] = take(
                "multi_head_attention", tf_name, index=i)
            block["mha"][proj]["bias"] = take(
                "multi_head_attention", tf_name, index=i, kind="bias")
        for j in range(len(block["mlp"])):
            block["mlp"][j]["kernel"] = take(f"MLP_{i + 1}_{j + 1}/")
            block["mlp"][j]["bias"] = take(f"MLP_{i + 1}_{j + 1}/",
                                           kind="bias")

    # Head: anonymous Dense layers in creation order ('dense', 'dense_1',
    # ...): token dense first (vtd.py:454), then the pyramid, then the named
    # output layer.
    dense_layers = _match(weights, "dense")
    kernels = [v for k, v in dense_layers if "kernel" in k]
    biases = [v for k, v in dense_layers if "bias" in k]
    expected = 1 + len(params["head_mlp"])
    assert len(kernels) >= expected, (
        f"found {len(kernels)} anonymous dense layers, need {expected}")
    params["head_token_dense"]["kernel"] = kernels[0]
    params["head_token_dense"]["bias"] = biases[0]
    for k_idx in range(len(params["head_mlp"])):
        params["head_mlp"][k_idx]["kernel"] = kernels[1 + k_idx]
        params["head_mlp"][k_idx]["bias"] = biases[1 + k_idx]
    params["head_output"]["kernel"] = take("MLP_Head_no_Sigmoid")
    params["head_output"]["bias"] = take("MLP_Head_no_Sigmoid", kind="bias")

    # Shape-check everything against the template.
    for (kp, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(template)[0]):
        assert a.shape == b.shape, f"{kp}: {a.shape} != {b.shape}"
    return params


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("keras_path")
    parser.add_argument("out_npz")
    parser.add_argument("--image-size", type=int, default=608)
    parser.add_argument("--patch-size", type=int, default=17)
    parser.add_argument("--embedding-dim", type=int, default=28)
    args = parser.parse_args()

    from vision_transformer_detector.config import DetectorConfig
    from vision_transformer_detector.utils.checkpoint import (
        save_params_npz)

    config = DetectorConfig(
        image_size=(args.image_size, args.image_size),
        patch_size=args.patch_size, embedding_dim=args.embedding_dim)
    weights = read_keras_weights(args.keras_path)
    params = convert(weights, config)
    save_params_npz(args.out_npz, params)
    print(f"wrote {args.out_npz}")


if __name__ == "__main__":
    main()
