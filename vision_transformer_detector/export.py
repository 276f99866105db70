"""AOT model export: serialized StableHLO inference artifacts.

The deployment-artifact story of this framework (the reference's nearest
equivalent is Keras ``model.save``, which cannot even round-trip its own
custom layers — vision_transformer_detector.py:180-183). An exported
artifact directory contains:

  * ``model.stablehlo``  — ``jax.export`` serialization of the jitted
    forward + on-device decode, shape- and dtype-checked at call time,
  * ``params.npz``       — the weights (utils/checkpoint.py flat format),
  * ``config.json``      — the DetectorConfig, so the artifact is
    self-describing.

The artifact is loadable in a process that never imports the model code
(only jax + this loader), pinning the serving graph against model-code
drift; ``platforms`` allows cross-lowering (e.g. export for CUDA from a
CPU host).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .config import DetectorConfig, configs_to_dict, configs_from_dict

_MODEL_FILE = "model.stablehlo"          # single-batch artifact
_MODEL_FILE_TMPL = "model_b{batch}.stablehlo"  # multi-batch bundle
_PARAMS_FILE = "params.npz"
_CONFIG_FILE = "config.json"

# Canonical keys (and defaults) of a baked-postprocess spec — the kwargs
# of ops/nms.py:postprocess_detections.
_POSTPROCESS_DEFAULTS = {
    "k": 17, "iou_threshold": 0.5, "score_threshold": 0.0,
    "per_class": True,
}


def normalize_postprocess(postprocess: Optional[dict]) -> Optional[dict]:
    """Fill defaults / reject unknown keys for a postprocess spec dict."""
    if postprocess is None:
        return None
    unknown = set(postprocess) - set(_POSTPROCESS_DEFAULTS)
    if unknown:
        raise ValueError(
            f"unknown postprocess keys {sorted(unknown)}; valid: "
            f"{sorted(_POSTPROCESS_DEFAULTS)}")
    out = dict(_POSTPROCESS_DEFAULTS)
    out.update(postprocess)
    return {"k": int(out["k"]),
            "iou_threshold": float(out["iou_threshold"]),
            "score_threshold": float(out["score_threshold"]),
            "per_class": bool(out["per_class"])}


_CUDNN_ATTENTION_TARGET = "__cudnn$fmhaSoftmax"


def export_inference(params, config: DetectorConfig, batch_size: int,
                     platforms: Optional[Sequence[str]] = None,
                     postprocess: Optional[dict] = None) -> bytes:
    """Serialize jit(forward + decode) for fixed (batch, H, W, 3) inputs
    (``export_program``'s program; serializing needs the flatbuffers
    package)."""
    return export_program(params, config, batch_size, platforms,
                          postprocess).serialize()


def export_program(params, config: DetectorConfig, batch_size: int,
                   platforms: Optional[Sequence[str]] = None,
                   postprocess: Optional[dict] = None):
    """``jax.export.Exported`` of jit(forward + decode) for fixed
    (batch, H, W, 3) inputs; ``.call(params, images)`` runs it.

    ``postprocess`` (keys of ``_POSTPROCESS_DEFAULTS``) additionally bakes
    the NMS + top-k postprocess (ops/nms.py) into the graph: the artifact
    then returns ``(scores, class_ids, boxes, valid)`` with leading
    ``(batch, k)`` instead of raw decoded ``(batch, max_objects, 6)`` —
    the whole serving compute path in one frozen program.
    """
    from jax import export as jax_export

    from .models.vit_detector import forward
    from .ops.decode import transform_predictions

    postprocess = normalize_postprocess(postprocess)

    def infer(params, images):
        decoded = transform_predictions(forward(params, images, config),
                                        config)
        if postprocess is None:
            return decoded
        from .ops.nms import postprocess_detections
        return postprocess_detections(decoded, **postprocess)

    h, w = config.image_size
    image_spec = jax.ShapeDtypeStruct((batch_size, h, w, 3), jnp.float32)
    param_specs = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
    return jax_export.export(
        jax.jit(infer),
        platforms=list(platforms) if platforms else None,
        # cuDNN's fused attention (kernels/flash_attention.py's route for
        # half-precision attention on the GPU) is a custom call without
        # jax.export's compatibility guarantee: such an artifact reloads
        # with the cuDNN it was exported with.
        disabled_checks=[jax_export.DisabledSafetyCheck.custom_call(
            _CUDNN_ATTENTION_TARGET)],
    )(param_specs, image_spec)


def save_exported(directory: str, params, config: DetectorConfig,
                  batch_size,
                  platforms: Optional[Sequence[str]] = None,
                  postprocess: Optional[dict] = None) -> str:
    """Write the self-describing artifact directory; returns its path.

    ``batch_size`` may be an int (one pinned graph, ``model.stablehlo``)
    or a sequence of ints (a bundle: one ``model_b{N}.stablehlo`` per
    size; the loader routes each request to the smallest graph that
    fits and pads, so serving covers arbitrary request sizes up to the
    largest exported batch). ``postprocess`` bakes NMS + top-k into
    every graph (see export_inference); the spec is recorded in
    config.json so loaders know the output signature.
    """
    from .utils.checkpoint import save_params_npz

    postprocess = normalize_postprocess(postprocess)
    os.makedirs(directory, exist_ok=True)
    if isinstance(batch_size, int):
        sizes = [batch_size]
        names = [_MODEL_FILE]
    else:
        sizes = sorted(set(int(b) for b in batch_size))
        if not sizes:
            raise ValueError("batch_size sequence is empty")
        names = [_MODEL_FILE_TMPL.format(batch=b) for b in sizes]
    # Export EVERY graph to temp names first, then swap: deleting the old
    # graphs before the new exports succeed left a live artifact dir
    # broken if an export failed mid-bundle (round-3 review finding).
    tmp_names = [name + ".tmp" for name in names]
    for size, tmp in zip(sizes, tmp_names):
        blob = export_inference(params, config, size, platforms,
                                postprocess=postprocess)
        with open(os.path.join(directory, tmp), "wb") as f:
            f.write(blob)
    # Params and config go through tmp + os.replace too: they used to be
    # rewritten IN PLACE and AFTER the graph swap, so a crash mid-export
    # left new graphs paired with stale or truncated weights/config — a
    # live artifact that loads cleanly and silently serves the wrong
    # model. (np.savez appends .npz to unknown extensions, hence the
    # .tmp.npz tmp name.)
    params_tmp = os.path.join(directory, "params.tmp.npz")
    save_params_npz(params_tmp, params)
    payload = configs_to_dict(config)
    if postprocess is not None:
        payload["postprocess"] = postprocess
    config_tmp = os.path.join(directory, _CONFIG_FILE + ".tmp")
    with open(config_tmp, "w") as f:
        json.dump(payload, f, indent=1)
    # Everything is fully written — now clear stale graphs (the loader
    # merges every model*.stablehlo it finds; an old model_b64 from a
    # previous export would still receive requests — ADVICE round 2)
    # and rename. The crash window shrinks from the whole multi-minute
    # export to a few renames; a crash between renames can still pair
    # mixed generations briefly — full transactionality would need a
    # versioned artifact layout.
    for entry in os.listdir(directory):
        if entry == _MODEL_FILE or (entry.startswith("model_b")
                                    and entry.endswith(".stablehlo")):
            os.remove(os.path.join(directory, entry))
    for name, tmp in zip(names, tmp_names):
        os.replace(os.path.join(directory, tmp),
                   os.path.join(directory, name))
    os.replace(params_tmp, os.path.join(directory, _PARAMS_FILE))
    os.replace(config_tmp, os.path.join(directory, _CONFIG_FILE))
    return directory


class ExportedDetector:
    """Loaded artifact: ``detector(images) -> (B, max_objects, 6)`` decoded
    predictions, without importing the model-building code.

    A bundle directory (several ``model_b{N}.stablehlo``) routes each
    call to the smallest exported batch that fits, zero-padding the
    batch axis and slicing the result — arbitrary request sizes up to
    the largest exported batch."""

    def __init__(self, directory: str):
        from jax import export as jax_export

        single = os.path.join(directory, _MODEL_FILE)
        self._exported = {}  # batch -> Exported
        if os.path.exists(single):
            with open(single, "rb") as f:
                exp = jax_export.deserialize(f.read())
            self._exported[exp.in_avals[-1].shape[0]] = exp
        for entry in sorted(os.listdir(directory)):
            if entry.startswith("model_b") and entry.endswith(".stablehlo"):
                with open(os.path.join(directory, entry), "rb") as f:
                    exp = jax_export.deserialize(f.read())
                self._exported[exp.in_avals[-1].shape[0]] = exp
        if not self._exported:
            raise FileNotFoundError(
                f"no model.stablehlo / model_b*.stablehlo under {directory}")
        data = np.load(os.path.join(directory, _PARAMS_FILE))
        # The exported call takes the params pytree flattened in the same
        # order jax.export recorded; rebuild the nested dict from the npz
        # key paths (utils/checkpoint.py save format: "a/b/0/c").
        self._params = _unflatten_npz(data)
        with open(os.path.join(directory, _CONFIG_FILE)) as f:
            payload = json.load(f)
        self.config, _, _ = configs_from_dict(payload)
        #: Baked-postprocess spec (normalize_postprocess form) or None.
        #: When set, __call__ returns the postprocess_detections tuple
        #: ``(scores, class_ids, boxes, valid)`` instead of raw decoded.
        self.postprocess = payload.get("postprocess")

    @property
    def batch_sizes(self) -> tuple:
        return tuple(sorted(self._exported))

    @property
    def batch_size(self) -> int:
        """Largest exported batch (the single-graph batch for non-bundles)."""
        return max(self._exported)

    def __call__(self, images) -> jnp.ndarray:
        images = jnp.asarray(images)
        if jnp.issubdtype(images.dtype, jnp.integer):
            # Same [-1,1] normalization every other inference path
            # applies to uint8 (Detector/DetectionService); a silent
            # 0..255 float cast fed the graph ~127x-out-of-range inputs.
            # ANY integer dtype means raw pixel values (int32 is numpy's
            # default for python-list images), not [-1,1] floats.
            images = images.astype(jnp.float32) / 127.5 - 1.0
        images = images.astype(jnp.float32)
        request = images.shape[0]
        fits = [b for b in sorted(self._exported) if b >= request]
        if not fits:
            raise ValueError(
                f"request batch {request} exceeds the largest exported "
                f"batch {max(self._exported)}; re-export with a larger "
                "batch size")
        batch = fits[0]
        if batch != request:
            images = jnp.pad(images, ((0, batch - request),) + ((0, 0),) * 3)
        out = self._exported[batch].call(self._params, images)
        if isinstance(out, (tuple, list)):
            # Baked-postprocess graphs return the postprocess_detections
            # tuple; slice the padding off every leaf, not the tuple.
            return tuple(leaf[:request] for leaf in out)
        return out[:request]


def load_exported(directory: str) -> ExportedDetector:
    return ExportedDetector(directory)


def _unflatten_npz(data) -> dict:
    """'a/b/0/c' npz keys -> nested dicts/lists (inverse of
    utils/checkpoint.py:save_params_npz for the pytrees init_params
    builds: dicts with string keys and lists with int indices)."""
    root: dict = {}
    for flat_key in data.files:
        parts = flat_key.split("/")
        node = root
        for i, part in enumerate(parts):
            last = i == len(parts) - 1
            key = int(part) if part.isdigit() else part
            if last:
                _assign(node, key, np.asarray(data[flat_key]))
            else:
                nxt_is_idx = parts[i + 1].isdigit()
                child = _lookup(node, key)
                if child is None:
                    child = [] if nxt_is_idx else {}
                    _assign(node, key, child)
                node = child
    return root


def _lookup(node, key):
    if isinstance(node, list):
        return node[key] if key < len(node) else None
    return node.get(key)


def _assign(node, key, value):
    if isinstance(node, list):
        while len(node) <= key:
            node.append(None)
        node[key] = value
    else:
        node[key] = value
