"""JAX framework with the capabilities of
westlake-moonlight/vision_transformer_detector.

A convolution-free, anchor-free ViT COCO detector rebuilt in JAX:
  * models/   — pure-functional ViT detector (patchify -> encoder -> head)
  * ops/      — geometry, decode, loss (static-shape jnp)
  * kernels/  — attention (cuDNN fused or chunked VJP), ring attention,
                int8 serving layers
  * metrics/  — streaming COCO-style mAP (reference-exact)
  * data/     — annotation loading + host/device input pipeline
  * train/    — optax + SPMD-data-parallel training loop, checkpointing
  * parallel/ — mesh + sharding helpers
  * utils/    — visualization, plotting, debugging
"""

from .config import (  # noqa: F401
    DetectorConfig,
    LossConfig,
    TrainConfig,
    EMPTY_SLOT_VALUE,
    EPSILON,
    get_config,
    PRESETS,
)

__version__ = "0.1.0"
