#!/usr/bin/env bash
# Build the native JPEG-decode/letterbox extension into the package.
set -euo pipefail
cd "$(dirname "$0")/.."
mkdir -p vision_transformer_detector/_native
touch vision_transformer_detector/_native/__init__.py
python native/setup.py build_ext \
    --build-lib vision_transformer_detector/_native \
    --build-temp build/native >/dev/null
echo "built: $(ls vision_transformer_detector/_native/*.so)"
