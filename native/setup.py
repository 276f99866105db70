"""Build the native pipeline extension.

Usage (from the repo root):
  python native/setup.py build_ext --build-lib vision_transformer_detector/_native
or via tools/build_native.sh.
"""

from setuptools import Extension, setup

setup(
    name="vtd_native_pipeline",
    version="0.1.0",
    ext_modules=[
        Extension(
            "_native_pipeline",
            sources=["native/pipeline.cc"],
            libraries=["jpeg"],
            extra_compile_args=["-O3", "-std=c++17", "-fvisibility=hidden"],
        ),
        Extension(
            "_native_coco_json",
            sources=["native/coco_json.cc"],
            extra_compile_args=["-O3", "-std=c++17", "-fvisibility=hidden"],
        ),
        Extension(
            "_native_coco_eval",
            sources=["native/coco_eval.cc"],
            extra_compile_args=["-O3", "-std=c++17", "-fvisibility=hidden"],
        ),
    ],
)
