"""Runtime rules: the compile-cache location, the measurement entry points'
refusal to run without a GPU, and loading configs written before an
option was removed."""

import json
import os
import subprocess
import sys

import jax
import pytest

from vision_transformer_detector.config import (
    DetectorConfig, configs_from_dict, configs_to_dict)
from vision_transformer_detector.utils import runtime

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compilation_cache_dir_rule(env_dir, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the only cache directory:
    enable_compilation_cache sets none of its own. Unset, the cache is
    the in-checkout .jax_cache, found relative to the package."""
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            runtime.enable_compilation_cache()
            assert jax.config.jax_compilation_cache_dir == os.path.join(
                REPO_DIR, ".jax_cache")
        else:
            marker = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", marker)
            jax.config.update("jax_compilation_cache_dir", marker)
            runtime.enable_compilation_cache()
            assert jax.config.jax_compilation_cache_dir == marker
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_measurement_scripts_refuse_cpu(script):
    """Without a GPU both scripts exit nonzero and print no metric or
    result line: no fallback to the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO_DIR, script)],
                          cwd=REPO_DIR, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    for line in proc.stdout.splitlines():
        try:
            record = json.loads(line)
        except ValueError:
            continue
        assert "metric" not in record and "ok" not in record, line


@pytest.mark.parametrize("removed,value,loads", [
    ("use_fused_ffn", False, True),
    ("use_fused_layer_norm", False, True),
    ("use_fused_ffn", True, False),
])
def test_configs_from_dict_removed_options(removed, value, loads):
    """A config.json written before the fused-kernel options were removed
    loads when they hold their off value, and is refused when one asks
    for the removed path."""
    data = configs_to_dict(DetectorConfig(embedding_dim=16))
    data["detector"][removed] = value
    data = json.loads(json.dumps(data))
    if loads:
        detector, _, _ = configs_from_dict(data)
        assert detector == DetectorConfig(embedding_dim=16)
    else:
        with pytest.raises(ValueError, match=removed):
            configs_from_dict(data)
