"""Smoke test of the detector on one GPU, or on four with --four-cards.

Drives the main paths once, at full model width with random weights made
from fixed seeds, through the entry points a user calls, and checks what
comes out against the repo's plain references:

  1. device     — JAX's devices and the card's name and power limit,
  2. attention  — each attention route the presets take, forward and
                  gradient, against the float32 einsum oracle,
  3. infer      — vit_b16_384 at batch 64 through forward + decode,
  4. train      — Trainer.train_step on vit_b16_384 and reference_608,
  5. serve      — DetectionService, an exported artifact reloaded through
                  ExportedDetectionService, and the int8 path,
  6. gpu tests  — the tests marked ``gpu``, run inside this process.

  python chip_smoke.py               # one card, the phases above
  python chip_smoke.py --four-cards  # four cards: DP, TP and ring only

Each phase prints one JSON line; any failure raises and exits nonzero.
The last line is ``{"ok": true, "device": {...}}``. Without a GPU, or
without the rest of the repository beside this file, the run stops with
a nonzero exit code and prints no result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

REPO_DIR = os.path.dirname(os.path.abspath(__file__))
# (phase 2) bf16 carries 8 mantissa bits: the route and the fp32 oracle
# see the same bf16 inputs, and the route's bf16 output and probabilities
# round at ~4e-3 of each value.
BF16_TOL = 2e-2
# float32 under the default matmul precision runs its dots in TF32 on
# this card (10 mantissa bits, ~1e-3 per product); under "highest" both
# sides are fp32 and differ only in summation order.
TF32_TOL = 1e-2
FP32_TOL = 1e-4


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def _errors(got, want) -> dict:
    """Max abs error and max error relative to the reference's max abs."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    abs_err = float(np.max(np.abs(got - want)))
    return {"max_abs": abs_err,
            "max_rel": abs_err / max(float(np.max(np.abs(want))), 1e-30)}


def _peak_bytes(device) -> int:
    return device.memory_stats()["peak_bytes_in_use"]


def _check(name: str, errors: dict, tol: float) -> None:
    if not errors["max_rel"] <= tol:
        raise AssertionError(f"{name}: max_rel {errors['max_rel']} > {tol}")


def _synthetic_batch(config, batch: int, seed: int):
    """Fixed images in [-1, 1] and labels with three boxes per image."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = config.image_size
    images = rng.uniform(-1, 1, (batch, h, w, 3)).astype(np.float32)
    labels = np.full((batch, config.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    for slot, (cls, fy, fx, fh, fw) in enumerate(
            [(3, .3, .3, .2, .25), (17, .6, .5, .3, .2),
             (56, .7, .8, .15, .1)]):
        labels[:, slot] = (1, cls, fx * w, fy * h, fh * h, fw * w)
    return images, labels


# ---------------------------------------------------------------------------
# 1. device


def phase_device(need: int):
    import jax

    from vision_transformer_detector.utils.runtime import (
        enable_compilation_cache, gpu_name_and_power_limit, require_gpu)

    devices = require_gpu()
    if len(devices) < need:
        raise SystemExit(f"needs {need} GPUs, JAX found {devices}")
    enable_compilation_cache()
    card = gpu_name_and_power_limit()
    print(card, flush=True)
    emit(phase="device", devices=[str(d) for d in devices],
         platform=devices[0].platform, kind=devices[0].device_kind,
         count=len(devices), card=card,
         jax_version=jax.__version__,
         compile_cache=jax.config.jax_compilation_cache_dir)
    return devices


# ---------------------------------------------------------------------------
# 2. attention

# (preset, batch, N, H, K, dtype, dropout): each preset's attention shape;
# highres_1024's batch is 2 images x 16 windows of 256 tokens.
ATTENTION_CASES = [
    ("vit_b16_384", 8, 576, 12, 64, "bfloat16", None),
    ("vit_l16_640", 4, 1600, 16, 64, "bfloat16", None),
    ("highres_1024", 32, 256, 16, 64, "bfloat16", None),
    ("reference_608", 8, 1296, 8, 40, "float32", 0.1),
]


def preset_routes() -> dict:
    """The attention route each preset takes, inference and training."""
    import jax

    from vision_transformer_detector.config import PRESETS
    from vision_transformer_detector.kernels.flash_attention import (
        attention_implementation)

    routes = {}
    for name, make in PRESETS.items():
        cfg = make()

        def route(use_flash, dropout):
            if not use_flash:
                return "ring" if cfg.ring_attention else "einsum"
            return attention_implementation(
                jax.default_backend(), cfg.compute_dtype, dropout,
                cfg.key_dim)

        train_flash = (cfg.use_flash_attention
                       if cfg.train_use_flash_attention is None
                       else cfg.train_use_flash_attention)
        routes[name] = {
            "infer": route(cfg.use_flash_attention, False),
            "train": route(train_flash, cfg.dropout not in (None, 0.0))}
    return routes


def _masked_reference(q, k, v, rate, seed):
    """Dropout-after-softmax oracle with the counter mask (float32)."""
    import jax
    import jax.numpy as jnp

    from vision_transformer_detector.kernels.flash_attention import (
        _keep_threshold, dropout_keep_mask, reference_attention)

    if rate is None:
        return reference_attention(q, k, v)
    b, n, h, _ = q.shape
    pos = jnp.arange(n, dtype=jnp.uint32)
    bh = jnp.arange(b * h, dtype=jnp.uint32).reshape(b, h)
    keep = dropout_keep_mask(
        jnp.uint32(seed), bh[:, :, None, None], pos[None, None, :, None],
        pos[None, None, None, :], _keep_threshold(rate))
    probs = jax.nn.softmax(jnp.einsum("bnhk,bmhk->bhnm", q, k), axis=-1)
    probs = jnp.where(keep, probs / (1.0 - rate), 0.0)
    return jnp.einsum("bhnm,bmhk->bnhk", probs, v)


def phase_attention() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vision_transformer_detector.kernels.flash_attention import (
        attention_implementation, flash_attention)

    emit(phase="attention_routes", routes=preset_routes())
    seed = 1234
    for preset, b, n, h, kd, dtype, rate in ATTENTION_CASES:
        keys = jax.random.split(jax.random.PRNGKey(n), 4)
        q, k, v = (jax.random.normal(r, (b, n, h, kd), jnp.float32)
                   .astype(dtype) for r in keys[:3])
        q = (q.astype(jnp.float32) / np.sqrt(kd)).astype(dtype)
        g = jax.random.normal(keys[3], (b, n, h, kd), jnp.float32)
        impl = attention_implementation(jax.default_backend(), dtype,
                                        rate is not None, kd)

        def route(q, k, v):
            return flash_attention(q, k, v, dropout_rate=rate,
                                   dropout_seed=seed if rate else None)

        def oracle(q, k, v):
            return _masked_reference(*(t.astype(jnp.float32)
                                       for t in (q, k, v)), rate, seed)

        def grads(fn):
            return jax.jit(jax.grad(
                lambda q, k, v: jnp.sum(fn(q, k, v).astype(jnp.float32)
                                        * g), argnums=(0, 1, 2)))

        with jax.default_matmul_precision("highest"):
            want = jax.jit(oracle)(q, k, v)
            want_g = grads(oracle)(q, k, v)
        precisions = ["default", "highest"] if dtype == "float32" else [
            "default"]
        for precision in precisions:
            with jax.default_matmul_precision(
                    None if precision == "default" else "highest"):
                got = jax.jit(route)(q, k, v)
                got_g = grads(route)(q, k, v)
            if dtype == "bfloat16":
                tol, reason = BF16_TOL, "bf16 inputs and outputs"
            elif precision == "default":
                tol, reason = TF32_TOL, "float32 dots run in TF32"
            else:
                tol, reason = FP32_TOL, "float32 dots, summation order"
            fwd = _errors(got, want)
            bwd = [_errors(a, c) for a, c in zip(got_g, want_g)]
            emit(phase="attention", preset=preset, implementation=impl,
                 shape=[b, n, h, kd], dtype=dtype, dropout=rate,
                 precision=precision, forward=fwd,
                 grad_q=bwd[0], grad_k=bwd[1], grad_v=bwd[2],
                 tol=tol, tol_reason=reason,
                 reference="float32 einsum, precision highest")
            _check(f"{preset} forward ({precision})", fwd, tol)
            for name, err in zip("qkv", bwd):
                _check(f"{preset} grad_{name} ({precision})", err, tol)


# ---------------------------------------------------------------------------
# 3. infer


def phase_infer(devices, batch: int = 64):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vision_transformer_detector.config import vit_b16_384
    from vision_transformer_detector.models.vit_detector import (
        forward, init_params)
    from vision_transformer_detector.ops.decode import transform_predictions

    config = vit_b16_384()
    params = init_params(jax.random.PRNGKey(0), config)
    h, w = config.image_size
    images = jax.random.uniform(jax.random.PRNGKey(1), (batch, h, w, 3),
                                minval=-1.0, maxval=1.0)

    def infer(params, images, config=config):
        return transform_predictions(forward(params, images, config), config)

    tic = time.perf_counter()
    compiled = jax.jit(infer).lower(params, images).compile()
    compile_s = time.perf_counter() - tic
    mem = compiled.memory_analysis()
    out = np.asarray(jax.block_until_ready(compiled(params, images)))
    if out.shape != (batch, config.max_objects, 6):
        raise AssertionError(f"infer output shape {out.shape}")
    if not np.isfinite(out).all():
        raise AssertionError("infer output not finite")

    # The same weights on two images through the float32 einsum model
    # under precision "highest": the bf16 model stays close to it.
    small = images[:2]
    ref_config = config.replace(compute_dtype="float32",
                                use_flash_attention=False)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, x: forward(p, x, ref_config))(params, small)
    got = jax.jit(lambda p, x: forward(p, x, config))(params, small)
    finite = {"bf16": bool(np.isfinite(np.asarray(got)).all()),
              "float32": bool(np.isfinite(np.asarray(ref)).all())}
    err = _errors(got, ref)
    emit(phase="infer", preset="vit_b16_384", batch=batch,
         output_shape=list(out.shape), finite=True,
         compile_s=compile_s,
         memory_analysis={
             k: getattr(mem, k) for k in (
                 "argument_size_in_bytes", "output_size_in_bytes",
                 "temp_size_in_bytes", "generated_code_size_in_bytes")},
         peak_bytes_in_use=_peak_bytes(devices[0]),
         logits_finite=finite, logits_vs_float32_reference=err, tol=0.1,
         tol_reason="12 bf16 blocks against float32, random weights")
    _check("infer logits vs float32 reference", err, 0.1)
    return config, params


# ---------------------------------------------------------------------------
# 4. train


def _train_losses(trainer, images, labels, steps: int):
    import jax

    state = trainer.init_state()
    images_d, labels_d = trainer._put_batch(images, labels)
    rng = jax.random.PRNGKey(0)
    losses, times = [], []
    with trainer._mesh_context():
        for _ in range(steps):
            tic = time.perf_counter()
            state, loss = trainer.train_step(state, images_d, labels_d, rng)
            losses.append(float(loss))
            times.append(time.perf_counter() - tic)
    return losses, times


def phase_train(devices, steps: int = 6) -> None:
    import numpy as np

    from vision_transformer_detector.config import (
        LossConfig, TrainConfig, get_config)
    from vision_transformer_detector.train.trainer import Trainer

    routes = preset_routes()
    # (preset, batch, learning rate): from random weights on one fixed
    # batch, vit_b16_384 at 1e-4 overshoots after three steps (its loss
    # climbs back above the first step's, with cuDNN and einsum attention
    # alike); at 1e-5 it falls and stays down.
    for name, batch, lr in (("vit_b16_384", 16, 1e-5),
                            ("reference_608", 8, 1e-4)):
        config = get_config(name)
        trainer = Trainer(config, LossConfig(),
                          TrainConfig(learning_rate=lr, batch_size=batch))
        images, labels = _synthetic_batch(config, batch, seed=5)
        losses, times = _train_losses(trainer, images, labels, steps)
        emit(phase="train", preset=name, batch=batch, learning_rate=lr,
             attention=routes[name]["train"], losses=losses,
             compile_and_first_step_s=times[0],
             later_step_s=times[1:],
             peak_bytes_in_use=_peak_bytes(devices[0]))
        if not np.isfinite(losses).all():
            raise AssertionError(f"{name} train loss not finite: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{name} train loss did not fall: {losses}")


# ---------------------------------------------------------------------------
# 5. serve


def _same_detections(a, b) -> bool:
    if len(a) != len(b):
        return False
    for da, db in zip(a, b):
        if len(da) != len(db):
            return False
        for x, y in zip(da, db):
            if x["class_id"] != y["class_id"]:
                return False
            if abs(x["score"] - y["score"]) > 1e-2:
                return False
            if any(abs(x["box"][c] - y["box"][c]) > 0.5 for c in x["box"]):
                return False
    return True


def phase_serve(config, params) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vision_transformer_detector.config import DetectorConfig
    from vision_transformer_detector.export import (
        export_program, save_exported)
    from vision_transformer_detector.kernels.quantization import (
        _quantize_dense_layer, int8_dense, quantize_params)
    from vision_transformer_detector.models.vit_detector import (
        forward, init_params)
    from vision_transformer_detector.ops.decode import transform_predictions
    from vision_transformer_detector.serving import (
        DetectionService, ExportedDetectionService)

    h, w = config.image_size
    rng = np.random.default_rng(7)
    requests = [rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
                for n in (1, 1, 8)]
    service = DetectionService(config, params)
    tic = time.perf_counter()
    live = [service.detect_array(r) for r in requests]
    live_s = time.perf_counter() - tic

    # An artifact file is jax.export's serialization, which needs the
    # flatbuffers package. Where it is missing, the exported programs
    # are built and run in memory against the live decode instead of
    # being written, reloaded and served.
    serializable = importlib.util.find_spec("flatbuffers") is not None
    tic = time.perf_counter()
    if serializable:
        with tempfile.TemporaryDirectory() as tmp:
            save_exported(tmp, params, config, batch_size=[1, 8])
            exported = ExportedDetectionService(tmp)
            reloaded = [exported.detect_array(r) for r in requests]
        if not all(_same_detections(a, b) for a, b in zip(live, reloaded)):
            raise AssertionError("exported service detections differ from "
                                 "the live service's")
        exported_err = None
    else:
        programs = {b: export_program(params, config, b) for b in (1, 8)}
        live_decode = jax.jit(lambda p, x: transform_predictions(
            forward(p, x, config), config))
        diff = np.zeros(6)
        for r in requests:
            x = jnp.asarray(r).astype(jnp.float32) / 127.5 - 1.0
            got = programs[len(r)].call(params, x)
            want = live_decode(params, x)
            diff = np.maximum(diff, np.max(np.abs(np.asarray(got - want)),
                                           axis=(0, 1)))
        exported_err = diff.tolist()
        # Per decoded column, _same_detections' bounds: 1e-2 on the
        # objectness score, half a class or a pixel on the rest.
        if not (diff[0] <= 1e-2 and np.all(diff[1:] <= 0.5)):
            raise AssertionError(f"exported program differs from the live "
                                 f"decode by {exported_err} per column")
    export_s = time.perf_counter() - tic
    emit(phase="serve", preset="vit_b16_384",
         requests=[len(r) for r in requests],
         detections_per_image=[len(d) for batch in live for d in batch],
         live_first_calls_s=live_s, export_s=export_s,
         exported_batch_sizes=[1, 8],
         exported=("file written, reloaded and served" if serializable else
                   "in memory: flatbuffers is not installed, so no file"),
         exported_vs_live_max_abs_per_column=exported_err,
         exported_matches_live=True)

    # int8: one dense layer at this model's MLP width against float32, in
    # tests/test_quantization.py's tolerance (2% of the output's max),
    # then the quantized model end to end.
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    layer = {"kernel": np.asarray(jax.random.normal(
                 keys[0], (768, 3072)) * 0.3, np.float32),
             "bias": np.asarray(jax.random.normal(keys[1], (3072,)) * 0.1,
                                np.float32)}
    x = jax.random.normal(keys[2], (64, 576, 768))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(x) @ layer["kernel"] + layer["bias"]
    got = jax.jit(int8_dense)(x, _quantize_dense_layer(layer))
    layer_err = _errors(got, want)
    _check("int8_dense vs float32", layer_err, 0.02)

    qparams = quantize_params(params)
    images = jnp.asarray(requests[2]).astype(jnp.float32) / 127.5 - 1.0
    qout = np.asarray(jax.jit(lambda p, x: transform_predictions(
        forward(p, x, config), config))(qparams, images))
    if qout.shape != (8, config.max_objects, 6) or not np.isfinite(
            qout).all():
        raise AssertionError("int8 forward output bad")

    # tests/test_quantization.py's drop-in check at its own config.
    tiny = DetectorConfig(
        image_size=(34, 34), embedding_dim=8, num_heads=2, key_dim=4,
        encoder_blocks=1, encoder_mlp_layers=2, head_last_units=8,
        head_layers=1)
    tparams = init_params(jax.random.PRNGKey(0), tiny)
    timages = jax.random.uniform(jax.random.PRNGKey(1), (2, 34, 34, 3),
                                 minval=-1, maxval=1)

    def decoded(p):
        return np.asarray(jax.jit(lambda p, x: transform_predictions(
            forward(p, x, tiny), tiny))(p, timages))

    dec, qdec = decoded(tparams), decoded(quantize_params(tparams))
    obj_err = float(np.max(np.abs(qdec[..., 0] - dec[..., 0])))
    center_err = float(np.max(np.abs(qdec[..., 2:4] - dec[..., 2:4])))
    emit(phase="serve_int8", dense_768x3072=layer_err, dense_tol=0.02,
         model_output_shape=list(qout.shape), finite=True,
         tiny_objectness_err=obj_err, tiny_objectness_tol=0.05,
         tiny_center_err_px=center_err, tiny_center_tol_px=2.0)
    if not (obj_err <= 0.05 and center_err <= 2.0):
        raise AssertionError("int8 drop-in outside the test's tolerance")


# ---------------------------------------------------------------------------
# 6. gpu tests


def phase_gpu_tests() -> None:
    import pytest

    class Count:
        passed = 0
        failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1
            elif report.failed:
                Count.failed += 1

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO_DIR, "tests", "test_kernels.py")],
                     plugins=[Count()])
    emit(phase="gpu_tests", exit_code=int(rc), passed=Count.passed,
         failed=Count.failed)
    if rc != 0 or Count.passed == 0 or Count.failed:
        raise AssertionError("gpu-marked tests failed or did not run")


# ---------------------------------------------------------------------------
# Four cards


# (check, rtol, reason): losses are fp32 reductions of bf16 models, and
# the sharded programs round and sum in another order than one card.
FOUR_CARD_RTOL = 2e-2
FOUR_CARD_REASON = ("bf16 model; sharded matmuls and reductions round and "
                    "associate in another order than one card")


def four_card_checks(devices, base=None, ring_base=None, batch=16,
                     ring_batch=2) -> None:
    """DP=4 and data=2 x model=2 train steps against one card, and ring
    attention over model=4 against exact global attention on one card.
    Each compares the losses of two steps from one seed on one batch."""
    import numpy as np

    from vision_transformer_detector.config import (
        LossConfig, TrainConfig, highres_1024_ring, vit_b16_384)
    from vision_transformer_detector.parallel.mesh import create_mesh
    from vision_transformer_detector.train.trainer import Trainer

    devs = list(devices[:4])
    train_config = TrainConfig(learning_rate=1e-5, seed=3)

    def compare(check, config, mesh, images, labels):
        solo, _ = _train_losses(Trainer(config, LossConfig(), train_config),
                                images, labels, 2)
        sharded, times = _train_losses(
            Trainer(config, LossConfig(), train_config, mesh=mesh),
            images, labels, 2)
        rel = [abs(a - b) / abs(b) for a, b in zip(sharded, solo)]
        emit(phase="four_cards", check=check, mesh=dict(mesh.shape),
             sharded_losses=sharded, one_card_losses=solo, rel_diff=rel,
             rtol=FOUR_CARD_RTOL, rtol_reason=FOUR_CARD_REASON,
             compile_and_first_step_s=times[0])
        if not (np.isfinite(sharded).all()
                and max(rel) <= FOUR_CARD_RTOL):
            raise AssertionError(f"{check}: {sharded} vs {solo}")

    config = base or vit_b16_384()
    images, labels = _synthetic_batch(config, batch, seed=9)
    compare("dp_equal_loss", config,
            create_mesh(data=4, model=1, devices=devs), images, labels)
    compare("tp_equal_loss", config,
            create_mesh(data=2, model=2, devices=devs), images, labels)
    # Depth cut to two blocks: the check is the ring exchange, which every
    # block repeats; the token count (4,096) and widths are the preset's.
    ring = ring_base or highres_1024_ring().replace(encoder_blocks=2)
    images, labels = _synthetic_batch(ring, ring_batch, seed=10)
    compare("ring_vs_exact_loss", ring,
            create_mesh(data=1, model=4, devices=devs), images, labels)


# ---------------------------------------------------------------------------


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card DP, TP and ring checks")
    args = parser.parse_args(argv)
    # Set before JAX is imported: a JAX whose CUDA plugin fails to start
    # would otherwise fall back to the CPU with only a warning.
    os.environ["JAX_PLATFORMS"] = "cuda"
    # No phase decodes JPEGs; skip building the native extensions.
    os.environ["VTD_NO_NATIVE_BUILD"] = "1"
    sys.path.insert(0, REPO_DIR)

    import vision_transformer_detector  # noqa: F401  (fails without repo)

    devices = phase_device(4 if args.four_cards else 1)
    if args.four_cards:
        four_card_checks(devices)
    else:
        phase_attention()
        config, params = phase_infer(devices)
        phase_train(devices)
        phase_serve(config, params)
        phase_gpu_tests()
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
