"""The port's serving slice on the CPU: the engine, its batcher and
host helpers against the JAX package's, the device rule, and the rule
that the port imports nothing of JAX."""

import ast
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_sod_project_tpu.eval import inference as jinf
from distributed_sod_project_tpu.serve import batcher as jbatcher
from distributed_sod_project_tpu.serve.engine import (
    preprocess_image as jax_preprocess)
from distributed_sod_project_tpu_torch import resolve_device
from distributed_sod_project_tpu_torch.configs import (DataConfig,
                                                       ServeConfig,
                                                       get_config)
from distributed_sod_project_tpu_torch.eval import inference as tinf
from distributed_sod_project_tpu_torch.serve import (EngineStopped,
                                                     InferenceEngine,
                                                     preprocess_image)
from distributed_sod_project_tpu_torch.serve import batcher as tbatcher

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "distributed_sod_project_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "distributed_sod_project_tpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run puts six pytest workers on the machine's cores;
    torch's default of one intra-op thread per core oversubscribes them
    and slows these small CPU forwards many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_cfg(**serve):
    cfg = get_config("minet_vgg16_ref")
    return dataclasses.replace(
        cfg, data=DataConfig(image_size=(32, 32)),
        serve=dataclasses.replace(ServeConfig(), max_wait_ms=20.0, **serve))


def test_port_and_chip_smoke_import_nothing_of_jax_at_runtime():
    """Every module of the port, and chip_smoke.py, imports and a model
    builds and runs with JAX and the JAX package blocked."""
    code = f"""
import importlib, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
import torch
import distributed_sod_project_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
importlib.import_module("chip_smoke")
from distributed_sod_project_tpu_torch.configs import ModelConfig
from distributed_sod_project_tpu_torch.models import build_model
with torch.inference_mode():
    out = build_model(ModelConfig(compute_dtype="float32"))(
        torch.zeros(1, 32, 32, 3))
assert out[0].shape == (1, 32, 32, 1)
loaded = [k for k, v in sys.modules.items() if v is not None
          and k.split(".")[0] in {FORBIDDEN!r}]
assert not loaded, loaded
print("ISOLATED")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED" in proc.stdout


def test_no_source_of_the_port_names_jax():
    """Lazy imports inside functions included: no import statement in
    the port or chip_smoke.py reaches JAX or the JAX package."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.name}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert len(files) > 15 and not bad, bad


def test_entry_points_raise_without_a_gpu_unless_cpu_is_requested(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine.from_random_init(_small_cfg(), seed=0)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


@pytest.fixture(scope="module")
def engine():
    eng = InferenceEngine.from_random_init(_small_cfg(), seed=3,
                                           device="cpu").start()
    yield eng
    eng.stop()


def test_engine_answers_at_original_sizes_on_both_arms(engine):
    """Requests at sizes other than the 32-px bucket, both arms, in one
    burst (so groups coalesce): every answer comes back at its own size,
    finite, in [0, 1]."""
    assert engine.warmed == {(32, bb, arm) for bb in (1, 4, 8)
                             for arm in ("f32", "bf16")}
    rng = np.random.default_rng(0)
    sizes = [(32, 32), (20, 28), (45, 31), (64, 48), (7, 9), (33, 32)] * 2
    futs = []
    for i, hw in enumerate(sizes):
        img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        futs.append((hw, engine.submit(img, precision=("f32", "bf16")[i % 2])))
    for i, (hw, fut) in enumerate(futs):
        pred, meta = fut.result(timeout=120)
        assert pred.shape == hw and pred.dtype == np.float32
        assert np.isfinite(pred).all() and 0 <= pred.min() <= pred.max() <= 1
        assert meta["precision"] == ("f32", "bf16")[i % 2]
        assert meta["res_bucket"] == 32 and meta["batch_bucket"] in (1, 4, 8)
    snap = engine.stats_snapshot()
    assert snap["served"] >= len(sizes) and snap["errors"] == 0
    assert sum(snap["batches"].values()) >= 2
    for key, dev in snap["device_ms"].items():
        assert key.startswith("r32/b") and dev["n"] >= 1 and dev["p50"] > 0


def test_served_map_is_the_direct_forward_resized_back(engine):
    img = np.random.default_rng(5).integers(0, 256, (40, 24, 3), np.uint8)
    pred, meta = engine.predict(img, precision="f32")
    x = preprocess_image(img, 32, engine._mean, engine._std)
    batch = tinf.pad_to_batch({"image": x[None]}, meta["batch_bucket"])
    probs = engine._fwds["f32"](torch.from_numpy(batch["image"]))
    np.testing.assert_array_equal(
        pred, tinf._resize_pred(probs[0].numpy(), (40, 24)))


def test_engine_is_loud_on_arms_and_lifecycle():
    with pytest.raises(NotImplementedError, match="int8"):
        InferenceEngine.from_random_init(
            _small_cfg(precision_arms=("f32", "int8")), device="cpu")
    with pytest.raises(ValueError, match="not among"):
        InferenceEngine.from_random_init(
            _small_cfg(precision="bf16", precision_arms=("f32",)),
            device="cpu")
    eng = InferenceEngine.from_random_init(
        _small_cfg(batch_buckets=(1,)), device="cpu")
    with pytest.raises(EngineStopped):
        eng.submit(np.zeros((8, 8, 3), np.uint8))
    eng.start()
    with pytest.raises(ValueError, match="unknown precision"):
        eng.submit(np.zeros((8, 8, 3), np.uint8), precision="fp8")
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        eng.submit(np.zeros((8, 8), np.uint8))
    eng.stop()
    snap = eng.stats_snapshot()
    assert snap["submitted"] == 3 and snap["errors"] == 3


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _groups(mod):
    """Drive one batcher module through a fixed arrival script; returns
    the dispatched groups as (key, [ids])."""
    clock = _Clock()
    b = mod.DynamicBatcher((1, 2, 4), max_wait_s=1.0, clock=clock)
    script = [  # (t, res, arm) of each arrival
        (0.0, 32, "f32"), (0.1, 64, "f32"), (0.2, 32, "bf16"),
        (0.3, 64, "f32"), (0.4, 64, "f32"), (0.5, 64, "f32"),
        (0.6, 64, "f32"), (0.7, 32, "f32"), (2.5, 32, "bf16"),
        (2.6, 64, "bf16"), (2.7, 32, "bf16"), (0.8, 32, "f32")]
    ids, out = {}, []
    pulls = [0.55, 0.65, 1.05, 1.25, 1.75, 3.6, 3.7, 3.8]
    events = sorted([(t, 0, i) for i, (t, _, _) in enumerate(script)]
                    + [(t, 1, None) for t in pulls])
    for t, kind, i in events:
        clock.t = t
        if kind == 0:
            _, res, arm = script[i]
            r = mod.Request(tensor=np.zeros(1), orig_hw=(1, 1),
                            res_bucket=res, arrival=t, precision=arm)
            ids[id(r)] = i
            b.put(r)
        else:
            while b._next_group_locked(t) is not None:
                key, reqs = b.get_batch(idle_timeout_s=0.0)
                out.append((t, key, [ids[id(r)] for r in reqs],
                            b.pick_batch_bucket(len(reqs))))
    assert b.pending() == 0
    return out


def test_batcher_groups_exactly_as_the_jax_batcher():
    want = _groups(jbatcher)
    assert _groups(tbatcher) == want
    # the script exercises a full group jumping an older head, max-wait
    # releases and padding to a larger bucket
    assert (0.55, (64, "f32"), [1, 3, 4, 5], 4) in want
    assert any(len(g[2]) == 3 and g[3] == 4 for g in want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_preprocess_and_resize_back_match_the_jax_helpers(dtype):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (37, 50, 3)).astype(np.uint8)
    if dtype == np.float32:
        img = img.astype(np.float32) / 255.0
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    np.testing.assert_array_equal(preprocess_image(img, 32, mean, std),
                                  jax_preprocess(img, 32, mean, std))
    pred = rng.random((32, 32)).astype(np.float32)
    np.testing.assert_array_equal(tinf._resize_pred(pred, (37, 50)),
                                  jinf._resize_pred(pred, (37, 50)))
    batch = {"image": rng.random((3, 4, 4, 3)).astype(np.float32)}
    np.testing.assert_array_equal(tinf.pad_to_batch(batch, 8)["image"],
                                  jinf.pad_to_batch(batch, 8)["image"])
