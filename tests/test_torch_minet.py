"""The port's MINet-VGG16 against the JAX package's, on the CPU.

One JAX ``init`` at 32 px is carried into the port by ``weights.py``
(its BatchNorm statistics randomised first, so activations stay O(1)
through the 40-odd conv layers instead of halving at every ReLU), and
both sides run the same numpy inputs.  The JAX side is the XLA arm
(``conv_impl="xla"``, ``resample_impl="fast"``): its fused Pallas arm
does not run on this jax, and the JAX package's tests assert the two
arms equal in f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sod_project_tpu.models.minet import MINet as JaxMINet
from distributed_sod_project_tpu_torch.configs import (DataConfig,
                                                       ModelConfig,
                                                       ServeConfig,
                                                       get_config)
from distributed_sod_project_tpu_torch.eval.inference import make_forward
from distributed_sod_project_tpu_torch.kernels import fused_conv as fc
from distributed_sod_project_tpu_torch.kernels import fused_resample as fr
from distributed_sod_project_tpu_torch.models import build_model
from distributed_sod_project_tpu_torch.serve import (InferenceEngine,
                                                     preprocess_image)
from distributed_sod_project_tpu_torch.weights import from_jax_variables

S = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run puts six pytest workers on the machine's cores;
    torch's default of one intra-op thread per core oversubscribes them
    and slows these small CPU forwards many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomise_bn(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomise_bn(v, rng)
        elif k == "var":  # ~0.5: (x-m)/sqrt(var) doubles what ReLU halves
            out[k] = rng.uniform(0.3, 0.7, v.shape).astype(np.float32)
        elif k == "mean":
            out[k] = (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        elif k == "bias":
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def pair():
    """(numpy variables, inputs, JAX f32 logits, JAX bf16 logits)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, S, S, 3)).astype(np.float32)
    jm = JaxMINet(backbone="vgg16", backbone_bn=True, conv_impl="xla",
                  resample_impl="fast")
    v = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x[:1]))
    v = _randomise_bn(jax.tree_util.tree_map(np.asarray, v), rng)

    def logits(model):
        fn = jax.jit(lambda v, x: model.apply(v, x, train=False)[0])
        return np.asarray(fn(v, jnp.asarray(x)))

    jm_bf16 = JaxMINet(backbone="vgg16", backbone_bn=True, conv_impl="xla",
                       resample_impl="fast", dtype=jnp.bfloat16)
    return v, x, logits(jm), logits(jm_bf16)


def _port(v, compute_dtype):
    return from_jax_variables(
        v, build_model(ModelConfig(compute_dtype=compute_dtype)))


def test_minet_vgg16_f32_logits_and_probs_match_jax(pair):
    v, x, want, _ = pair
    model = _port(v, "float32")
    with torch.inference_mode():
        got = model(torch.from_numpy(x))[0].numpy()
    assert got.shape == want.shape == (2, S, S, 1)
    # f32 both sides; ~40 convs of up to 1728-term sums in another
    # order: 1e-4 of the logit scale (the maps here reach |35|).
    scale = np.abs(want).max()
    assert scale > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    probs = make_forward(model)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(probs, jax.nn.sigmoid(want[..., 0]),
                               rtol=0, atol=1e-4)


def test_minet_vgg16_bf16_compute_matches_jax_to_bf16_rounding(pair):
    """bf16 compute (f32 params, the ``f32`` serving arm).  The two
    sides round at different places: the kernel's epilogue and resample
    lerp run in f32 and round once, where the JAX XLA arm rounds after
    every bf16 op.  So neither is the other's reference; both are held
    against the f32 answer, and the port may not stray further from it
    than JAX's own bf16 forward does (with 25% slack), nor from JAX's
    bf16 logits by more than 5% of the logit scale (bf16 carries 8 bits;
    ~40 layers of rounding compound to a few percent)."""
    v, x, want32, want16 = pair
    model = _port(v, "bfloat16")
    with torch.inference_mode():
        got = model(torch.from_numpy(x))[0].numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    scale = np.abs(want32).max()
    err_port = np.abs(got - want32).max()
    err_jax = np.abs(want16 - want32).max()
    assert err_port <= 1.25 * err_jax, (err_port, err_jax)
    np.testing.assert_allclose(got, want16, rtol=0, atol=0.05 * scale)


def test_minet_torchvision_vgg_layout_matches_jax():
    """``backbone_bn=False``: the classic VGG16 layout, biased convs and
    no BatchNorm in the backbone (the ``bias`` epilogue of the kernel)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, S, S, 3)).astype(np.float32)
    jm = JaxMINet(backbone="vgg16", backbone_bn=False, conv_impl="xla",
                  resample_impl="fast")
    v = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(x))
    v = _randomise_bn(jax.tree_util.tree_map(np.asarray, v), rng)
    want = np.asarray(jax.jit(
        lambda v, x: jm.apply(v, x, train=False)[0])(v, jnp.asarray(x)))
    model = from_jax_variables(v, build_model(ModelConfig(
        backbone_bn=False, compute_dtype="float32")))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_forward_launches_68_convs_and_18_resamples(pair, monkeypatch):
    """Every conv and every 2x resample of the forward goes through the
    kernel wrappers: VGG 13 + AIM 18 + SIM 35 + head 2 convs, and AIM 4
    + SIM 10 + decoder 4 resamples."""
    v, x, _, _ = pair
    calls = {"conv": 0, "resample": 0}

    def counting(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fc, "fused_conv", counting(fc.fused_conv, "conv"))
    monkeypatch.setattr(fr, "fused_upsample2",
                        counting(fr.fused_upsample2, "resample"))
    monkeypatch.setattr(fr, "fused_upsample2_merge",
                        counting(fr.fused_upsample2_merge, "resample"))
    with torch.inference_mode():
        _port(v, "float32")(torch.from_numpy(x[:1]))
    assert calls == {"conv": 68, "resample": 18}


def test_engine_from_jax_variables_serves_the_jax_model(pair):
    """The engine built from the JAX variables answers with the loaded
    model's probabilities (held against JAX by the f32 test above); the
    request is already at the 32-px bucket, so no resize is involved."""
    v = pair[0]
    cfg = get_config("minet_vgg16_ref")
    cfg = dataclasses.replace(
        cfg, data=DataConfig(image_size=(S, S)),
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        serve=ServeConfig(batch_buckets=(1,), precision_arms=("f32",)))
    eng = InferenceEngine.from_jax_variables(cfg, v, device="cpu").start()
    try:
        img = np.random.default_rng(2).integers(0, 256, (S, S, 3), np.uint8)
        pred, meta = eng.predict(img)
    finally:
        eng.stop()
    x0 = preprocess_image(img, S, cfg.data.normalize_mean,
                          cfg.data.normalize_std)
    want = make_forward(_port(v, "float32"))(torch.from_numpy(x0[None]))
    assert meta["batch_bucket"] == 1
    np.testing.assert_array_equal(pred, want[0].numpy())


def test_from_jax_variables_rejects_missing_extra_and_misshapen(pair):
    v = pair[0]
    model = build_model(ModelConfig())

    def copy(tree):
        return {k: copy(t) if isinstance(t, dict) else t
                for k, t in tree.items()}

    missing = copy(v)
    del missing["params"]["SIM_2"]["ConvBNAct_4"]["BatchNorm_0"]["scale"]
    with pytest.raises(KeyError, match="SIM_2/ConvBNAct_4/BatchNorm_0/scale"):
        from_jax_variables(missing, model)
    extra = copy(v)
    extra["params"]["AIM_0"]["ConvBNAct_9"] = {
        "Conv_0": {"kernel": np.zeros((3, 3, 64, 64), np.float32)}}
    with pytest.raises(ValueError, match="not consumed"):
        from_jax_variables(extra, model)
    wrong = copy(v)
    wrong["params"]["Conv_0"]["kernel"] = np.zeros((3, 3, 32, 2), np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax_variables(wrong, model)


@pytest.mark.parametrize("field,value", [("conv_impl", "xla"),
                                         ("resample_impl", "fast"),
                                         ("name", "u2net"),
                                         ("backbone", "resnet50")])
def test_build_model_is_loud_on_knobs_it_does_not_implement(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(ModelConfig(**{field: value}))
