"""The port's training path against the JAX package's, on the CPU.

One f32 step of MINet-VGG16 (``minet_r50_dp`` with ``model.backbone=
vgg16``: BCE + IoU + SSIM + CEL through the fused loss functions, SGD
with Nesterov momentum, weight decay and the poly schedule) runs on both
sides from the same JAX variables and the same numpy batch.  The JAX
side is the XLA conv/resample arm (its fused Pallas conv and resample do
not run on this jax; the JAX tests equate the two arms in f32), with the
fused loss and SSIM Pallas kernels in interpret mode, as the JAX package
runs them on the CPU.  Its pieces are the ones the JAX DP step is built
from: ``deep_supervision_loss``, ``build_optimizer`` and
``optax.apply_updates``.  On the port's side every kernel wrapper runs
its plain version.

Tolerances.  The forward quantities (loss components, BatchNorm running
statistics) agree to f32 rounding.  The gradients do not, and cannot: a
conv followed by train-mode BatchNorm gets a gradient that is a sum of
zero-mean terms over every pixel of the batch, so f32 rounding in the
terms is amplified by the cancellation.  JAX's own step moves its
gradients by 1-2 % per leaf (relative L2) when the input image is scaled
by ``1 + 2**-20``; the port is held to 10 % per leaf, and to 4 times
JAX's own movement over the whole gradient.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_sod_project_tpu.configs import get_config as jax_get_config
from distributed_sod_project_tpu.configs.base import (
    OptimConfig as JaxOptimConfig)
from distributed_sod_project_tpu.data.synthetic import (
    SyntheticSOD as JaxSyntheticSOD)
from distributed_sod_project_tpu.losses.deep_supervision import (
    deep_supervision_loss as jax_ds_loss)
from distributed_sod_project_tpu.models.minet import MINet as JaxMINet
from distributed_sod_project_tpu.train.optim import (
    build_optimizer as jax_build_optimizer)
from distributed_sod_project_tpu.train.schedules import (
    build_schedule as jax_build_schedule)
from distributed_sod_project_tpu_torch.configs import (ModelConfig,
                                                       OptimConfig,
                                                       apply_overrides,
                                                       get_config)
from distributed_sod_project_tpu_torch.data import SyntheticSOD
from distributed_sod_project_tpu_torch.models import build_model
from distributed_sod_project_tpu_torch.models.layers import BatchNorm
from distributed_sod_project_tpu_torch.train import (build_schedule,
                                                     create_train_state, fit,
                                                     train_step)
from distributed_sod_project_tpu_torch.train import loop as tloop
from distributed_sod_project_tpu_torch.weights import (flax_path,
                                                       from_jax_variables)

TOTAL_STEPS = 10
SMOKE_SETS = ["model.backbone=vgg16", "data.hflip=false",
              "data.rotate_degrees=0"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Six pytest workers share the machine's cores; one intra-op thread
    each keeps these small CPU steps from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_step():
    """The JAX f32 DP step at one replica, jitted once:
    ``(params, batch_stats, image, mask) -> (metrics, grads, new_params,
    new_batch_stats)``."""
    jm = JaxMINet(backbone="vgg16", backbone_bn=True, conv_impl="xla",
                  resample_impl="fast")
    cfg = jax_get_config("minet_r50_dp")
    tx, schedule = jax_build_optimizer(cfg.optim, TOTAL_STEPS)
    lc = cfg.loss

    def step(params, stats, image, mask):
        def loss_fn(p):
            outs, mut = jm.apply({"params": p, "batch_stats": stats}, image,
                                 train=True, mutable=["batch_stats"])
            total, comps = jax_ds_loss(
                outs, mask, bce_w=lc.bce, iou_w=lc.iou, ssim_w=lc.ssim,
                cel_w=lc.cel, ssim_window=lc.ssim_window, fused=True)
            return total, (comps, mut["batch_stats"])

        grads, (comps, new_stats) = jax.grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        metrics = dict(comps, grad_norm=optax.global_norm(grads),
                       lr=schedule(0))
        return metrics, grads, optax.apply_updates(params, updates), new_stats

    return jm, jax.jit(step)


def _rel_l2(got, want, floor):
    return float(np.linalg.norm((got - want).ravel())
                 / max(np.linalg.norm(want.ravel()), floor))


def _tree_rel_l2(got, want):
    num = sum(float(np.sum((got[k] - want[k]).astype(np.float64) ** 2))
              for k in want)
    den = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("size", [64, 32])  # 32 px: the SIM low branch is 1x1
def test_one_f32_train_step_matches_jax(jax_step, size):
    jm, step = jax_step
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    mask = (rng.random((2, size, size, 1)) > 0.6).astype(np.float32)
    v = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.key(size), jnp.asarray(x)))
    jm_out, jg, jp, js = step(v["params"], v["batch_stats"], jnp.asarray(x),
                              jnp.asarray(mask))
    _, jg_moved, _, _ = step(v["params"], v["batch_stats"],
                             jnp.asarray(x * np.float32(1 + 2.0 ** -20)),
                             jnp.asarray(mask))
    jg, jp, js, jg_moved = _flat(jg), _flat(jp), _flat(js), _flat(jg_moved)
    p0 = _flat(v["params"])

    cfg = apply_overrides(get_config("minet_r50_dp"), SMOKE_SETS)
    model = from_jax_variables(v, build_model(ModelConfig(
        compute_dtype="float32")))
    state = create_train_state(model, cfg.optim, TOTAL_STEPS)
    grads = {}
    # Read as the optimizer receives them (its foreach Nesterov path, the
    # default on CUDA, adds the momentum into .grad in place).
    state.optimizer.register_step_pre_hook(lambda *_: grads.update(
        {flax_path(n, False)[1:]: p.grad.numpy().copy()
         for n, p in model.named_parameters()}))
    metrics = train_step(state, {"image": torch.from_numpy(x),
                                 "mask": torch.from_numpy(mask)}, cfg.loss)

    assert set(metrics) == set(jm_out) == {"bce_iou_cel", "ssim", "total",
                                           "grad_norm", "lr"}
    for k in ("bce_iou_cel", "ssim", "total", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(jm_out[k]),
                                   rtol=1e-5, err_msg=k)
    assert state.step == 1

    params = {flax_path(n, False)[1:]: p.detach().numpy()
              for n, p in model.named_parameters()}
    assert set(grads) == set(jg)
    g_norm = np.sqrt(sum(float(np.sum(g ** 2)) for g in jg.values()))
    jax_moved = _tree_rel_l2(jg_moved, jg)
    assert _tree_rel_l2(grads, jg) <= 4 * max(jax_moved, 1e-4), (
        _tree_rel_l2(grads, jg), jax_moved)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jm_out["grad_norm"]),
                               rtol=4 * max(jax_moved, 1e-4))
    update = {k: jp[k] - p0[k] for k in jp}
    u_norm = np.sqrt(sum(float(np.sum(u ** 2)) for u in update.values()))
    for k in jg:
        name = "/".join(k)
        assert _rel_l2(grads[k], jg[k], 1e-4 * g_norm) <= 0.1, name
        # The update is -lr (g + wd p) plus momentum's first step: held as
        # the gradient is, relative to the JAX update.
        assert _rel_l2(params[k] - p0[k], update[k], 1e-4 * u_norm) <= 0.1, \
            name

    stats = {flax_path(n, True)[1:]: b.numpy()
             for n, b in model.named_buffers()}
    assert set(stats) == set(js)
    for k in js:  # forward statistics: f32 sums in another order
        np.testing.assert_allclose(stats[k], js[k], rtol=0,
                                   atol=2e-4 * np.abs(js[k]).max(),
                                   err_msg="/".join(k))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_batchnorm_matches_flax(dtype):
    """Output, input/scale/bias gradients and the running statistics
    after one update; flax computes the statistics in f32 and rounds
    the normalised output to the compute dtype once, as the port does."""
    rng = np.random.default_rng(7)
    x = (2 * rng.standard_normal((3, 5, 6, 8)) + 0.5).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    mean0 = rng.standard_normal(8).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    jdt = jnp.dtype(dtype)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, dtype=jdt)

    def f(xin, p):
        return bn.apply({"params": p, "batch_stats": {"mean": mean0,
                                                      "var": var0}},
                        xin, mutable=["batch_stats"])

    y, vjp, new = jax.vjp(f, jnp.asarray(x).astype(jdt),
                          {"scale": scale, "bias": bias}, has_aux=True)
    gx, gp = vjp(jnp.asarray(g).astype(jdt))

    tdt = getattr(torch, dtype)
    m = BatchNorm(8, momentum=0.9)
    with torch.no_grad():
        m.scale.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.mean.copy_(torch.from_numpy(mean0))
        m.var.copy_(torch.from_numpy(var0))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ty = m.train_forward(tx)
    ty.backward(torch.from_numpy(g).to(tdt))
    assert ty.dtype == tdt
    # bf16: a one-ulp flip of the single rounding (2^-8 of |y| <= ~4).
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    np.testing.assert_allclose(ty.detach().float().numpy(),
                               np.asarray(y, np.float32), rtol=0, atol=tol)
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(gx, np.float32), rtol=0,
                               atol=tol * 8)
    for k, tg in (("scale", m.scale.grad), ("bias", m.bias.grad)):
        np.testing.assert_allclose(tg.numpy(), np.asarray(gp[k]),
                                   rtol=1e-3 if dtype == "bfloat16" else 1e-5,
                                   atol=1e-3 if dtype == "bfloat16" else 1e-5)
    for k, buf in (("mean", m.mean), ("var", m.var)):
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(new["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_build_model_gives_every_batchnorm_the_configured_momentum():
    model = build_model(ModelConfig(bn_momentum=0.5))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 67 and {m.momentum for m in bns} == {0.5}


_OPTIMS = [dict(),  # the minet_r50_dp recipe: poly, nesterov, wd 5e-4
           dict(schedule="cosine", warmup_steps=1, nesterov=False),
           dict(schedule="constant", momentum=0.0, weight_decay=1e-2),
           dict(schedule="poly", warmup_steps=2, lr=0.1)]


@pytest.mark.parametrize("kw", _OPTIMS)
def test_sgd_trajectory_matches_optax(kw):
    """Three updates of a small parameter tree (a rank-4 kernel, a rank-2
    matrix and a rank-1 bias) under a quadratic loss: params after every
    step and the learning rate read at each step, against
    ``build_optimizer``'s optax chain."""
    rng = np.random.default_rng(3)
    shapes = {"kernel": (3, 3, 2, 4), "dense": (5, 3), "bias": (4,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    coef = {k: rng.uniform(0.5, 2.0, s).astype(np.float32)
            for k, s in shapes.items()}

    def jloss(p):
        return sum(jnp.sum(coef[k] * p[k] ** 2 + p[k]) for k in p)

    tx, jsched = jax_build_optimizer(JaxOptimConfig(**kw), 3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt = tx.init(jp)
    want = []
    for _ in range(3):
        upd, opt = tx.update(jax.grad(jloss)(jp), opt, jp)
        jp = optax.apply_updates(jp, upd)
        want.append({k: np.asarray(v) for k, v in jp.items()})

    mods = torch.nn.Module()
    for k, v in p0.items():
        mods.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v)))
    state = create_train_state(mods, OptimConfig(**kw), 3)
    for i in range(3):
        assert state.schedule(i) == pytest.approx(float(jsched(i)), rel=1e-6)
        state.optimizer.zero_grad()
        sum(torch.sum(torch.from_numpy(coef[k]) * p ** 2 + p)
            for k, p in mods.named_parameters()).backward()
        state.optimizer.step()
        state.scheduler.step()
        for k, p in mods.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[i][k],
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i} {k}")


@pytest.mark.parametrize("kind,warmup", [("poly", 0), ("poly", 3),
                                         ("cosine", 0), ("cosine", 2),
                                         ("constant", 1)])
def test_schedules_match_optax(kind, warmup):
    kw = dict(schedule=kind, warmup_steps=warmup, lr=0.01, poly_power=0.9)
    want = jax_build_schedule(JaxOptimConfig(**kw), 12)
    got = build_schedule(OptimConfig(**kw), 12)
    for step in range(15):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-12), step


def test_sgd_refuses_what_it_does_not_implement():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_train_state(torch.nn.Linear(2, 2),
                           OptimConfig(optimizer="adamw"), 3)
    cfg = get_config("minet_r50_dp")
    for field in ("grad_clip_norm=1.0", "accum_steps=2", "ema_decay=0.99",
                  "skip_nonfinite=3", "layer_decay=0.9", "zero1=true"):
        with pytest.raises(KeyError, match="ROADMAP"):
            apply_overrides(cfg, [f"optim.{field}"])


@pytest.mark.parametrize("hw,seed", [((40, 56), 3), ((32, 32), 0)])
def test_synthetic_samples_equal_jax(hw, seed):
    ours = SyntheticSOD(size=8, image_size=hw, seed=seed)
    theirs = JaxSyntheticSOD(size=8, image_size=hw, seed=seed)
    for i in (0, 5):
        a, b = ours[i], theirs[i]
        assert set(a) == {"image", "mask", "index"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_fit_trains_on_the_cpu_and_routes_every_level_through_the_kernels(
        monkeypatch):
    """Two bf16 steps at 32 px through the public ``fit``: the loss is
    finite, the poly schedule runs down, and both fused losses were
    called on every step."""
    from distributed_sod_project_tpu_torch.losses import (
        deep_supervision as ds)

    calls = {"loss": 0, "ssim": 0}

    def counting(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ds, "fused_bce_iou_cel",
                        counting(ds.fused_bce_iou_cel, "loss"))
    monkeypatch.setattr(ds, "fused_ssim_loss",
                        counting(ds.fused_ssim_loss, "ssim"))
    cfg = apply_overrides(get_config("minet_r50_dp"),
                          SMOKE_SETS + ["data.image_size=32,32",
                                        "log_every_steps=1"])
    cfg = dataclasses.replace(cfg, global_batch_size=2)
    seen = []
    out = fit(cfg, device="cpu", max_steps=2, seed=1,
              on_metrics=lambda s, m: seen.append((s, m)))
    assert [s for s, _ in seen] == [1, 2]
    assert calls == {"loss": 2, "ssim": 2}
    assert np.isfinite(out["total"]) and out["total"] > 0
    assert out["lr"] < seen[0][1]["lr"] == pytest.approx(0.005)


@pytest.mark.parametrize("override", [
    "data.hflip=true", "data.rotate_degrees=10", "model.backbone=resnet50",
    "loss.fused_kernel=false"])
def test_fit_is_loud_on_knobs_it_does_not_implement(override):
    cfg = apply_overrides(get_config("minet_r50_dp"),
                          SMOKE_SETS + [override])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fit(cfg, device="cpu", max_steps=1)


def test_fit_refuses_more_than_one_process(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    cfg = apply_overrides(get_config("minet_r50_dp"), SMOKE_SETS)
    with pytest.raises(NotImplementedError, match="next slice"):
        tloop.check_supported(cfg)


def test_overrides_parse_and_reject_unknown_fields():
    cfg = apply_overrides(get_config("minet_r50_dp"),
                          ["data.image_size=64,48", "optim.lr=0.01",
                           "loss.fused_kernel=false", "steps_per_epoch=none",
                           "global_batch_size=4"])
    assert cfg.data.image_size == (64, 48) and cfg.optim.lr == 0.01
    assert cfg.loss.fused_kernel is False and cfg.steps_per_epoch is None
    assert cfg.global_batch_size == 4
    for unported in ("optim.beta2=0.9", "data.root=/data/DUTS-TR"):
        with pytest.raises(KeyError, match="ROADMAP"):
            apply_overrides(cfg, [unported])
    with pytest.raises(ValueError, match="bool"):
        apply_overrides(cfg, ["data.hflip=maybe"])
