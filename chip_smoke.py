#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py          # from the repository root; one card

Phases, each fatal on failure (non-zero exit, no final result line):

1. build  - every ``kernels/csrc/*.cu`` of the port is compiled with
   ``nvcc`` for ``sm_90a`` from this checkout (``kernels/_build.py``).
2. kernel - one 320-px, batch-8 MINet-VGG16 forward is recorded to find
   every distinct (shape, mode) signature the serving path hands each
   kernel; at each signature, in bf16 and in f32, the kernel is held
   against its plain PyTorch version on the card and timed beside it,
   beside one library yardstick (cuDNN conv + BN + ReLU;
   ``F.interpolate`` + add / cat) and beside its bound at the H100's
   published peaks.
3. serve  - ``InferenceEngine.from_random_init`` at 320 px, arms f32 and
   bf16, batch buckets 1/4/8, answers requests of mixed original sizes;
   the launch counters, zeroed just before, prove both kernels ran.
   Then ``torch.profiler`` splits one served forward per arm at batch 1
   and 8 into device time by kernel and device idle time.
4. parity - one f32 forward on the card against the same weights' plain
   forward on the CPU.
5. training kernels - one 320-px, batch-8 bf16 training step
   (``minet_r50_dp`` with ``model.backbone=vgg16``) is recorded to find
   every signature it hands the forward convs (mode ``none`` and the
   head's ``bias``), ``conv_dw``, the dx convs, ``upsample2_T``, the loss
   sums and the SSIM forward and backward; each is held against its
   plain version on the card (in bf16 and f32; the loss and SSIM take
   f32 only) and timed beside its bound and a library yardstick (cuDNN
   conv for the forward convs, ``convolution_backward`` wgrad / dgrad,
   ``upsample_bilinear2d_backward``; none exists for the loss sums and
   SSIM).
6. train  - ``fit`` for 3 steps at 320 px, batch 8, bf16, with the
   launch counters zeroed just before: every step launches exactly the
   kernels of the recorded step.  Then the step time (p50 over 8 timed
   steps), images/s and peak memory, and ``torch.profiler`` over one
   step for device time by kernel and the idle share.
7. train parity - one f32 step at 320 px, batch 2, on the card against
   the CPU from the same weights and batch: loss, gradients, parameters
   and BatchNorm statistics.

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke/``.  TF32 is switched off for the plain
versions and yardsticks (cuDNN would otherwise run f32 convs in TF32).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# NVIDIA H100 SXM data sheet, dense: HBM bytes/s and FLOP/s per type.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # f32: CUDA cores
RES, BATCH = 320, 8
# Tolerances of kernel vs plain version, relative to max |plain|:
# f32 - both accumulate in f32, in another order (K <= 4608 terms);
# bf16 - each side rounds the conv output and the epilogue result to
#   bf16 once from f32 sums taken in another order: a rounding may flip,
#   scaled by the BN gain, so a few bf16 ulps (2^-8) of the largest value.
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
PARITY_TOL = 1e-4  # card vs CPU f32 logits, relative to max |CPU logit|
# Backward kernels vs plain, relative to max |plain|: conv_dw - f32 sums of
# up to 819 200 products in another order (its output stays f32 in both
# dtypes); upsample2_T - the same f32 ops in the same order, rounded once
# (bitwise when measured); loss sums and SSIM - f32 sums over up to
# 102 400 pixels per image in another order.
BWD_TOL = {"fused_conv_dw": 1e-4, "fused_resample_upT": 1e-6,
           "fused_loss": 1e-5, "fused_ssim": 1e-5}
TRAIN_SETS = ["model.backbone=vgg16", "data.hflip=false",
              "data.rotate_degrees=0"]
TRAIN_STEPS, TIMED_STEPS = 3, 8
# Launches of one training step: 68 forward convs + 67 dx convs (every conv
# but the first, whose input is the image) through the forward kernel, 68
# conv_dw, 18 resamples and their 18 transposes, one loss and one SSIM
# forward and backward (one level: MINet has one side output).
PER_STEP = {"fused_conv": 135, "fused_conv_dw": 68, "fused_resample": 18,
            "fused_resample_upT": 18, "fused_loss": 1, "fused_ssim": 2}
# Card vs CPU f32 training step.  Forward quantities agree to f32 summation
# order; gradients of convs followed by train-mode BatchNorm are sums of
# zero-mean terms over every pixel, so rounding is amplified by the
# cancellation: each leaf (relative L2) may stray GRAD_TOL of itself, or 4x
# as far as the CPU's own step moves it when the image is scaled by
# 1 + 2**-20, whichever is larger.
GRAD_TOL = 0.1


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def save(name: str, obj) -> None:
    """Write one phase's details under ``chiprun_out/chip_smoke/`` as soon
    as it ends, so a later phase's failure does not lose them."""
    (OUT / f"{name}.json").write_text(json.dumps(obj, indent=1, default=str))


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def randomise_bn(model, gen) -> None:
    """BatchNorm statistics that keep activations O(1) through the
    network (var ~0.5 doubles what each ReLU halves), so outputs carry
    signal for the comparisons; the serving phase keeps flax's init."""
    import torch

    from distributed_sod_project_tpu_torch.models.layers import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.mean.numel()
                m.var.copy_(0.3 + 0.4 * torch.rand(n, generator=gen))
                m.mean.copy_(0.05 * torch.randn(n, generator=gen))
                m.scale.copy_(0.8 + 0.4 * torch.rand(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))


def time_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def capture(model, x):
    """Run one forward with the kernel wrappers recorded: the distinct
    call signatures with their launch count and first arguments."""
    import torch

    from distributed_sod_project_tpu_torch.kernels import fused_conv as fc
    from distributed_sod_project_tpu_torch.kernels import fused_resample as fr

    sigs = {}
    conv, up, merge = fc.fused_conv, fr.fused_upsample2, fr.fused_upsample2_merge

    def note(key, args):
        sigs.setdefault(key, {"count": 0, "args": args})["count"] += 1

    def rec_conv(parts, w, vecs=None, **kw):
        key = ("fused_conv", tuple(tuple(p.shape) for p in parts),
               tuple(w.shape), kw.get("dilation", 1), kw["mode"],
               kw.get("relu", False))
        note(key, ([p.clone() for p in parts], w.clone(),
                   {k: v.clone() for k, v in (vecs or {}).items()}, kw))
        return conv(parts, w, vecs, **kw)

    def rec_up(x):
        note(("fused_resample", tuple(x.shape), None, "up", True),
             (x.clone(), None, "up", True))
        return up(x)

    def rec_merge(x, lateral, mode="add", x_first=True):
        note(("fused_resample", tuple(x.shape), tuple(lateral.shape), mode,
              x_first), (x.clone(), lateral.clone(), mode, x_first))
        return merge(x, lateral, mode=mode, x_first=x_first)

    fc.fused_conv, fr.fused_upsample2 = rec_conv, rec_up
    fr.fused_upsample2_merge = rec_merge
    try:
        with torch.inference_mode():
            model(x)
    finally:
        fc.fused_conv, fr.fused_upsample2 = conv, up
        fr.fused_upsample2_merge = merge
    return sigs


def conv_case(args, dtype):
    """(kernel call, plain call, library call, bytes, flops) of one
    recorded fused_conv signature cast to ``dtype``."""
    import torch
    import torch.nn.functional as F

    from distributed_sod_project_tpu_torch.kernels import fused_conv as fc

    parts, w, vecs, kw = args
    parts = [p.to(dtype).contiguous() for p in parts]
    w = w.to(dtype).contiguous()
    kw = dict(kw)
    kernel = lambda: fc.fused_conv(parts, w, vecs, **kw)  # noqa: E731
    plain = lambda: fc.conv_plain(  # noqa: E731
        parts, w, vecs, dilation=kw.get("dilation", 1), mode=kw["mode"],
        relu=kw.get("relu", False))
    kh, kwd = kw["kernel"]
    d = kw.get("dilation", 1)
    w_lib = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    nchw = [p.permute(0, 3, 1, 2) for p in parts]  # channels-last views
    mode, relu = kw["mode"], kw.get("relu", False)

    def library():
        xin = nchw[0] if len(nchw) == 1 else torch.cat(nchw, dim=1)
        y = F.conv2d(xin, w_lib, padding=(d * (kh // 2), d * (kwd // 2)),
                     dilation=d)
        if mode == "bn":
            y = torch.addcmul((vecs["bias"] - vecs["mean"] * vecs["mul"])
                              .view(1, -1, 1, 1).to(dtype), y,
                              vecs["mul"].view(1, -1, 1, 1).to(dtype))
        elif mode == "bias":
            y = y + vecs["bias"].view(1, -1, 1, 1).to(dtype)
        return torch.relu_(y) if relu else y

    b, h, wd, _ = parts[0].shape
    cout = w.shape[-1]
    el = parts[0].element_size()
    nbytes = (sum(p.numel() for p in parts) + w.numel()
              + b * h * wd * cout) * el + 4 * cout * len(vecs)
    flops = 2.0 * b * h * wd * cout * w.shape[0] * w.shape[1] * w.shape[2]
    return kernel, plain, library, nbytes, flops


def resample_case(args, dtype):
    import torch
    import torch.nn.functional as F

    from distributed_sod_project_tpu_torch.kernels import fused_resample as fr

    x, lat, mode, x_first = args
    x = x.to(dtype).contiguous()
    lat = None if lat is None else lat.to(dtype).contiguous()
    if mode == "up":
        kernel = lambda: fr.fused_upsample2(x)  # noqa: E731
    else:
        kernel = lambda: fr.fused_upsample2_merge(  # noqa: E731
            x, lat, mode=mode, x_first=x_first)
    plain = lambda: fr.resample_plain(x, lat, mode, x_first)  # noqa: E731
    xn = x.permute(0, 3, 1, 2)
    ln = None if lat is None else lat.permute(0, 3, 1, 2)

    def library():
        up = F.interpolate(xn, scale_factor=2, mode="bilinear",
                           align_corners=False)
        if mode == "add":
            return up + ln
        if mode == "concat":
            return torch.cat([up, ln] if x_first else [ln, up], dim=1)
        return up

    b, h, w, c = x.shape
    cl = 0 if lat is None else lat.shape[-1]
    co = c + cl if mode == "concat" else c
    el = x.element_size()
    nbytes = (x.numel() + (0 if lat is None else lat.numel())
              + 4 * b * h * w * co) * el
    # 6 multiplies + 3 adds per upsampled value (+1 for the add merge)
    flops = 4.0 * b * h * w * c * (10 if mode == "add" else 9)
    return kernel, plain, library, nbytes, flops


def kernel_phase(sigs):
    import torch

    rows = []
    for key, e in sigs.items():
        name = key[0]
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            make = conv_case if name == "fused_conv" else resample_case
            kernel, plain, library, nbytes, flops = make(e["args"], dtype)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = max(want.float().abs().max().item(), 1.0)
            ok = err <= TOL[dname] * scale and bool(torch.isfinite(got).all())
            t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / PEAK_FLOPS[
                dname] * 1e3
            rows.append({
                "kernel": name, "sig": repr(key[1:]), "dtype": dname,
                "count": e["count"], "max_abs_err": err, "scale": scale,
                "ms": time_ms(kernel), "plain_ms": time_ms(plain),
                "library_ms": time_ms(library),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            print(f"  {name:14s} {dname:8s} x{e['count']:<2d} {key[1]} "
                  f"{key[2:]} err={err:.3g} ms={rows[-1]['ms']:.4f} "
                  f"plain={rows[-1]['plain_ms']:.4f} "
                  f"lib={rows[-1]['library_ms']:.4f} "
                  f"bound={rows[-1]['bound_ms']:.4f}", flush=True)
            if not ok:
                fail(f"{name} {dname} at {key[1:]} disagrees with its plain "
                     f"version: max |err| {err} > {TOL[dname]} * {scale}")
    return rows


def summarise(rows, name, dtype):
    """One forward's worth: each signature's time times its launches."""
    sel = [r for r in rows if r["kernel"] == name and r["dtype"] == dtype]
    tot = {k: sum(r[k] * r["count"] for r in sel)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by_ops = sum(r["bound_ms"] * r["count"] for r in sel
                 if r["bound_by"] == "operations")
    tot["bound_by"] = "operations" if 2 * by_ops > tot["bound_ms"] \
        else "bytes"
    tot["max_abs_err"] = max(r["max_abs_err"] for r in sel)
    tot["per_forward"] = sum(r["count"] for r in sel)
    return tot


def serve_phase(fc, fr):
    import dataclasses

    import numpy as np

    from distributed_sod_project_tpu_torch.configs import (ServeConfig,
                                                           get_config)
    from distributed_sod_project_tpu_torch.serve import InferenceEngine

    cfg = get_config("minet_vgg16_ref")
    cfg = dataclasses.replace(cfg, serve=ServeConfig(
        batch_buckets=(1, 4, 8), precision_arms=("f32", "bf16"),
        max_wait_ms=200.0))
    rng = np.random.default_rng(0)
    sizes = [(RES, RES), (480, 640), (240, 320), (333, 500), (720, 1280),
             (100, 150), (RES, 200), (512, 512)]
    fc.launches = fr.launches = 0  # the main path starts here
    eng = InferenceEngine.from_random_init(cfg, seed=0).start()
    n = 0
    try:
        for _ in range(3):
            for arm in ("f32", "bf16"):
                for burst in (8, 4, 1):
                    futs = []
                    for i in range(burst):
                        hw = sizes[(n + i) % len(sizes)]
                        img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
                        futs.append((hw, eng.submit(img, precision=arm)))
                    n += burst
                    for hw, fut in futs:
                        pred, meta = fut.result(timeout=300)
                        if pred.shape != hw or not np.isfinite(pred).all() \
                                or pred.min() < 0 or pred.max() > 1:
                            fail(f"bad answer for {hw} ({meta}): shape "
                                 f"{pred.shape} range [{pred.min()}, "
                                 f"{pred.max()}]")
    finally:
        eng.stop()
    launches = {"fused_conv": fc.launches, "fused_resample": fr.launches}
    snap = eng.stats_snapshot()
    forwards = snap["warmed"] + sum(snap["batches"].values())
    print(f"serve: {n} requests, {snap['served']} served, "
          f"{sum(snap['batches'].values())} batches, {snap['warmed']} warm "
          f"forwards; launches {launches}", flush=True)
    for key, dev in sorted(snap["device_ms"].items()):
        print(f"  device_ms {key}: p50 {dev['p50']:.3f} max {dev['max']:.3f} "
              f"n {dev['n']}")
    if snap["served"] != n or snap["errors"]:
        fail(f"serve: {snap['served']}/{n} served, {snap['errors']} errors")
    if launches != {"fused_conv": 68 * forwards,
                    "fused_resample": 18 * forwards}:
        fail(f"serve: launches {launches} are not 68/18 per forward over "
             f"{forwards} forwards")
    return launches, snap, eng


def profile_phase(eng, reps: int = 3):
    """Where one served forward's time goes, per arm at batch 1 and 8:
    host wall time (enqueue to fetched result), device-busy time by
    kernel (``torch.profiler``) and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_sod_project_tpu_torch.eval.inference import make_forward

    out = {}
    for arm, model in eng.arm_models.items():
        for bb in (1, BATCH):
            fwd = make_forward(model)
            x = torch.zeros(bb, RES, RES, 3, device=eng.device)
            fwd(x).cpu()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    fwd(x).cpu()
                wall = (time.perf_counter() - t0) * 1e3 / reps
            dev = {"fused_conv": 0.0, "fused_resample": 0.0, "other": 0.0}
            for e in prof.key_averages():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                key = ("fused_conv" if "conv_bf16_kernel" in e.key
                       or "conv_f32_kernel" in e.key else "fused_resample"
                       if "resample_kernel" in e.key else "other")
                dev[key] += us / 1e3 / reps
            busy = sum(dev.values())
            out[f"b{bb}/{arm}"] = dict(
                wall_ms=wall, busy_ms=busy,
                idle_share=(1 - busy / wall) if busy else None, **dev)
            print(f"profile b{bb}/{arm}: wall {wall:.3f} ms, device busy "
                  f"{busy:.3f} ms (conv {dev['fused_conv']:.3f}, resample "
                  f"{dev['fused_resample']:.3f}, other {dev['other']:.3f})"
                  + ("" if busy else " - the profiler saw no device time"),
                  flush=True)
    return out


def parity_phase(dev):
    import torch

    from distributed_sod_project_tpu_torch.configs import ModelConfig
    from distributed_sod_project_tpu_torch.models import build_model

    gen = torch.Generator().manual_seed(1)
    model = build_model(ModelConfig(compute_dtype="float32"), gen)
    randomise_bn(model, gen)
    x = torch.randn(1, RES, RES, 3, generator=gen)
    with torch.inference_mode():
        want = model(x)[0]
        got = model.to(dev)(x.to(dev))[0].cpu()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"parity: card vs CPU f32 logits max |err| {err:.3g} at scale "
          f"{scale:.3g}", flush=True)
    if not (err <= PARITY_TOL * scale and scale > 1.0):
        fail(f"parity: {err} > {PARITY_TOL} * {scale}")
    return err, scale


def counters():
    """The kernel wrappers' launch counters by kernel name."""
    from distributed_sod_project_tpu_torch.kernels import fused_conv as fc
    from distributed_sod_project_tpu_torch.kernels import fused_loss as fl
    from distributed_sod_project_tpu_torch.kernels import fused_resample as fr
    from distributed_sod_project_tpu_torch.kernels import fused_ssim as fs

    return {"fused_conv": fc.launches, "fused_conv_dw": fc.dw_launches,
            "fused_resample": fr.launches, "fused_resample_upT":
            fr.upT_launches, "fused_loss": fl.launches,
            "fused_ssim": fs.launches + fs.bwd_launches}


def zero_counters() -> None:
    from distributed_sod_project_tpu_torch.kernels import fused_conv as fc
    from distributed_sod_project_tpu_torch.kernels import fused_loss as fl
    from distributed_sod_project_tpu_torch.kernels import fused_resample as fr
    from distributed_sod_project_tpu_torch.kernels import fused_ssim as fs

    fc.launches = fc.dw_launches = fr.launches = fr.upT_launches = 0
    fl.launches = fs.launches = fs.bwd_launches = 0


def train_cfg(batch: int):
    import dataclasses

    from distributed_sod_project_tpu_torch.configs import (apply_overrides,
                                                           get_config)

    cfg = apply_overrides(get_config("minet_r50_dp"), TRAIN_SETS)
    return dataclasses.replace(cfg, global_batch_size=batch,
                               log_every_steps=1)


def train_batch(batch: int, dev, seed: int = 0):
    import numpy as np
    import torch

    from distributed_sod_project_tpu_torch.data import SyntheticSOD

    ds = SyntheticSOD(size=batch, image_size=(RES, RES), seed=seed)
    samples = [ds[i] for i in range(batch)]
    return {k: torch.from_numpy(np.stack([s[k] for s in samples])).to(dev)
            for k in ("image", "mask")}


def capture_train(state, batch, loss_cfg):
    """Run one training step with the kernels' wrappers recorded: the
    distinct signatures with their launch count and first arguments.
    fused_conv calls made during the forward are the training convs (mode
    ``none`` before the train-mode BatchNorm, ``bias`` at the head), those
    made during the backward the dx convs."""
    import torch

    from distributed_sod_project_tpu_torch.kernels import fused_conv as fc
    from distributed_sod_project_tpu_torch.kernels import fused_loss as fl
    from distributed_sod_project_tpu_torch.kernels import fused_resample as fr
    from distributed_sod_project_tpu_torch.kernels import fused_ssim as fs
    from distributed_sod_project_tpu_torch.losses import deep_supervision_loss
    from distributed_sod_project_tpu_torch.train.step import loss_kwargs

    sigs, in_backward = {}, [False]
    real = {(fc, "fused_conv"): fc.fused_conv, (fc, "conv_dw"): fc.conv_dw,
            (fr, "upsample2_T"): fr.upsample2_T,
            (fl, "pixel_region_sums"): fl.pixel_region_sums,
            (fs, "ssim_sums"): fs.ssim_sums, (fs, "ssim_grads"): fs.ssim_grads}

    def note(key, make_args):
        if key not in sigs:
            sigs[key] = {"count": 0, "args": make_args()}
        sigs[key]["count"] += 1

    def clone(ts):
        return [t.detach().clone() for t in ts]

    def rec_conv(parts, w, vecs=None, **kw):
        shapes = (tuple(tuple(p.shape) for p in parts), tuple(w.shape),
                  kw.get("dilation", 1))
        if in_backward[0]:
            note(("fused_conv_dx", *shapes),
                 lambda: (clone(parts), w.detach().clone(), kw))
        else:
            note(("fused_conv_fwd_train", *shapes, kw["mode"],
                  kw.get("relu", False)),
                 lambda: (clone(parts), w.detach().clone(),
                          {k: v.detach().clone()
                           for k, v in (vecs or {}).items()}, kw))
        return real[(fc, "fused_conv")](parts, w, vecs, **kw)

    def rec_dw(parts, g, *, kernel, dilation=1):
        note(("fused_conv_dw", tuple(tuple(p.shape) for p in parts),
              tuple(g.shape), dilation),
             lambda: (clone(parts), g.detach().clone(), kernel, dilation))
        return real[(fc, "conv_dw")](parts, g, kernel=kernel,
                                     dilation=dilation)

    def rec_upT(g, c_off=0, c=None):
        note(("fused_resample_upT", tuple(g.shape), c_off, c),
             lambda: (g.detach().clone(), c_off, c))
        return real[(fr, "upsample2_T")](g, c_off, c)

    def rec_sums(x, t):
        note(("fused_loss", tuple(x.shape)), lambda: tuple(clone((x, t))))
        return real[(fl, "pixel_region_sums")](x, t)

    def rec_ssim(a, b, window=11, sigma=1.5):
        note(("fused_ssim", tuple(a.shape), "forward"),
             lambda: (*clone((a, b)), None))
        return real[(fs, "ssim_sums")](a, b, window, sigma)

    def rec_ssim_bwd(a, b, window=11, sigma=1.5, need_b=False):
        note(("fused_ssim", tuple(a.shape), "backward"),
             lambda: (*clone((a, b)), need_b))
        return real[(fs, "ssim_grads")](a, b, window, sigma, need_b)

    recs = {(fc, "fused_conv"): rec_conv, (fc, "conv_dw"): rec_dw,
            (fr, "upsample2_T"): rec_upT, (fl, "pixel_region_sums"): rec_sums,
            (fs, "ssim_sums"): rec_ssim, (fs, "ssim_grads"): rec_ssim_bwd}
    for (mod, name), fn in recs.items():
        setattr(mod, name, fn)
    try:
        outs = state.model(batch["image"], train=True)
        total, _ = deep_supervision_loss(outs, batch["mask"],
                                         **loss_kwargs(loss_cfg))
        in_backward[0] = True
        total.backward()
        torch.cuda.synchronize()
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)
    return sigs


def bwd_case(key, args, dtype):
    """(kernel call, plain call, library call or None, bytes, flops) of one
    recorded backward signature cast to ``dtype``."""
    import torch

    from distributed_sod_project_tpu_torch.kernels import fused_conv as fc
    from distributed_sod_project_tpu_torch.kernels import fused_loss as fl
    from distributed_sod_project_tpu_torch.kernels import fused_resample as fr
    from distributed_sod_project_tpu_torch.kernels import fused_ssim as fs

    conv_bwd = torch.ops.aten.convolution_backward.default
    name = key[0]
    if name == "fused_conv_fwd_train":
        return conv_case(args, dtype)
    if name == "fused_conv_dx":
        (dz,), w, kw = args
        dz, w = dz.to(dtype).contiguous(), w.to(dtype).contiguous()
        kh, kwd = kw["kernel"]
        d = kw.get("dilation", 1)
        # The layer's own weight, OIHW, and its input's shape for dgrad.
        w_oihw = w.flip(0, 1).permute(2, 3, 0, 1).contiguous()
        dz_n = dz.permute(0, 3, 1, 2)
        x_n = torch.empty((dz.shape[0], w.shape[-1], *dz.shape[1:3]),
                          device=dz.device, dtype=dtype,
                          memory_format=torch.channels_last)
        pad = [d * (kh // 2), d * (kwd // 2)]
        b, h, wd, cin = dz.shape
        return (lambda: fc.fused_conv([dz], w, kernel=(kh, kwd), dilation=d),
                lambda: fc.conv_plain([dz], w, {}, dilation=d, mode="none",
                                      relu=False),
                lambda: conv_bwd(dz_n, x_n, w_oihw, None, [1, 1], pad,
                                 [d, d], False, [0, 0], 1,
                                 [True, False, False])[0],
                (dz.numel() + w.numel() + b * h * wd * w.shape[-1])
                * dz.element_size(),
                2.0 * b * h * wd * kh * kwd * cin * w.shape[-1])
    if name == "fused_conv_dw":
        parts, g, kernel, d = args
        parts = [p.to(dtype).contiguous() for p in parts]
        g = g.to(dtype).contiguous()
        kh, kwd = kernel
        cin, cout = sum(p.shape[-1] for p in parts), g.shape[-1]
        nchw = [p.permute(0, 3, 1, 2) for p in parts]
        w_like = torch.empty((cout, cin, kh, kwd), device=g.device,
                             dtype=dtype)
        pad = [d * (kh // 2), d * (kwd // 2)]

        def library():
            x = nchw[0] if len(nchw) == 1 else torch.cat(nchw, dim=1)
            return conv_bwd(g.permute(0, 3, 1, 2), x, w_like, None, [1, 1],
                            pad, [d, d], False, [0, 0], 1,
                            [False, True, False])[1]

        b, h, wd, _ = g.shape
        return (lambda: fc.conv_dw(parts, g, kernel=kernel, dilation=d),
                lambda: fc.conv_dw_plain(parts, g, kernel=kernel,
                                         dilation=d),
                library,
                (sum(p.numel() for p in parts) + g.numel())
                * g.element_size() + 4 * kh * kwd * cin * cout,
                2.0 * b * h * wd * kh * kwd * cin * cout)
    if name == "fused_resample_upT":
        g, c_off, c = args
        g = g.to(dtype).contiguous()
        c = g.shape[-1] - c_off if c is None else c
        b, hh, ww, _ = g.shape
        slab = g.permute(0, 3, 1, 2)[:, c_off:c_off + c]
        up_bwd = torch.ops.aten.upsample_bilinear2d_backward.default
        return (lambda: fr.upsample2_T(g, c_off, c),
                lambda: fr.upsample2_T_plain(g[..., c_off:c_off + c]),
                lambda: up_bwd(slab, [hh, ww], [b, c, hh // 2, ww // 2],
                               False),
                (b * hh * ww * c + b * hh * ww * c // 4) * g.element_size(),
                25.0 * b * hh * ww * c / 4)
    if name == "fused_loss":
        x, t = args
        b, n = x.shape[0], x[0].numel()
        return (lambda: torch.stack(fl.pixel_region_sums(x, t)),
                lambda: torch.stack(fl.pixel_region_sums_plain(
                    x.reshape(b, n).float(), t.reshape(b, n).float())),
                None, 2 * x.numel() * 4 + 16 * b, 15.0 * x.numel())
    a, bm, need_b = args  # fused_ssim
    taps = fs.ssim_taps(11, 1.5)
    if key[2] == "forward":
        return (lambda: fs.ssim_sums(a, bm),
                lambda: fs.ssim_sums_plain(a, bm, taps), None,
                2 * a.numel() * 4 + 4 * a.shape[0], 245.0 * a.numel())

    def both(ga_gb):
        return torch.stack([g for g in ga_gb if g is not None])

    return (lambda: both(fs.ssim_grads(a, bm, need_b=need_b)),
            lambda: both(fs.ssim_grads_plain(a, bm, taps, need_b)), None,
            (3 + bool(need_b)) * a.numel() * 4, 420.0 * a.numel())


def bwd_kernel_phase(sigs):
    import torch

    rows = []
    for key, e in sigs.items():
        name = key[0]
        kname = "fused_conv" if name.startswith("fused_conv_") \
            and name != "fused_conv_dw" else name
        f32_only = name in ("fused_loss", "fused_ssim")
        for dtype in ((torch.float32,) if f32_only
                      else (torch.bfloat16, torch.float32)):
            dname = str(dtype).split(".")[1]
            kernel, plain, library, nbytes, flops = bwd_case(
                key, e["args"], dtype)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = max(want.float().abs().max().item(), 1e-30)
            tol = TOL[dname] if kname == "fused_conv" else BWD_TOL[name]
            ok = err <= tol * scale and bool(torch.isfinite(got).all())
            t_bytes = nbytes / HBM_BPS * 1e3
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            rows.append({
                "kernel": kname, "part": name, "sig": repr(key[1:]),
                "dtype": dname, "count": e["count"], "max_abs_err": err,
                "scale": scale, "ms": time_ms(kernel),
                "plain_ms": time_ms(plain),
                "library_ms": None if library is None else time_ms(library),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            r = rows[-1]
            lib = "none" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f}"
            print(f"  {name:18s} {dname:8s} x{e['count']:<2d} {key[1:]} "
                  f"err={err:.3g}/{scale:.3g} ms={r['ms']:.4f} "
                  f"plain={r['plain_ms']:.4f} lib={lib} "
                  f"bound={r['bound_ms']:.4f}", flush=True)
            if not ok:
                fail(f"{name} {dname} at {key[1:]} disagrees with its plain "
                     f"version: max |err| {err} > {tol} * {scale}")
    return rows


def step_sums(rows, part, dtype):
    """One training step's worth of a kernel part: each signature's time
    times its launches."""
    sel = [r for r in rows if r["part"] == part and r["dtype"] == dtype]
    tot = {k: sum(r[k] * r["count"] for r in sel)
           for k in ("ms", "plain_ms", "bound_ms")}
    libs = [r["library_ms"] for r in sel]
    tot["library_ms"] = None if None in libs else sum(
        lib * r["count"] for lib, r in zip(libs, sel))
    by_ops = sum(r["bound_ms"] * r["count"] for r in sel
                 if r["bound_by"] == "operations")
    tot["bound_by"] = "operations" if 2 * by_ops > tot["bound_ms"] \
        else "bytes"
    tot["max_abs_err"] = max(r["max_abs_err"] for r in sel)
    tot["per_step"] = sum(r["count"] for r in sel)
    return tot


def classify(kernel_name: str) -> str:
    """Profiler kernel name -> the port's kernel it belongs to."""
    for needle, name in (("dw_", "fused_conv_dw"), ("upT_kernel",
                         "fused_resample_upT"), ("conv_bf16_kernel",
                         "fused_conv"), ("conv_f32_kernel", "fused_conv"),
                         ("resample_kernel", "fused_resample"),
                         ("sums_", "fused_loss"), ("ssim_", "fused_ssim")):
        if needle in kernel_name:
            return name
    return "other"


def train_phase(dev):
    """``fit`` at 320 px, batch 8, bf16 with exact launch counts; then
    step time, images/s, peak memory and a profiled step."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_sod_project_tpu_torch.models import build_model
    from distributed_sod_project_tpu_torch.train import (create_train_state,
                                                         fit, train_step)

    cfg = train_cfg(BATCH)
    seen = []
    zero_counters()  # the training path starts here
    t0 = time.perf_counter()
    fit(cfg, device=dev, max_steps=TRAIN_STEPS, seed=0,
        on_metrics=lambda s, m: seen.append((s, m)))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = counters()
    want = {k: v * TRAIN_STEPS for k, v in PER_STEP.items()}
    print(f"train: fit {TRAIN_STEPS} steps in {fit_s:.2f} s; launches "
          f"{launches}", flush=True)
    for s, m in seen:
        print(f"  step {s}: " + " ".join(f"{k}={v:.5g}" for k, v in
                                         m.items()), flush=True)
    if [s for s, _ in seen] != list(range(1, TRAIN_STEPS + 1)) or not all(
            math.isfinite(v) for _, m in seen for v in m.values()):
        fail(f"train: bad metrics {seen}")
    if launches != want:
        fail(f"train: launches {launches} != {want} ({PER_STEP} a step)")

    # Step time on one resident batch (the host's synthetic data left out).
    model = build_model(cfg.model, torch.Generator().manual_seed(0)).to(dev)
    state = create_train_state(model, cfg.optim, 100)
    batch = train_batch(BATCH, dev)
    for _ in range(2):
        train_step(state, batch, cfg.loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        train_step(state, batch, cfg.loss)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    times.sort()
    p50 = times[len(times) // 2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch, cfg.loss)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_ms = {k: 0.0 for k in PER_STEP}
    dev_ms["other"] = 0.0
    other, n_kernels = [], 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kind = classify(e.key)
        dev_ms[kind] += us / 1e3
        n_kernels += e.count
        if kind == "other":
            other.append((us / 1e3, e.count, e.key[:120]))
    busy = sum(dev_ms.values())
    other.sort(reverse=True)
    out = {"fit_seconds": fit_s, "metrics": seen, "launches": launches,
           "step_ms": times, "step_ms_p50": p50,
           "images_per_s": BATCH / p50 * 1e3, "peak_bytes": peak,
           "profiled_wall_ms": wall, "device_busy_ms": busy,
           # Against the un-profiled step: the profiler's own host cost
           # stretches the profiled step's wall time.
           "idle_share": (1 - busy / p50) if busy else None,
           "device_ms": dev_ms, "device_kernels": n_kernels,
           "other_top": other[:15]}
    print(f"train: step p50 {p50:.2f} ms (min {times[0]:.2f}, max "
          f"{times[-1]:.2f}), {out['images_per_s']:.1f} images/s, peak "
          f"{peak / 2**30:.2f} GiB; profiled step wall {wall:.2f} ms, "
          f"device busy {busy:.2f} ms in {n_kernels} kernels, idle share "
          f"{out['idle_share']} ("
          + ", ".join(f"{k} {v:.2f}" for k, v in dev_ms.items()) + ")"
          + ("" if busy else " - the profiler saw no device time"),
          flush=True)
    return out


def _norm(t) -> float:
    return float(t.double().norm())


def train_parity_phase(dev):
    """One f32 step at 320 px, batch 2: the card against the CPU, with the
    CPU's own movement under a 1 + 2**-20 image scale as the noise scale
    of the gradients."""
    import copy

    import torch

    from distributed_sod_project_tpu_torch.configs import ModelConfig
    from distributed_sod_project_tpu_torch.models import build_model
    from distributed_sod_project_tpu_torch.train import (create_train_state,
                                                         train_step)

    cfg = train_cfg(2)
    base = build_model(ModelConfig(compute_dtype="float32"),
                       torch.Generator().manual_seed(3))
    batch = train_batch(2, "cpu", seed=3)
    moved = dict(batch, image=batch["image"] * (1 + 2.0 ** -20))
    runs = {}
    for tag, d, b in (("card", dev, batch), ("cpu", "cpu", batch),
                      ("cpu_moved", "cpu", moved)):
        model = copy.deepcopy(base).to(d)
        state = create_train_state(model, cfg.optim, 10)
        grads = {}

        def snapshot(opt, args, kwargs, model=model, grads=grads):
            # The gradients as the optimizer receives them: its foreach
            # Nesterov path adds the momentum into .grad in place.
            grads.update({n: p.grad.detach().cpu().clone()
                          for n, p in model.named_parameters()})

        state.optimizer.register_step_pre_hook(snapshot)
        t0 = time.perf_counter()
        m = train_step(state, {k: v.to(d) for k, v in b.items()}, cfg.loss)
        runs[tag] = {
            "metrics": {k: float(v) for k, v in m.items()},
            "grads": grads,
            "update": {n: p.detach().cpu() - q.detach() for (n, p), q in
                       zip(model.named_parameters(), base.parameters())},
            "stats": {n: t.detach().cpu() for n, t in model.named_buffers()},
            "seconds": time.perf_counter() - t0}
    card, cpu, mv = runs["card"], runs["cpu"], runs["cpu_moved"]
    # Forward quantities: f32 sums in another order.
    metric_err = {k: abs(card["metrics"][k] - v) / abs(v)
                  for k, v in cpu["metrics"].items() if k != "grad_norm"}
    stats_err = max(_norm(card["stats"][k] - v) / max(_norm(v), 1e-30)
                    for k, v in cpu["stats"].items())
    # Gradient-like quantities, leaf by leaf: the error may reach GRAD_TOL
    # of the leaf, or 4x the CPU's own movement, whichever is larger.
    leaves = []
    for part in ("grads", "update"):
        total = sum(_norm(v) ** 2 for v in cpu[part].values()) ** 0.5
        for k, v in cpu[part].items():
            err = _norm(card[part][k] - v)
            noise = _norm(mv[part][k] - v)
            allowed = max(GRAD_TOL * _norm(v), 4 * noise, 1e-4 * total)
            leaves.append((err / allowed, part, k, err / max(_norm(v), 1e-30),
                           noise / max(_norm(v), 1e-30)))
    leaves.sort(reverse=True)
    gn = abs(card["metrics"]["grad_norm"] - cpu["metrics"]["grad_norm"]) / \
        cpu["metrics"]["grad_norm"]
    gn_noise = abs(mv["metrics"]["grad_norm"] - cpu["metrics"]["grad_norm"]) \
        / cpu["metrics"]["grad_norm"]
    out = {"metric_rel_err": metric_err, "stats_rel_err": stats_err,
           "grad_norm_rel_err": gn, "grad_norm_cpu_moved": gn_noise,
           "worst_leaves": [
               {"ratio_to_allowed": r, "part": part, "leaf": k,
                "rel_err": e, "cpu_moved_rel": n}
               for r, part, k, e, n in leaves[:6]],
           "cpu_step_s": cpu["seconds"], "card": card["metrics"],
           "cpu": cpu["metrics"]}
    print(f"train parity (f32, {RES} px, batch 2): loss terms "
          f"{ {k: f'{v:.2e}' for k, v in metric_err.items()} }, stats "
          f"{stats_err:.2e}, grad_norm {gn:.2e} (CPU moved {gn_noise:.2e}); "
          f"CPU step {cpu['seconds']:.1f} s", flush=True)
    for w in out["worst_leaves"]:
        print(f"  {w['part']:6s} {w['leaf']:36s} rel err {w['rel_err']:.3g} "
              f"(CPU moved {w['cpu_moved_rel']:.3g}) = "
              f"{w['ratio_to_allowed']:.3g} of allowed", flush=True)
    ok = (max(metric_err.values()) <= 1e-4 and stats_err <= 2e-4
          and gn <= max(GRAD_TOL, 4 * gn_noise)
          and leaves[0][0] <= 1.0)
    if not ok:
        fail(f"train parity: {out}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from distributed_sod_project_tpu_torch.kernels import _build
    from distributed_sod_project_tpu_torch.kernels import fused_conv as fc
    from distributed_sod_project_tpu_torch.kernels import fused_resample as fr

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.time()
    smi = smi_line()
    print(f"{smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)

    # 1. build
    t0 = time.time()
    _build.load("fused_conv")
    for name, info in sorted(_build.build_info.items()):
        (OUT / f"nvcc_{name}.log").write_text(str(info["log"]))
        print(f"build: {name}.cu -> sm_90a in {info['seconds']:.1f} s",
              flush=True)
    print(f"build: {time.time() - t0:.1f} s ({_build.NVCC_FLAGS})",
          flush=True)

    # 2. kernels at every signature of one 320-px batch-8 forward
    from distributed_sod_project_tpu_torch.configs import get_config
    from distributed_sod_project_tpu_torch.models import build_model

    gen = torch.Generator().manual_seed(0)
    model = build_model(get_config("minet_vgg16_ref").model, gen)
    randomise_bn(model, gen)
    model = model.to(dev)
    x = torch.randn(BATCH, RES, RES, 3, generator=gen).to(dev)
    sigs = capture(model, x)
    per_fwd = {k: sum(e["count"] for s, e in sigs.items() if s[0] == k)
               for k in ("fused_conv", "fused_resample")}
    print(f"kernel: one forward launches {per_fwd} over {len(sigs)} "
          f"signatures", flush=True)
    if per_fwd != {"fused_conv": 68, "fused_resample": 18}:
        fail(f"unexpected launches per forward {per_fwd}")
    rows = kernel_phase(sigs)
    save("kernel_rows", rows)
    del sigs, model, x
    torch.cuda.empty_cache()

    # 3. serve, then where a served forward's time goes
    launches, snap, eng = serve_phase(fc, fr)
    prof = profile_phase(eng)
    del eng

    # 4. parity
    err, scale = parity_phase(dev)
    serve_launches = dict(launches)

    # 5. training kernels at every signature of one 320-px batch-8 step
    from distributed_sod_project_tpu_torch.train import create_train_state

    cfg = train_cfg(BATCH)
    model = build_model(cfg.model, torch.Generator().manual_seed(0)).to(dev)
    state = create_train_state(model, cfg.optim, 100)
    bsigs = capture_train(state, train_batch(BATCH, dev), cfg.loss)
    per_step = {}
    for key, e in bsigs.items():
        per_step[key[0]] = per_step.get(key[0], 0) + e["count"]
    print(f"training kernels: one step launches {per_step} over "
          f"{len(bsigs)} signatures", flush=True)
    want_bwd = {"fused_conv_fwd_train": 68, "fused_conv_dx": 67,
                "fused_conv_dw": 68, "fused_resample_upT": 18,
                "fused_loss": 1, "fused_ssim": 2}
    if per_step != want_bwd:
        fail(f"unexpected backward launches per step {per_step}")
    brows = bwd_kernel_phase(bsigs)
    save("backward_rows", brows)
    del bsigs, model, state
    torch.cuda.empty_cache()

    # 6. train, 7. train parity
    train = train_phase(dev)
    save("train", train)
    tpar = train_parity_phase(dev)

    def path_launches(name):
        return {"serve": serve_launches.get(name, 0),
                "train": train["launches"][name]}

    src = "distributed_sod_project_tpu_torch/kernels/csrc/"
    ref = "distributed_sod_project_tpu/pallas/"
    kernels = []
    for name, file, rep in (
            ("fused_conv", "fused_conv.cu", "fused_conv.py:192"),
            ("fused_resample", "fused_resample.cu", "fused_resample.py:131")):
        b16 = summarise(rows, name, "bfloat16")
        f32 = summarise(rows, name, "float32")
        by_path = path_launches(name)
        entry = {
            "name": name, "route": "cuda", "source": src + file,
            "replaces": ref + rep, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(b16["max_abs_err"], f32["max_abs_err"]),
            "ms": b16["ms"], "plain_ms": b16["plain_ms"],
            "bound_ms": b16["bound_ms"], "bound_by": b16["bound_by"],
            "library_ms": b16["library_ms"],
            "per_forward": b16["per_forward"],
            "timed": f"one {RES}px batch-{BATCH} serving forward, bfloat16",
            "f32": {k: f32[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "library_ms", "max_abs_err")}}
        if name == "fused_conv":
            for part, sub in (("fused_conv_fwd_train", "train_forward"),
                              ("fused_conv_dx", "dx")):
                b = step_sums(brows, part, "bfloat16")
                f = step_sums(brows, part, "float32")
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           b["max_abs_err"], f["max_abs_err"])
                entry[sub] = dict(b, timed=f"one {RES}px batch-{BATCH} "
                                  "training step, bfloat16",
                                  f32={k: f[k] for k in ("ms", "plain_ms",
                                                         "bound_ms",
                                                         "library_ms")})
        kernels.append(entry)
    for name, file, rep, dtype in (
            ("fused_conv_dw", "fused_conv_dw.cu", "fused_conv.py:235",
             "bfloat16"),
            ("fused_resample_upT", "fused_resample_upT.cu",
             "fused_resample.py:179", "bfloat16"),
            ("fused_loss", "fused_loss.cu", "fused_loss.py:31", "float32"),
            ("fused_ssim", "fused_ssim.cu", "fused_ssim.py:89", "float32")):
        st = step_sums(brows, name, dtype)
        entry = {
            "name": name, "route": "cuda", "source": src + file,
            "replaces": ref + rep, "launches": train["launches"][name],
            "launches_by_path": path_launches(name),
            "max_abs_err": max(r["max_abs_err"] for r in brows
                               if r["part"] == name),
            "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "library_ms": st["library_ms"], "per_step": st["per_step"],
            "timed": f"one {RES}px batch-{BATCH} training step, {dtype}"}
        if st["library_ms"] is None:
            entry["library"] = "none: no single PyTorch call computes it"
        if dtype == "bfloat16":
            f32 = step_sums(brows, name, "float32")
            entry["f32"] = {k: f32[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "library_ms")}
        kernels.append(entry)
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "kernels": kernels, "signatures": rows,
              "backward_signatures": brows, "serve": snap,
              "profile": prof,
              "parity": {"max_abs_err": err, "scale": scale},
              "train": train, "train_parity": tpar,
              "seconds": time.time() - t_start}
    (OUT / "report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
