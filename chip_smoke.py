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


def fail(msg: str) -> None:
    raise RuntimeError(msg)


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
    del sigs, model, x
    torch.cuda.empty_cache()

    # 3. serve, then where a served forward's time goes
    launches, snap, eng = serve_phase(fc, fr)
    prof = profile_phase(eng)
    del eng

    # 4. parity
    err, scale = parity_phase(dev)

    sources = {"fused_conv": ("distributed_sod_project_tpu_torch/kernels/"
                              "csrc/fused_conv.cu",
                              "distributed_sod_project_tpu/pallas/"
                              "fused_conv.py:192"),
               "fused_resample": ("distributed_sod_project_tpu_torch/"
                                  "kernels/csrc/fused_resample.cu",
                                  "distributed_sod_project_tpu/pallas/"
                                  "fused_resample.py:131")}
    kernels = []
    for name, (src, rep) in sources.items():
        b16 = summarise(rows, name, "bfloat16")
        f32 = summarise(rows, name, "float32")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
            "max_abs_err": max(b16["max_abs_err"], f32["max_abs_err"]),
            "ms": b16["ms"], "plain_ms": b16["plain_ms"],
            "bound_ms": b16["bound_ms"], "bound_by": b16["bound_by"],
            "library_ms": b16["library_ms"],
            "per_forward": b16["per_forward"],
            "timed": f"one {RES}px batch-{BATCH} forward, bfloat16",
            "f32": {k: f32[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "library_ms", "max_abs_err")}})
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "kernels": kernels, "signatures": rows, "serve": snap,
              "profile": prof,
              "parity": {"max_abs_err": err, "scale": scale},
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
