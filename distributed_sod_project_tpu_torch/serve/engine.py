"""The serving engine: warmed forwards + dynamic batching.

Counterpart of a subset of the JAX ``serve/engine.py``:
``submit(image) -> Future`` over one model, requests grouped per
(resolution bucket, precision arm) and zero-padded to the smallest batch
bucket that fits, at most ``max_inflight`` dispatched batches whose
results are not fetched yet, and the resize back to each request's
original size on a host pool.

- **Warm start.**  ``warm()`` runs every (resolution, batch, arm)
  forward once before serving, so no request pays a first launch (the
  counterpart of the JAX engine's AOT compile at start).
- **Precision arms** are cast-on-load views of one f32 model
  (``serve/precision.py:263-280`` of the JAX package): ``f32`` is the
  model itself, ``bf16`` a copy with every floating parameter and
  buffer cast to bfloat16.  Both compute in ``model.compute_dtype``.
  The int8/fp8 arms, TTA, SLO expiry, the degraded ladder, hot reload,
  the HTTP front end and the observability hooks are not ported yet.
"""

from __future__ import annotations

import copy
import threading
import time
from collections import defaultdict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..eval.inference import _resize_pred, make_forward, pad_to_batch
from ..models import build_model
from ..utils.device import resolve_device
from .admission import EngineStopped, QueueFull
from .batcher import DynamicBatcher, Request

ARMS = ("f32", "bf16")
_LATER_ARMS = ("int8", "fp8")


def preprocess_image(image: np.ndarray, res: int, mean, std) -> np.ndarray:
    """An ``(H, W, 3)`` request image -> the forward's input row: PIL
    bilinear resize to ``(res, res)``, scale to [0, 1], normalise.
    uint8 in; float [0, 1] arrays are quantised through uint8 first, so
    every caller sees the same input for the same source image."""
    arr = np.asarray(image)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got shape "
                         f"{arr.shape}")
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    from PIL import Image

    im = Image.fromarray(arr)
    if im.size != (res, res):
        im = im.resize((res, res), Image.BILINEAR)
    x = np.asarray(im, np.float32) / 255.0
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return ((x - mean) / std).astype(np.float32)


def _validate_arms(arms, default: str) -> Tuple[str, ...]:
    for a in arms:
        if a in _LATER_ARMS:
            raise NotImplementedError(
                f"precision arm {a!r} needs the in-kernel dequant of the "
                "int8/fp8 weights, not ported yet (ROADMAP.md Queue 1)")
        if a not in ARMS:
            raise ValueError(f"unknown precision arm {a!r}; known: "
                             f"{list(ARMS) + list(_LATER_ARMS)}")
    if default not in arms:
        raise ValueError(f"serve.precision={default!r} is not among the "
                         f"enabled serve.precision_arms {list(arms)}")
    return tuple(a for a in ARMS if a in arms)


class _Stats:
    """Request and batch accounting behind :meth:`stats_snapshot`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts = {"submitted": 0, "served": 0, "shed": 0, "errors": 0}
        self.batches: Dict[str, int] = defaultdict(int)
        self.device_ms: Dict[str, List[float]] = defaultdict(list)

    def inc(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counts[key] += n

    def batch(self, key: str, dev_ms: float) -> None:
        with self._lock:
            self.batches[key] += 1
            self.device_ms[key].append(dev_ms)

    def snapshot(self) -> Dict:
        with self._lock:
            dev = {k: {"n": len(v), "p50": float(np.median(v)),
                       "max": float(np.max(v))}
                   for k, v in self.device_ms.items()}
            return dict(self.counts, batches=dict(self.batches),
                        device_ms=dev)


class InferenceEngine:
    """Dynamic-batching inference engine over one MINet model.

    ``model`` is the f32 source of truth (an ``nn.Module`` from
    ``models.build_model``); it is moved to ``device`` (``None`` = the
    card; ``"cpu"`` runs the kernels' plain versions)."""

    def __init__(self, cfg, model: torch.nn.Module, *,
                 device: Optional[str] = None, clock=time.monotonic):
        if cfg.data.use_depth:
            raise NotImplementedError(
                "RGB-D requests are not ported yet (ROADMAP.md Queue 1)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._clock = clock
        sc = cfg.serve
        self.precision_arms = _validate_arms(sc.precision_arms, sc.precision)
        self.default_precision = sc.precision
        self.res_buckets = tuple(sorted(
            sc.resolution_buckets or (max(cfg.data.image_size),)))
        self.batch_buckets = tuple(sorted(sc.batch_buckets))
        self._mean = np.asarray(cfg.data.normalize_mean, np.float32)
        self._std = np.asarray(cfg.data.normalize_std, np.float32)
        model = model.eval().to(self.device)
        self.arm_models = {
            arm: model if arm == "f32"
            else copy.deepcopy(model).to(torch.bfloat16)
            for arm in self.precision_arms}
        self._fwds = {arm: make_forward(m)
                      for arm, m in self.arm_models.items()}
        self.batcher = DynamicBatcher(sc.batch_buckets,
                                      sc.max_wait_ms / 1000.0,
                                      max_queue=sc.max_queue, clock=clock)
        self.stats = _Stats()
        self.warmed = set()
        self._inflight = threading.Semaphore(max(sc.max_inflight, 1))
        self._stop = threading.Event()
        self._running = False
        self._dispatch_thread: Optional[threading.Thread] = None
        self._fetch_pool: Optional[ThreadPoolExecutor] = None
        self._post_pool: Optional[ThreadPoolExecutor] = None

    # -- construction --------------------------------------------------

    @classmethod
    def from_random_init(cls, cfg, seed: Optional[int] = None,
                         device: Optional[str] = None) -> "InferenceEngine":
        """An engine over flax-initialised random weights drawn from
        ``seed`` (default ``cfg.seed``)."""
        dev = resolve_device(device)  # raise before building anything
        gen = torch.Generator().manual_seed(cfg.seed if seed is None
                                            else int(seed))
        return cls(cfg, build_model(cfg.model, gen), device=dev)

    @classmethod
    def from_jax_variables(cls, cfg, variables_np: Mapping,
                           device: Optional[str] = None
                           ) -> "InferenceEngine":
        """An engine over the JAX package's ``{"params", "batch_stats"}``
        variables (nested dicts of numpy arrays; ``weights.py``)."""
        from ..weights import from_jax_variables

        dev = resolve_device(device)
        model = from_jax_variables(variables_np, build_model(cfg.model))
        return cls(cfg, model, device=dev)

    # -- lifecycle -----------------------------------------------------

    def warm(self) -> int:
        """Run every (resolution, batch, arm) forward once; returns how
        many were warmed in all."""
        for arm in self.precision_arms:
            for res in self.res_buckets:
                for bb in self.batch_buckets:
                    if (res, bb, arm) in self.warmed:
                        continue
                    x = torch.zeros((bb, res, res, 3), device=self.device)
                    self._fwds[arm](x).cpu()
                    self.warmed.add((res, bb, arm))
        return len(self.warmed)

    def start(self) -> "InferenceEngine":
        if self._running:
            return self
        sc = self.cfg.serve
        self.warm()
        self._stop.clear()
        self._fetch_pool = ThreadPoolExecutor(
            max_workers=max(sc.max_inflight, 1),
            thread_name_prefix="serve-fetch")
        self._post_pool = ThreadPoolExecutor(
            max_workers=max(sc.post_workers, 1),
            thread_name_prefix="serve-post")
        self._running = True
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, name="serve-dispatch", daemon=True)
        self._dispatch_thread.start()
        return self

    def stop(self) -> None:
        if not self._running:
            return
        self._running = False
        self._stop.set()
        for r in self.batcher.close():
            self.stats.inc("errors")
            r.future.set_exception(EngineStopped("engine stopped"))
        self._dispatch_thread.join(timeout=30.0)
        self._fetch_pool.shutdown(wait=True)
        self._post_pool.shutdown(wait=True)

    # -- request plane -------------------------------------------------

    def choose_res_bucket(self, h: int, w: int) -> int:
        side = max(h, w)
        for r in self.res_buckets:
            if side <= r:
                return r
        return self.res_buckets[-1]

    def submit(self, image: np.ndarray,
               precision: Optional[str] = None) -> Future:
        """Enqueue one prediction; the future resolves to ``(pred,
        meta)`` with ``pred`` float32 ``(H, W)`` at the image's original
        size.  Raises :class:`QueueFull` / :class:`EngineStopped` at the
        door and ``ValueError`` for a malformed image or unknown arm."""
        self.stats.inc("submitted")
        if not self._running:
            self.stats.inc("errors")
            raise EngineStopped("engine not running")
        try:
            arm = self.default_precision if precision is None else precision
            if arm not in self.precision_arms:
                raise ValueError(f"unknown precision {arm!r}; enabled arms: "
                                 f"{list(self.precision_arms)}")
            arr = np.asarray(image)
            res = self.choose_res_bucket(arr.shape[0], arr.shape[1])
            tensor = preprocess_image(arr, res, self._mean, self._std)
        except Exception:
            self.stats.inc("errors")
            raise
        req = Request(tensor=tensor,
                      orig_hw=(int(arr.shape[0]), int(arr.shape[1])),
                      res_bucket=res, arrival=self._clock(), precision=arm)
        try:
            self.batcher.put(req)
        except QueueFull:
            self.stats.inc("shed")
            raise
        except RuntimeError as e:  # closed: stop() raced this submit
            self.stats.inc("errors")
            raise EngineStopped(str(e)) from e
        return req.future

    def predict(self, image: np.ndarray, precision: Optional[str] = None,
                timeout: Optional[float] = 60.0):
        """Blocking :meth:`submit`."""
        return self.submit(image, precision=precision).result(timeout)

    # -- dispatch (device) ----------------------------------------------

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            got = self.batcher.get_batch(idle_timeout_s=0.1)
            if got is not None:
                self._dispatch_group(got)

    def _dispatch_group(self, got) -> None:
        (res, arm), reqs = got
        bb = self.batcher.pick_batch_bucket(len(reqs))
        batch = pad_to_batch({"image": np.stack([r.tensor for r in reqs])},
                             bb)["image"]
        while not self._inflight.acquire(timeout=0.25):
            if self._stop.is_set():
                self._fail(reqs, EngineStopped("engine stopped"))
                return
        t0 = self._clock()
        try:
            probs = self._fwds[arm](torch.from_numpy(batch).to(self.device))
        except Exception as e:  # noqa: BLE001 — fails this group only
            self._inflight.release()
            self._fail(reqs, e)
            return
        meta = {"res_bucket": res, "batch_bucket": bb, "precision": arm}
        self._fetch_pool.submit(self._complete, probs, reqs, meta, t0)

    def _complete(self, probs: torch.Tensor, reqs: List[Request],
                  meta: dict, t0: float) -> None:
        try:
            arr = probs.cpu().numpy()[: len(reqs)]  # waits for the device
            dev_ms = (self._clock() - t0) * 1000.0
            self.stats.batch(f"r{meta['res_bucket']}/b{meta['batch_bucket']}"
                             f"/{meta['precision']}", dev_ms)
            for r, row in zip(reqs, arr):
                self._post_pool.submit(self._finish, r, row,
                                       dict(meta, device_ms=dev_ms))
        except Exception as e:  # noqa: BLE001 — fails this group only
            self._fail(reqs, e)
        finally:
            self._inflight.release()

    def _finish(self, r: Request, row: np.ndarray, meta: dict) -> None:
        try:
            pred = _resize_pred(row, r.orig_hw)
        except Exception as e:  # noqa: BLE001 — fails this request only
            self._fail([r], e)
            return
        self.stats.inc("served")
        r.future.set_result((pred, meta))

    def _fail(self, reqs: List[Request], exc: Exception) -> None:
        for r in reqs:
            self.stats.inc("errors")
            if not r.future.done():
                r.future.set_exception(exc)

    def stats_snapshot(self) -> Dict:
        """Counters (submitted, served, shed, errors), dispatched batches
        per ``r<res>/b<batch>/<arm>`` and their device_ms (dispatch to
        fetched result, host clock) as n / p50 / max."""
        out = self.stats.snapshot()
        out["warmed"] = len(self.warmed)
        return out
