"""Deterministic synthetic SOD dataset: the port's own copy of the JAX
``data/synthetic.py``.

Each sample is a textured background plus 1-3 bright elliptical
"salient objects", and the mask is the union of the ellipses.  A sample
is a pure function of ``(seed, index)``; the numpy draws are made in the
JAX package's order, so both packages give the same pixels for the same
seed and index.  RGB-D samples are not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np


@functools.lru_cache(maxsize=8)
def _grids(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Read-only ``np.mgrid[0:h, 0:w]`` in f32, built once per size."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy.setflags(write=False)
    xx.setflags(write=False)
    return yy, xx


class SyntheticSOD:
    def __init__(
        self,
        size: int = 256,
        image_size: Tuple[int, int] = (320, 320),
        use_depth: bool = False,
        seed: int = 0,
        normalize_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406),
        normalize_std: Tuple[float, float, float] = (0.229, 0.224, 0.225),
    ):
        if use_depth:
            raise NotImplementedError(
                "RGB-D synthetic samples are not ported yet; see ROADMAP.md "
                "Queue 1")
        self.size = size
        self.image_size = tuple(image_size)
        self.seed = seed
        self.mean = np.asarray(normalize_mean, np.float32)
        self.std = np.asarray(normalize_std, np.float32)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        h, w = self.image_size
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(index)]))
        yy, xx = _grids(h, w)
        # Background: a coarse noise grid expanded in 16-px blocks.
        coarse = rng.normal(0.35, 0.12, size=(h // 16 + 1, w // 16 + 1, 3))
        bg = (coarse.repeat(16, axis=0).repeat(16, axis=1)
              [:h, :w, :].astype(np.float32))
        mask = np.zeros((h, w), dtype=np.float32)
        img = bg.copy()
        for _ in range(int(rng.integers(1, 4))):
            cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
            ry, rx = rng.uniform(0.08, 0.25) * h, rng.uniform(0.08, 0.25) * w
            theta = rng.uniform(0, np.pi)
            ct, st = np.cos(theta), np.sin(theta)
            u = (xx - cx) * ct + (yy - cy) * st
            v = -(xx - cx) * st + (yy - cy) * ct
            inside = (u / rx) ** 2 + (v / ry) ** 2 <= 1.0
            mask[inside] = 1.0
            color = rng.uniform(0.6, 1.0, size=3).astype(np.float32)
            img[inside] = 0.25 * img[inside] + 0.75 * color
        img = np.clip(img + rng.normal(0, 0.02, size=img.shape), 0.0, 1.0)
        img = (img - self.mean) / self.std
        return {"image": img.astype(np.float32), "mask": mask[..., None],
                "index": np.int32(index)}
