"""Train a registered config on synthetic data (the JAX ``train.py``):

    python -m distributed_sod_project_tpu_torch.train --config minet_r50_dp \\
        --device cuda --batch-size 8 --max-steps 20 \\
        --set model.backbone=vgg16 --set data.hflip=false \\
        --set data.rotate_degrees=0

Prints one JSON line of metrics per logged step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys

from ..configs import apply_overrides, get_config
from .loop import fit


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "distributed_sod_project_tpu_torch.train")
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="global batch size (one process: per card)")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--set", action="append", default=[],
                    metavar="SECTION.FIELD=VALUE")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cfg = apply_overrides(get_config(args.config), args.set)
    if args.batch_size is not None:
        cfg = dataclasses.replace(cfg, global_batch_size=args.batch_size)

    def emit(step, metrics):
        print(json.dumps({"step": step, **metrics}), flush=True)

    fit(cfg, device=args.device, max_steps=args.max_steps, seed=args.seed,
        on_metrics=emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
