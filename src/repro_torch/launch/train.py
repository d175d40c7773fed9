"""End-to-end training driver — a thin CLI over `repro_torch.engine` (the
port's `repro/launch/train.py`, same flags and printed lines).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \
        --reduced --span 4 --backend gspmd_tree --optimizer momentum \
        --steps 3 --seq 32 --batch 8 --device cpu

Runs on one device (`--device`, default cuda), the `span` Adasum lanes
stacked on it. Weights are random, drawn on the device from a generator
seeded with `--seed`. Flags of later slices (`--ckpt-dir`,
`--ckpt-every`, `--elastic`, `--fail-at`, `--adaptive-batch`,
`--combine-delay 1`, `--compress int8`, meshes above one device) raise
NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.engine import EngineConfig, TrainSession, default_callbacks
from repro_torch.runtime import (ITEM_ENGINE, make_generator, not_ported,
                                 resolve_device)


def main(argv=None):
    # driver-only flags ride in front of the EngineConfig CLI
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--fail-at", type=int, nargs="*", default=None,
                    help="inject failures at these steps (a later slice)")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain kernel versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generator the random weights come "
                    "from")
    args, engine_argv = ap.parse_known_args(argv)
    if args.fail_at is not None:
        raise not_ported("failure-injection drills (--fail-at)", ITEM_ENGINE)

    cfg = EngineConfig.from_cli(engine_argv)
    device = resolve_device(args.device)
    session = TrainSession.from_config(
        cfg, device=device, generator=make_generator(device, args.seed),
        callbacks=default_callbacks(cfg))
    rt = session.runtime
    print(f"[train] {cfg.arch}{' (reduced)' if cfg.reduced else ''} on "
          f"{device}: span={rt.span} combine={cfg.combine} "
          f"path={rt.combine_path or 'none'} optimizer={cfg.optimizer} "
          f"point={rt.dopt.point} stats={'on' if rt.combine_stats else 'off'}"
          f" prefetch=off (serial loop)")
    history = session.fit(cfg.steps)
    session.close()
    if history:
        print(f"[train] done: final loss {history[-1]['loss']:.4f}")
    else:
        print(f"[train] nothing to do: run already at step {cfg.steps}")
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(history))
    return history


if __name__ == "__main__":
    main()
