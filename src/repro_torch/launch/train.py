"""End-to-end training driver — a thin CLI over `repro_torch.engine` (the
port's `repro/launch/train.py`, same flags and printed lines).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \
        --reduced --span 4 --backend gspmd_tree --optimizer momentum \
        --steps 3 --seq 32 --batch 8 --device cpu

Runs on one device (`--device`, default cuda), the `span` Adasum lanes
stacked on it, or one lane per rank under `torch.distributed.run`:

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
        --arch gemma-7b --reduced --steps 2 --seq 32 --batch 8

There `--dist-backend` is nccl on cuda (one card per rank, `cuda:
LOCAL_RANK`) and gloo on the CPU; ranks sharing one card pass `--device
cuda:0 --dist-backend gloo`. Only rank 0 prints. Weights are random,
drawn on the device from a generator seeded with `--seed` (rank 0's are
broadcast).

Fault tolerance, as the reference's CLI: `--ckpt-dir` (periodic atomic
checkpoints every `--ckpt-every` steps, written off-thread;
`--sync-checkpoint` blocks), a SIGTERM save, resume from the latest
checkpoint, prefetched batches (`--no-prefetch` for the serial loop), the
straggler monitor and `--fail-at` failure drills:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch gemma-7b --reduced --steps 4 --seq 32 --batch 8 \
        --ckpt-dir runs/ck --ckpt-every 2 --fail-at 3

dies with NodeLossError at step 3; running it again (without --fail-at)
prints "resumed from step 2" and finishes; once more prints "nothing to
do". Every combiner of the reference trains, on one device and across
ranks (`--combine sum | mean | adascale`, `--backend linear`), with
`--acc-dtype float64` (fp64 dots) and `--combine-delay 1` (the delayed
combine; its pending carry is in the checkpoints).

`--elastic` (needs `--ckpt-dir`) runs `fit_elastic`: on a node loss
(`--fail-at`) or a flagged straggler it checkpoints and restarts at half
the ranks ("[elastic] ... restarting at dp=N/2 ... no hyperparameter
change"), the evicted ranks parked until the run ends; on one process a
loss has nothing to shrink and is raised. `--adaptive-batch` (needs
`--ckpt-dir`) runs `fit_adaptive`: the gradient-noise controller grows
the batch (and, across ranks, the span) through save -> rebuild ->
resume ("[control] resize at step N: ..."). Under torch.distributed.run
every rank exits 0, a parked one too.

`--data-mesh D --model-mesh M` lay the WORLD_SIZE ranks out as a (data,
model) grid (data 0: every rank the model axis does not use): the dense
GQA decoders train tensor-parallel within each model group, and the
data groups combine as above. A grid larger than the ranks falls back
to (WORLD_SIZE, 1), as the reference's mesh does over its devices:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch gemma-7b --reduced \
        --data-mesh 2 --model-mesh 2 --device cpu --steps 2 --seq 32 \
        --batch 8
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

from repro_torch.engine import (EngineConfig, TrainSession, default_callbacks,
                                fit_elastic)
from repro_torch.runtime import make_generator, resolve_device


def main(argv=None):
    # driver-only flags ride in front of the EngineConfig CLI
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (recovery drill)")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain kernel versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generator the random weights come "
                    "from")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="across ranks: nccl (default on cuda) or gloo "
                    "(default on cpu; ranks sharing one card)")
    args, engine_argv = ap.parse_known_args(argv)

    cfg = EngineConfig.from_cli(engine_argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = resolve_device(args.device, local_rank=int(
        os.environ.get("LOCAL_RANK", "0")) if world > 1 else None)
    callbacks = default_callbacks(cfg, fail_at=args.fail_at)
    run = dict(device=device, generator=make_generator(device, args.seed),
               callbacks=callbacks, dist_backend=args.dist_backend)
    lead = int(os.environ.get("RANK", "0")) == 0
    if cfg.adaptive_batch:
        from repro_torch.control import fit_adaptive
        history, session = fit_adaptive(cfg, cfg.steps, **run)
        session.close()
    elif cfg.elastic:
        history, session = fit_elastic(cfg, cfg.steps, **run)
        session.close()
    else:
        session = TrainSession.from_config(cfg, **run)
        if lead:
            rt = session.runtime
            meta = session.run_metadata()
            prefetch = (f"on depth={cfg.prefetch_depth}"
                        f"{' device-stage' if cfg.device_stage else ''}"
                        if cfg.prefetch else "off")
            print(f"[train] {cfg.arch}{' (reduced)' if cfg.reduced else ''}"
                  f" on {device}: span={rt.span} combine={cfg.combine} "
                  f"path={rt.combine_path or 'none'} "
                  f"optimizer={cfg.optimizer} point={rt.dopt.point} "
                  f"stats={'on' if rt.combine_stats else 'off'} "
                  f"world={meta['world']} dist={meta['dist_backend']} "
                  f"mesh={meta['data_mesh']}x{meta['model_mesh']} "
                  f"prefetch={prefetch} ckpt={cfg.ckpt_dir or 'off'}")
        try:
            history = session.fit(cfg.steps)
        finally:
            session.close()
    if lead and history:
        print(f"[train] done: final loss {history[-1]['loss']:.4f}")
    elif lead:
        print(f"[train] nothing to do: run already at step {cfg.steps}")
    res = session.run_metadata()["resilience"]     # the final session's
    if lead and any(res.values()):
        print("[train] resilience " + " ".join(
            f"{k}={len(v) if isinstance(v, list) else v}"
            for k, v in res.items()))
    if args.metrics_out and lead:
        Path(args.metrics_out).write_text(json.dumps(history))
    return history


if __name__ == "__main__":
    main()
