"""Request-level serving driver — a thin CLI over `ServeEngine` (the
port's `repro/launch/serve.py`, same flags and printed lines).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \
        --reduced --requests 3 --prompt-len 32 --gen 16 --max-slots 2 \
        --stagger 2 --device cpu

Submits `--requests` synthetic prompts (lengths jittered around
--prompt-len, arrivals staggered by --stagger decode ticks), drives the
continuous-batching engine to completion, and prints the throughput
fields (`completed=`, `tok_s=`, ...). Weights are random, drawn on
`--device` (default cuda) from a generator seeded with `--seed`; with
`--ckpt-dir` the engine serves the params of the latest checkpoint there
(a train run's) and prints "[serve] serving checkpoint step N from DIR";
`--hot-reload` also polls the directory every tick, so a checkpoint that
lands mid-stream serves the requests admitted after it.

Serving options, as in the reference: `--kv-layout dense` (per-slot
rows instead of the page arena), `--kv-pages N` below full provisioning
(backpressure and recompute preemption), `--prefill-mode scan` (stepped
prefill), `--speculation-k K` with `--draft-preset ARCH` (default: the
target at quarter depth; random draft weights, so acceptance is ~0 and
the tokens are plain decode's), `--deadline-s`, `--max-retries` and
`--pressure-ladder` (a `[serve] resilience ...` line counts kills,
retries, drains and the ladder's levels), and `--legacy`, the old
`ServeSession.generate` stepped loop on the same prompts. Frontend and
encoder-decoder presets (llava-next-34b, seamless-m4t-large-v2) always
take that stepped loop, with zeros as the stub's embeddings, as in the
reference; rwkv6-7b serves the dense layout and both recurrent presets
the scan prefill. `--data-mesh` / `--model-mesh` make the serving mesh
over the cards the process sees, falling back to one card as the
reference's `make_local_mesh` does: serving is one process on one
device, and the mesh shards nothing.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.engine import (EngineConfig, GenerationRequest, ServeEngine,
                                ServeSession)
from repro_torch.engine.serving.engine import serve_mesh
from repro_torch.runtime import make_generator, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=0,
                    help="slot capacity (0 => prompt+gen+1)")
    ap.add_argument("--stagger", type=int, default=1,
                    help="decode ticks between request arrivals")
    ap.add_argument("--prefill-mode", default="auto",
                    choices=["auto", "parallel", "scan"])
    ap.add_argument("--kv-layout", default="paged",
                    choices=["paged", "dense"],
                    help="paged KV arena (default) or dense per-slot "
                    "buffers")
    ap.add_argument("--page-size", type=int, default=16, dest="page_size",
                    help="token rows per KV page")
    ap.add_argument("--kv-pages", type=int, default=0, dest="kv_pages",
                    help="physical pages in the KV arena (0 = enough for "
                    "every slot at full capacity)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable shared-prefix page reuse")
    ap.add_argument("--system-prompt", type=int, default=0,
                    dest="system_prompt",
                    help="prepend this many shared system-prompt tokens "
                    "to every request (exercises prefix sharing)")
    ap.add_argument("--speculation-k", type=int, default=0,
                    dest="speculation_k",
                    help="draft tokens per speculation tick (0 = off); "
                    "greedy requests only")
    ap.add_argument("--draft-preset", default="", dest="draft_preset",
                    help="registry arch for the draft model (default: "
                    "the target at quarter depth); honours --reduced")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy argmax (default); >0 samples")
    ap.add_argument("--top-k", type=int, default=0, dest="top_k",
                    help="top-k truncation (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0, dest="top_p",
                    help="nucleus truncation (1.0 = off)")
    ap.add_argument("--sample-seed", type=int, default=None,
                    dest="sample_seed",
                    help="base sampling seed (default: per request_id)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    dest="deadline_s",
                    help="per-request wall-clock deadline in seconds "
                    "(0 = none); past it the request fails terminally")
    ap.add_argument("--max-retries", type=int, default=None,
                    dest="max_retries",
                    help="preemption retry budget per request (default: "
                    "unlimited)")
    ap.add_argument("--pressure-ladder", action="store_true",
                    dest="pressure_ladder",
                    help="graceful degradation under kv/queue pressure: "
                    "shed speculation, pause admissions, preempt")
    ap.add_argument("--ckpt-dir", default="", dest="ckpt_dir")
    ap.add_argument("--hot-reload", action="store_true", dest="hot_reload")
    ap.add_argument("--legacy", action="store_true",
                    help="the old ServeSession.generate stepped loop")
    ap.add_argument("--data-mesh", type=int, default=0)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain attention path)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generator the random weights come "
                    "from")
    args = ap.parse_args(argv)

    max_len = args.max_len or (args.system_prompt + args.prompt_len
                               + args.gen + 1)
    if max_len <= args.gen + args.system_prompt:
        ap.error(f"--max-len {max_len} leaves no room for a prompt "
                 f"beyond --system-prompt {args.system_prompt} + --gen "
                 f"{args.gen} tokens")
    draft_config = None
    if args.draft_preset:
        draft_config = {"arch": args.draft_preset, "reduced": args.reduced}
    cfg = EngineConfig(arch=args.arch, reduced=args.reduced,
                       max_slots=args.max_slots, max_len=max_len,
                       prefill_mode=args.prefill_mode,
                       kv_layout=args.kv_layout, page_size=args.page_size,
                       kv_pages=args.kv_pages,
                       prefix_sharing=not args.no_prefix_sharing,
                       speculation_k=args.speculation_k,
                       draft_config=draft_config,
                       pressure_ladder=args.pressure_ladder,
                       ckpt_dir=args.ckpt_dir,
                       hot_reload=args.hot_reload,
                       data_mesh=args.data_mesh,
                       model_mesh=args.model_mesh).validate()
    rng = np.random.RandomState(1)
    device = resolve_device(args.device)
    generator = make_generator(device, args.seed)

    mcfg = cfg.model_config(serve_mesh(cfg, device).axis_size("model"))
    stepped_only = mcfg.is_encoder_decoder or mcfg.frontend != "none"
    if args.legacy or stepped_only:
        if stepped_only and not args.legacy:
            print(f"[serve] {mcfg.name}: frontend/enc-dec archs serve "
                  f"through the stepped batch path")
        session = ServeSession.from_config(cfg, device=device,
                                           generator=generator)
        V = mcfg.vocab_size
        prompts = rng.randint(0, V, (args.requests, args.prompt_len))
        fe = None
        if mcfg.frontend != "none":
            # the stub's embeddings: zeros, as the reference's CLI feeds
            ft = mcfg.frontend_tokens or args.prompt_len
            fe = np.zeros((args.requests, ft, mcfg.frontend_dim),
                          np.float32)
        t0 = time.perf_counter()
        out = session.generate(prompts, args.gen, max_len=max_len,
                               frontend_embeds=fe,
                               stepped_prefill=True).cpu().numpy()
        wall = time.perf_counter() - t0
        toks = args.requests * args.gen
        print(f"[serve] legacy completed={args.requests} "
              f"generated_tokens={toks} wall_s={wall:.2f} "
              f"tok_s={toks / wall:.1f}")
        print(out[:, args.prompt_len:])
        return out

    engine = ServeEngine.from_config(cfg, device=device, generator=generator)
    V = engine.model.cfg.vocab_size

    def stream(handle, token):
        if len(handle.tokens) == 1:
            dt = handle.first_token_at - handle.submitted_at
            print(f"[serve] req {handle.request.request_id} first token "
                  f"after {dt * 1e3:.0f}ms (slot {handle.slot})")

    system = rng.randint(0, V, args.system_prompt)
    handles = []
    for i in range(args.requests):
        # staggered arrivals at jittered prompt lengths: the continuous-
        # batching case (admit into a running batch, retire independently)
        plen = max(1, min(args.prompt_len + int(rng.randint(-4, 5)),
                          max_len - args.gen - args.system_prompt))
        prompt = np.concatenate([system, rng.randint(0, V, plen)])
        seed = None if args.sample_seed is None else args.sample_seed + i
        handles.append(engine.submit(GenerationRequest(
            prompt=prompt, max_new_tokens=args.gen,
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, seed=seed, stream=stream,
            deadline_s=args.deadline_s or None,
            max_retries=args.max_retries)))
        for _ in range(args.stagger):
            engine.step()
    engine.drain()

    tp = engine.throughput()
    lat = {k: tp.pop(k) for k in list(tp)
           if k.startswith(("ttft_", "tpot_"))}
    res = {k: tp.pop(k) for k in
           ("failed", "deadline_kills", "retries", "drained",
            "restore_fallbacks", "degradation_level",
            "degradation_changes", "ladder_preempts") if k in tp}
    fields = " ".join(
        f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in tp.items())
    print(f"[serve] {fields}")
    print("[serve] resilience " + " ".join(
        f"{k}={v}" for k, v in res.items()))
    if lat:
        print("[serve] latency " + " ".join(
            f"{k[:-2]}_ms={v * 1e3:.1f}" for k, v in lat.items()))
    kv = engine.kv_stats()
    if args.speculation_k:
        print(f"[serve] spec k={args.speculation_k} "
              f"ticks={tp.get('spec_ticks', 0)} "
              f"proposed={tp.get('spec_tokens_proposed', 0)} "
              f"accepted={tp.get('spec_tokens_accepted', 0)} "
              f"acceptance={kv['spec_acceptance_rate']:.3f} "
              f"dispatches_per_token="
              f"{tp.get('dispatches_per_token', 0.0):.3f}")
    print(f"[serve] kv layout={kv['kv_layout']} "
          f"in_use={kv['kv_bytes_in_use']} peak={kv['peak_kv_bytes_in_use']} "
          f"capacity={kv['kv_capacity_bytes']} "
          f"pages={kv['kv_pages_used']}/{kv['kv_pages_used'] + kv['kv_pages_free']} "
          f"prefix_hits={kv['prefix_hits']} "
          f"prefix_tokens_reused={kv['prefix_tokens_reused']} "
          f"cow={kv['cow_copies']} preemptions={kv['preemptions']}")
    for h in handles:
        print(f"[serve] req {h.request.request_id} "
              f"({h.finish_reason}): {h.tokens}")
    # every submitted request must be terminal (completed or, with
    # deadlines/retry budgets in force, failed) — never hung
    terminal = tp["completed"] + res.get("failed", 0)
    if terminal != args.requests:
        print(f"[serve] ERROR: {terminal}/{args.requests} terminal",
              file=sys.stderr)
        sys.exit(1)
    if tp["completed"] != args.requests and not (
            args.deadline_s or args.max_retries is not None):
        print(f"[serve] ERROR: {tp['completed']}/{args.requests} completed",
              file=sys.stderr)
        sys.exit(1)
    return handles


if __name__ == "__main__":
    main()
