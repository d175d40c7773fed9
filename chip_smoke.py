#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py                  # one H100, ~a few minutes

Phases (any error fails the run with a non-zero exit and no result):
  1. card: print `nvidia-smi --query-gpu=name,power.limit` and require
     CUDA;
  2. build: compile every kernel under src/repro_torch/kernels/csrc with
     nvcc (one process per source, all at once) and print the seconds;
  3. kernels: each hand-written kernel against its plain PyTorch version
     on the card at qwen3-32b widths (H=64, KV=8, Dh=128, bf16), with the
     max abs error against its stated tolerance and median CUDA-event
     times of the kernel, the plain version and, as a yardstick the port
     never calls, `torch.nn.functional.scaled_dot_product_attention` on
     the same work;
  4. serve: `ServeEngine` on qwen3-32b at full width, depth cut to
     LAYERS (8 of 64), bf16 random weights from a generator seeded with
     SEED:
     4 slots, 6 staggered requests of ~900 tokens behind a shared
     64-token system prompt (so prefix-extend runs), 32 generated tokens
     each. Launch counters are zeroed just before and read just after;
     both kernels must have launched. Then prefill and the first decode
     step run again with attn_impl="plain" on the card, and the last-
     position logits are held to a stated bf16 tolerance. With
     --profile, an admission tick and five decode ticks then run under
     torch.profiler (device busy time, idle share, top kernels).

The line before the last is the kernels JSON, the last line
{"ok": true, "device": {...}}. Longer records go to
chiprun_out/chip_smoke.json. fp32 matmuls run in full fp32: TF32 is
switched off for cuBLAS and cuDNN.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TFLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM dense peaks
HBM_BYTES_S = 3.35e12
# kernel vs plain: both round the output once to bf16 (|out| <= ~4, so
# 2^-8 * 4 ~ 0.016) and the plain path also rounds P to bf16 before P.V;
# fp32 differs only in summation order
KERNEL_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
# logits of the 8-layer bf16 model, kernel path vs plain path: unit-scale
# logits after bf16 matmuls in every layer, where the two paths round P.V
# differently (fp32 P vs bf16 P), move by a few 1e-2; a masking or
# indexing fault moves them by O(1)
LOGIT_TOL = 0.25
LAYERS = 8      # of qwen3-32b's 64: 5.5 B params, 11 GB of bf16 weights
SEED = 0


def _smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi gave nothing (rc {out.returncode})"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _sdpa(q, k, v, mask=None, is_causal=False):
    """One library attention call on [B,H,T,Dh] q and [B,KV,S,Dh] k/v."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          is_causal=is_causal,
                                          enable_gqa=True)


# ------------------------------------------------------------ kernel phase
def _flash_case(name, B, T, S, *, causal=True, window=0, q_offset=0,
                dtype="bfloat16", H=64, KV=8, Dh=128, seed=0):
    import torch
    from repro_torch.kernels import flash_attention as FA
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, T, H, Dh, generator=g, device="cuda").to(dt)
    k = torch.randn(B, S, KV, Dh, generator=g, device="cuda").to(dt)
    v = torch.randn(B, S, KV, Dh, generator=g, device="cuda").to(dt)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = FA.flash_attention(q, k, v, **kw)
    ref = FA.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    finite = bool(torch.isfinite(out.float()).all())
    # work this data needs: unmasked (q, k) pairs per (b, h)
    qp = torch.arange(q_offset, q_offset + T, device="cuda")[:, None]
    kp = torch.arange(S, device="cuda")[None, :]
    m = torch.ones(T, S, dtype=torch.bool, device="cuda")
    if causal:
        m &= kp <= qp
    if window:
        m &= kp > qp - window
    pairs = int(m.sum())
    flops = 4 * B * H * Dh * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_flop, t_byte = flops / TFLOPS[dtype], nbytes / HBM_BYTES_S
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    plain_causal = causal and not window and q_offset == 0 and T == S
    mask = None if plain_causal or not (causal or window) else m
    return {
        "kernel": "flash_attention", "case": name, "dtype": dtype,
        "shape": dict(B=B, T=T, S=S, H=H, KV=KV, Dh=Dh, causal=causal,
                      window=window, q_offset=q_offset),
        "max_abs_err": err, "tol": KERNEL_TOL[dtype],
        "ok": finite and err <= KERNEL_TOL[dtype],
        "ms": _time_ms(lambda: FA.flash_attention(q, k, v, **kw)),
        "plain_ms": _time_ms(lambda: FA.flash_attention_ref(q, k, v, **kw),
                             iters=5, warmup=1),
        "library_ms": _time_ms(lambda: _sdpa(qt, kt, vt, mask,
                                             plain_causal)),
        "bound_ms": 1e3 * max(t_flop, t_byte),
        "bound_by": "operations" if t_flop >= t_byte else "bytes",
    }


def _decode_case(name, B, P, pos, *, rolling=False, ps=16, H=64, KV=8,
                 Dh=128, dtype="bfloat16", free_slots=(), seed=1):
    import torch
    from repro_torch.kernels import flash_attention as FA
    dt = getattr(torch, dtype)
    NP = B * P + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, H, Dh, generator=g, device="cuda").to(dt)
    kp = torch.randn(NP, ps, KV, Dh, generator=g, device="cuda").to(dt)
    vp = torch.randn(NP, ps, KV, Dh, generator=g, device="cuda").to(dt)
    perm = torch.randperm(NP - 1, generator=g, device="cuda") + 1
    table = perm.reshape(B, P).to(torch.int32)
    for b in free_slots:                  # free slots point at trash page 0
        table[b] = 0
    posv = torch.tensor(pos, dtype=torch.int32, device="cuda")
    out = FA.paged_decode_attention(q, kp, vp, table, posv, rolling=rolling)
    ref = FA.paged_decode_attention_ref(q, kp, vp, table, posv,
                                        rolling=rolling)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    finite = bool(torch.isfinite(out.float()).all())
    cap = P * ps
    rows = [min(p + 1, cap) for p in pos]          # valid rows per slot
    row_bytes = KV * Dh * q.element_size()
    nbytes = (2 * sum(rows) * row_bytes + 2 * q.numel() * q.element_size()
              + table.numel() * 4 + posv.numel() * 4)
    flops = 4 * H * Dh * sum(rows)
    t_flop, t_byte = flops / TFLOPS[dtype], nbytes / HBM_BYTES_S
    # library yardstick: one SDPA call over the slots' pages gathered
    # into the dense layout beforehand (the gather is not timed)
    kf = kp[table.long()].reshape(B, cap, KV, Dh).transpose(1, 2).contiguous()
    vf = vp[table.long()].reshape(B, cap, KV, Dh).transpose(1, 2).contiguous()
    r = torch.arange(cap, device="cuda")[None, :]
    pb = posv.long()[:, None]
    slot_pos = pb - torch.remainder(pb - r, cap) if rolling else r
    mask = ((slot_pos >= 0) & (slot_pos <= pb))[:, None, None, :]
    q4 = q[:, :, None, :]
    return {
        "kernel": "paged_decode_attention", "case": name, "dtype": dtype,
        "shape": dict(B=B, pages_per_slot=P, page_size=ps, H=H, KV=KV,
                      Dh=Dh, rolling=rolling, pos=list(pos)),
        "max_abs_err": err, "tol": KERNEL_TOL[dtype],
        "ok": finite and err <= KERNEL_TOL[dtype],
        "ms": _time_ms(lambda: FA.paged_decode_attention(
            q, kp, vp, table, posv, rolling=rolling)),
        "plain_ms": _time_ms(lambda: FA.paged_decode_attention_ref(
            q, kp, vp, table, posv, rolling=rolling)),
        "library_ms": _time_ms(lambda: _sdpa(q4, kf, vf, mask)),
        "bound_ms": 1e3 * max(t_flop, t_byte),
        "bound_by": "operations" if t_flop >= t_byte else "bytes",
    }


def kernel_phase():
    """Every kernel against its plain version. The first case of each
    kernel is the shape the serve phase's main path gives it."""
    mixed = [0, 7, 500, 1023, 1324, 2000, 15, 16]   # fresh, mid, full, wrap
    cases = [
        # main path: a 2-request prefix-extend group (64-token prefix,
        # 1024-token tail bucket) and a 4-slot decode tick at ~1000 rows
        _flash_case("serve_extend", 2, 1024, 1088, q_offset=64),
        _flash_case("causal", 2, 1024, 1024),
        _flash_case("ragged", 2, 700, 700),
        _flash_case("window256", 2, 1024, 1024, window=256),
        _flash_case("noncausal", 2, 1024, 1024, causal=False),
        _flash_case("q_offset64", 2, 960, 1024, q_offset=64),
        _flash_case("fp32", 1, 256, 256, dtype="float32", H=8, KV=2),
        _decode_case("serve_tick", 4, 128, [964, 980, 1001, 990]),
        _decode_case("linear", 8, 64, mixed),
        _decode_case("rolling", 8, 64, mixed, rolling=True),
        _decode_case("trash_slots", 8, 64, mixed, free_slots=(1, 6)),
        _decode_case("fp32", 4, 8, [0, 40, 127, 300], dtype="float32",
                     H=8, KV=2),
    ]
    print(f"{'kernel':24s} {'case':13s} {'err':>9s} {'tol':>7s} "
          f"{'ms':>9s} {'plain_ms':>9s} {'lib_ms':>9s} {'bound_ms':>9s}")
    for c in cases:
        print(f"{c['kernel']:24s} {c['case']:13s} {c['max_abs_err']:9.2e} "
              f"{c['tol']:7.0e} {c['ms']:9.4f} {c['plain_ms']:9.4f} "
              f"{c['library_ms']:9.4f} {c['bound_ms']:9.4f} "
              f"{'ok' if c['ok'] else 'FAIL'}")
    bad = [f"{c['kernel']}/{c['case']}" for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"kernel != plain beyond tolerance: {bad}")
    return cases


# ------------------------------------------------------------- serve phase
def serve_phase(card: str, profile: bool = False):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import EngineConfig, GenerationRequest, \
        ServeEngine
    from repro_torch.engine.serving.slots import paged_insert_rows
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    full = get_config("qwen3-32b")
    cfg = dataclasses.replace(full, n_layers=LAYERS)
    print(f"[smoke] model {cfg.name}: full width d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim="
          f"{cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size}; "
          f"depth cut {full.n_layers} -> {LAYERS} layers; "
          f"{cfg.param_count() / 1e9:.2f}B params in bf16")
    model = build_model(cfg, compute_dtype=torch.bfloat16,
                        param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    torch.cuda.synchronize()
    print(f"[smoke] random init {time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    ecfg = EngineConfig(max_slots=4, max_len=2048, page_size=16,
                        param_dtype="bfloat16")
    V = cfg.vocab_size
    rng = np.random.RandomState(SEED)

    # warm-up engine (cuBLAS handles, kernel library load), then a fresh
    # engine for the measured run
    warm = ServeEngine(ecfg, model, params)
    warm.submit(GenerationRequest(rng.randint(0, V, 100), max_new_tokens=2))
    warm.drain()
    del warm

    engine = ServeEngine(ecfg, model, params)
    system = rng.randint(0, V, 64)
    prompts = [np.concatenate([system, rng.randint(0, V, rng.randint(880,
                                                                     921))])
               for _ in range(6)]
    arrivals = [[0], [1, 2], [3], [4], [5]]   # one tick between arrivals
    torch.cuda.synchronize()
    build.reset_launches()
    handles = []
    for group in arrivals:
        for i in group:
            handles.append(engine.submit(GenerationRequest(
                prompts[i], max_new_tokens=32)))
        engine.step()
    engine.drain()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    tp = engine.throughput()
    kv = engine.kv_stats()
    print(f"[smoke] serve completed={tp['completed']}/6 "
          f"prefill_calls={tp['prefill_calls']} "
          f"decode_steps={tp['decode_steps']} "
          f"prefix_hits={kv['prefix_hits']} launches={launches}")
    assert tp["completed"] == 6, tp
    assert all(len(h.tokens) == 32 and all(0 <= t < V for t in h.tokens)
               for h in handles)
    assert kv["prefix_hits"] > 0, kv
    for name, n in launches.items():
        assert n > 0, f"{name} never launched on the main path"
    assert engine.leaked_pages() == 0
    metrics = {k: tp[k] for k in ("prefill_ms_mean", "decode_tick_ms_mean",
                                  "ttft_mean_s", "ttft_p50_s", "tpot_mean_s",
                                  "tpot_p50_s", "tok_s", "wall_s")}
    print(f"[smoke] serve prefill_ms={metrics['prefill_ms_mean']:.2f} "
          f"decode_tick_ms={metrics['decode_tick_ms_mean']:.2f} "
          f"ttft_ms_mean={1e3 * metrics['ttft_mean_s']:.1f} "
          f"ttft_ms_p50={1e3 * metrics['ttft_p50_s']:.1f} "
          f"tpot_ms_mean={1e3 * metrics['tpot_mean_s']:.2f} "
          f"tok_s={metrics['tok_s']:.1f} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"| {card}")

    # kernel path vs plain path on the card: prefill + first decode step
    plain = build_model(cfg, compute_dtype=torch.bfloat16,
                        param_dtype=torch.bfloat16, attn_impl="plain")
    n = 2
    P = 1024
    toks = np.zeros((n, P), np.int32)
    lens = np.asarray([len(p) for p in prompts[:n]], np.int32)
    for i in range(n):
        toks[i, :lens[i]] = prompts[i]
    toks_t = torch.from_numpy(toks).cuda()
    lens_t = torch.from_numpy(lens).cuda()
    out = {}
    nxt = None
    for tag, m in (("kernel", model), ("plain", plain)):
        logits, rows = m.prefill_cache(params, toks_t, lens_t, 2048)
        logits = logits[:, -1, :]
        if nxt is None:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        pps = 2048 // 16
        cache = m.init_cache(params, n, 2048, paged=(16, n * pps + 1))
        tables = (torch.arange(n * pps, device="cuda", dtype=torch.int32)
                  .reshape(n, pps) + 1)
        paged_insert_rows(cache, rows, torch.arange(n, device="cuda"),
                          tables, tables)
        dlogits, _ = m.decode_step(params, nxt, cache)
        out[tag] = (logits.float(), dlogits[:, -1, :].float())
    torch.cuda.synchronize()
    checks = {}
    for i, step in enumerate(("prefill", "decode")):
        a, b = out["kernel"][i], out["plain"][i]
        assert a.shape == (n, V) and bool(torch.isfinite(a).all())
        err = (a - b).abs().max().item()
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        checks[step] = {"max_abs_err": err,
                        "mean_abs_err": (a - b).abs().mean().item(),
                        "logit_std": a.std().item(),
                        "greedy_agreement": agree, "tol": LOGIT_TOL}
        print(f"[smoke] {step} logits kernel vs plain: max_abs_err={err:.4f}"
              f" mean_abs_err={checks[step]['mean_abs_err']:.5f} "
              f"(tol {LOGIT_TOL}) logit_std={checks[step]['logit_std']:.3f}"
              f" greedy_agreement={agree:.2f}")
        assert err <= LOGIT_TOL, f"{step} logits differ by {err}"
    result = {"launches": launches, "metrics": metrics, "kv": kv,
              "throughput": tp, "plain_checks": checks,
              "layers": LAYERS, "full_layers": full.n_layers}
    if profile:
        result["profile"] = profile_windows(ecfg, model, params, prompts,
                                            card)
    return result


def _profiled(fn):
    """Run fn() under torch.profiler; returns (wall ms, device kernel ms
    by name) for the window, which starts and ends synchronised."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and getattr(e, "device_type", None) is not None \
                and "CUDA" in str(e.device_type):
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    return wall, by_name


def profile_windows(ecfg, model, params, prompts, card):
    """Where the serve time goes: one admission tick (two prompts: a
    full prefill and a prefix-extend prefill, then one decode) and five
    decode-only ticks of four slots, each under torch.profiler."""
    from repro_torch.engine import GenerationRequest, ServeEngine
    engine = ServeEngine(ecfg, model, params)
    engine.submit(GenerationRequest(prompts[0], max_new_tokens=64))
    engine.step()                                  # leader registers prefix
    for p in prompts[1:4]:
        engine.submit(GenerationRequest(p, max_new_tokens=64))
    out = {}
    for name, fn in (("admit_tick", engine.step),
                     ("decode_5_ticks", lambda: [engine.step()
                                                 for _ in range(5)])):
        wall, kern = _profiled(fn)
        busy = sum(kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
        mine = {k: v for k, v in kern.items()
                if "flash_fwd_kernel" in k or "paged_decode_kernel" in k}
        out[name] = {"wall_ms": wall, "device_busy_ms": busy,
                     "idle_share": 1.0 - busy / wall,
                     "port_kernels_ms": sum(mine.values()), "top": top}
        print(f"[smoke] profile {name}: wall_ms={wall:.2f} "
              f"device_busy_ms={busy:.2f} idle_share={1 - busy / wall:.3f} "
              f"port_kernels_ms={sum(mine.values()):.2f} | {card}")
        for k, v in top:
            print(f"[smoke]   {v:9.3f} ms  {k[:100]}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the serve phase, trace an admission tick "
                    "and five decode ticks with torch.profiler")
    args = ap.parse_args(argv)

    card = _smi()
    print(card)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}")
    record = {"card": card}
    try:
        secs = build.build_all()
        print(f"[smoke] built kernels {build.sources()} in {secs:.1f}s")
        record["build_s"] = secs
        cases = record["kernel_cases"] = kernel_phase()
        record["serve"] = serve_phase(card, args.profile)
    except Exception:                   # any phase failing fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(
            json.dumps(record, indent=1, default=str))

    launches = record["serve"]["launches"]
    rows = []
    for c in cases:
        if c["case"] not in ("serve_extend", "serve_tick"):
            continue
        rows.append({
            "name": c["kernel"], "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": ("src/repro/kernels/flash_attention.py:41"
                         if c["kernel"] == "flash_attention" else
                         "src/repro/kernels/flash_attention.py:131"),
            "launches": launches.get(c["kernel"], 0),
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
