#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py                  # one H100, ~a few minutes
    python3 chip_smoke.py --profile        # + torch.profiler windows
    python3 chip_smoke.py --serve-ab DIR   # serve phase, DIR vs this tree
    python3 chip_smoke.py --scan-ab DIR    # phase 8 (e)'s scan prefill, same
    python3 chip_smoke.py --combiners-only # phase 9 alone, no result line
    python3 chip_smoke.py --subsystems-only # phase 10 alone, no result line
    python3 chip_smoke.py --families-only  # phase 11 alone, no result line
    python3 chip_smoke.py --recurrent-only # phase 12 alone, no result line
    python3 chip_smoke.py --ranks-only     # phase 6 alone, no result line
    python3 chip_smoke.py --ranks-only --witness  # and (A) against one
                                                  # process in fp32
    python3 chip_smoke.py --model-axis-only  # phase 13 alone, no result
                                             # line

--serve-ab compares two commits on one card within one call: DIR is
another checkout of the repo (e.g. `git archive <parent> | tar -x -C
build/parent`, a gitignored directory). The serve phase below runs on
DIR's package and on this one, in turns DIR, this, this, DIR, each in a
process of its own (this script's code, the package and its kernels
from the tree), and a `SERVE_AB` JSON line gives the four runs' metrics.
--scan-ab does the same for phase 8 (e)'s scan prefill (`scan_phase`:
plain attention, no kernel built), ending with a `SCAN_AB` line of
each run's times in ms.

Phases, in the order they run: 1, 2, 6, 3, 4, 8, 5, 13, 9, 10 (any
error fails the run with a non-zero exit and no result). Single-process
phases run in this process while rank processes of another phase share
the card, where the card's memory holds both: beside phase 6's runs
(a), (b) and (A), phase 13's twins of (c) and (d1) and phase 12 (b)-(c)
(P12_EARLY), phase 11, and the twins of (e1) and (e2) and phase 12 (g);
beside phase 9 (c)'s launches, phase 7; beside phase 10 (b)'s, after
(d), the rest of phase 12. Their times are then taken with the ranks'
gloo traffic on the host's cores, and each phase's wall holds what ran
beside it:
  1. card: print `nvidia-smi --query-gpu=name,power.limit` and require
     CUDA;
  2. build: compile every kernel under src/repro_torch/kernels/csrc with
     nvcc (one process per source, all at once) and print the seconds;
  3. kernels: each hand-written kernel against its plain PyTorch version
     on the card at qwen3-32b widths (H=64, KV=8, Dh=128, bf16), plus
     gemma-7b's (H=KV=16, Dh=256) and Dh=64 flash cases and the split-K
     decode's edges (one slot with every page live, a batch that takes
     one split, pos 0 and pos on split boundaries, rolling past cap, free
     slots), with the max abs error against its stated tolerance, the
     error against an fp32 run of the plain version held to
     ERR32_FACTOR x the plain bf16 version's own plus ERR32_SLACK (for
     flash also over the last half of the query rows alone), every
     decode case run twice and required bitwise equal, and median
     CUDA-event times per call (host work of the launch included) of the
     kernel, the plain version and, as a yardstick the port never calls,
     `torch.nn.functional.scaled_dot_product_attention` on the same work
     (on its fused backends where it has the mask: plain or lower-right
     causal), each timed on its own; kernel and yardstick also by device
     time alone (CUDA-graph replay, `device_ms`, `library_device_ms`);
     and at the MoE presets' shapes of phase 11: mixtral's prefill of a
     4,600-token prompt in window mode (H 48, KV 8, window 4096), its
     rolling decode over 256 pages a slot, and moonshot's prefix extend
     (H = KV = 16, q_offset 64); and hymba-1.5b's decodes of phase 12 (H
     25, KV 5: G = 5, Dh 64), every slot past its 1024-row window, and
     at (b)'s serving shape (16 pages a slot, positions 48-95, rolling
     mode before the window wraps);
     The Adasum block kernels (`block_dots`, `block_combine`) are held
     the same way at the shapes the train phase gives them: the gemma-7b
     embedding bucket (786,432,000 elements a lane, block 8192, read as
     one lane pair of a [2, L] bucket buffer, and in fp32 also as the two
     pairs of a [4, L] buffer, the span-4 tree's level 0) in fp32 and
     bf16, the 1-D halves an RVH round hands them at world 4 (the
     embedding bucket's round-0 half of 393,216,000 fp32, read in place
     from the round buffer, and its round-1 quarter), the
     `w_up` leaf bucket, the two norms' buckets (block 2048 with two
     segments, block 1024) and a 256-element granule; one shape must be
     refused.
     Their yardsticks are one `torch.bmm` on the same work;
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
     torch.profiler (device busy time, idle share, top kernels);
  8. serving extensions (runs right after phase 4, on its model, params
     and prompts; launch counters zeroed before, read after: flash and
     paged decode must both launch; one `SERVE_EXT {json}` line):
     (a) phase 4's requests without prefix sharing on kv_layout="dense"
     and "paged": under attn_impl="plain" the tokens must be equal; the
     kernel paged run against the plain dense one gives the share of
     equal tokens, the first divergences and, at each, the margin by
     which the kernel path's logits prefer its token (at most LOGIT_TOL:
     rounding, not a fault); the first step's logits within LOGIT_TOL;
     the decode-tick ms of each layout;
     (b) speculation, k=SPEC_K, on the reference benchmark's workload
     (`benchmarks/serve_spec.py`: SPEC_WORKLOAD, 4 slots, arrivals
     SPEC_STAGGER ticks apart): the target's blocks 1.. get attention
     `wo` and the MLP down-projection zeroed and the draft is its
     one-layer slice (acceptance's upper bound, 1.0). Plain and spec in
     turns (plain, spec, spec, plain, after a warm-up of each): tok/s,
     wall s, target dispatches per generated token, acceptance (> 0.9
     required), spec ticks, the draft's kernel launches in one tick
     (torch.profiler), acceptance on the ticks after a full-accept tick
     (the k+1 trap; its mean capped at 1 a tick > 0.9), the share of spec
     tokens equal to plain with divergence margins as in (a), and the
     first tick's verify rows against plain decodes of the same tokens;
     then the auto-derived draft (quarter depth, random weights);
     (c) phase 4's requests with kv_pages=PREEMPT_PAGES: preemptions > 0,
     all done, no page leaked after drain + flush_prefix; token agreement
     with phase 4, divergence margins as in (a);
     (d) a 5 ms deadline kills two requests terminally; request_drain()
     fails two queued requests as 'drained'; the pressure ladder, spec on,
     half the pages: it reaches level >= 1 and no tick at level >= 1
     speculates; no leaks;
     (e) scan prefill vs parallel prefill of two prompts (40 and 64
     tokens), plain attention: logits within LOGIT_TOL, first tokens
     equal unless the top-2 gap is within twice the logit difference,
     and the engines' first tokens the functions';
     (f) `ServeSession.generate` on a batch of 2 x 48 tokens, plain
     attention: the stepped loop vs the engine, compared as (e) on the
     first step, and the share of equal tokens;
  5. train: `TrainSession` on gemma-7b at full width, depth cut to
     TRAIN_LAYERS (1 of 28), fp32 params, bf16 compute, seq 512, global
     batch 8, 64 MB fusion buckets, weights from a generator seeded with
     SEED. Two runs of 3 steps from fresh state: momentum at span 4 (the
     `pre` point, two tree levels) and adam at span 2 (the `post` point,
     per-lane state). Launch counters are zeroed just before each run
     and must read one `block_dots` and one `block_combine` per bucket
     and tree level per step. Loss and every CombineStats metric must be
     finite. Step 1 then runs again from fresh state twice on the kernel
     path (params bitwise equal) and once with combine_impl="plain" on
     the card: the combined tree and every CombineStats level are held
     to the kernel path's within COMBINED_RTOL of their own scale, and
     the params within TRAIN_PARAM_TOL. Prints ms per step, the
     combine's share (CUDA events around every combine call) and peak
     memory. With --profile, a fourth step of each run is traced;
  6. ranks: multi-rank Adasum (RVH, the paper's Algorithm 1) through
     `TrainSession.from_config` in rank processes of this script, started
     with the environment torchrun gives (RANK, WORLD_SIZE, LOCAL_RANK,
     MASTER_ADDR/PORT), all on cuda:0 over gloo: this machine has one
     card and NCCL puts no two ranks on one card, so the exchanged halves
     are staged through pinned host memory and exchange times are host
     loopback times (printed so; NCCL is not run). The parent first frees
     its cached card memory and prints what it still holds. RANK_ARCH
     (minicpm3-4b) at full width, depth cut to RANK_LAYERS (1 of 62),
     fp32 params, bf16
     compute, seq 512, global batch RANK_BATCH, 64 MB buckets, RANK_STEPS
     steps (one in a sharded run, whose repeat of step 1 is then timed
     as its steady step), the runs of RANK_RUNS: (a) world 4, momentum
     (the `pre` point; two RVH rounds), fsdp (item 7a's run B: params
     and state 1/4 a rank, RVH keeping each rank's piece), (b) world 2
     with adam (`post` point, per-rank whole state) and int8 wire
     compression, (A) world 4, adam, span 2, fsdp + scatter_grads,
     accum_steps 2 (item 7a's run A: ZeRO-2 lane gradients, post-point
     ZeRO-1 in each lane group, FSDP params). Each rank checks: one
     `block_dots` and one `block_combine` per bucket (of the plan's, on
     its lane-group parts) per round per step (counters zeroed just
     before the run); the params every rank holds whole bitwise equal
     across ranks after every step (per-leaf checksums gathered); step 1
     from fresh state again bitwise equal; in RANK_PLAIN's runs step 1
     with combine_impl="plain" on the card, the combined tree and
     CombineStats within COMBINED_RTOL and params within TRAIN_PARAM_TOL
     (under int8, at most INT8_FLIP_FRACTION of the elements one
     quantization step apart); in the sharded runs step 1 with the
     params whole (fsdp off), each rank's pieces of it against its own
     (TRAIN_PARAM_TOL but for SHARD_FLIP_FRACTION of the elements, none
     past SHARD_MAX_ABS), and the run's peak below that step's; with
     --witness, in RANK_WITNESS's runs step 1 in fp32 compute against the
     same step in this process before the ranks start (lanes stacked,
     nothing sharded): adam's m within WITNESS_M_RTOL, params within
     TRAIN_PARAM_TOL where every lane's |m| passes WITNESS_M_FLOOR, else
     SHARD_MAX_ABS; in RANK_SYNTHETIC's runs,
     random lanes of ~7 M elements in ten leaves through RVH against the
     single-process fused tree on rank 0, and `Comm.gather_to_host` (a
     checkpoint's lane rows) of a CUDA tensor from every other rank:
     rank 0's host rows are each sender's, and the bytes counted staged
     are one copy a sender. Prints step ms, the combine's ms and within
     it the exchange (and staging), the reduce-scatter, all-gather and
     all-reduce, dot-sum and dots+combine kernel ms (CUDA events), staged
     bytes, each rank's GiB of params and state, and each rank's peak
     allocation and their sum (at most RANK_MEM_GIB); (A)'s peaks beside
     (b)'s, which they must stay below (SHARD_BELOW). Run (a) also saves
     the state before its last step (rank 0 gathers the full leaves and
     writes, all ranks wait), restores it in place on every rank (each
     its pieces) and redoes the step: params bitwise equal to the first
     time. `--ranks-only` builds the kernels and runs this phase alone;
  7. checkpoints: `TrainSession` on gemma-7b at full width, depth cut to
     CKPT_LAYERS (1 of 28), fp32 params, bf16 compute, seq 512, global
     batch 8, 64 MB buckets, momentum at span 2 on the `post` point (the
     state carries the lane axis: 12.75 GB a checkpoint), the async
     manager, prefetch with the device stage, checkpoints under
     build/ckpt (deleted at the end; free disk and host RAM must be twice
     a checkpoint). (a) fit(2) saves step 2, then step 3 runs; fresh
     sessions on the directory (prefetch on, then off) resume ("resumed
     from step 2"), their step 3 bitwise the uninterrupted one, with one
     block_dots and one block_combine per bucket (counters zeroed just
     before); prints the snapshot ms, write s and GB, restore load / crc
     / copy s and step ms. (b) `ServeEngine.from_config` with ckpt_dir
     serves step 2 (params checksums equal to the run's), 6 staggered
     requests on 4 slots, flash and paged decode launched, greedy tokens
     equal to an engine given the params directly. (c) hot-reload on the
     training session's manager: step 3 saved while a request is in
     flight, a second request after it; one swap, at least one
     transition tick, each request's tokens equal to an engine on its
     pinned step alone; prints the swap's poll and restore times and the
     transition tick ms beside a normal tick's. (d) prints run (a) of
     phase 6's checkpoint check;
  9. combiners (runs last): (a) the delayed combine (combine_delay=1) on
     phase 5's model, momentum at span P9_SPAN (the carry is span x 5.36
     GB fp32, double-buffered): 3 single-program steps, then 3 rounds from
     the same start through `DelayedCombineStream.step` and its
     `serial_step` in turns (each takes the state the other left), params
     and carry bitwise equal; the step-0 correction exactly zero; the
     step-1 carry's correction, kernel arm vs combine_impl="plain", within
     COMBINED_RTOL; compute_s / combine_wait_s, the correction's own ms,
     and, as `benchmarks/delayed_combine.py` measures it, with latency
     added to the exchange leg to match a local step, P9_OVERLAP_ROUNDS
     overlapped and serial rounds in turns after an untimed overlapped
     one (hidden fraction from their medians; with --profile the untimed
     round and one more of each under torch.profiler: busy
     time per CUDA stream, the time both streams ran, host threads'
     launches and runtime calls, traces in chiprun_out/); peaks at most
     P9_MEM_GIB. (b) acc_dtype="float64": two steps of phase 5's first
     train run (momentum, span 4) with fp64 dots, kernel arm and plain arm
     (combined tree and CombineStats within COMBINED_RTOL, params within
     TRAIN_PARAM_TOL, the per-level dot triples summed in float64; the
     CombineStats levels are fp32, as the reference's), and in fp32 with
     combine_delay=0 named (no delayed piece built; step 1 bitwise phase
     5's); the combine ms of each. (c) P9_RANK_ARCH (minicpm3-4b) at
     full width, one layer, in rank processes
     on cuda:0 over gloo, one launch a world size, each run's steps as
     P9_RANK_RUNS gives them: world 4 accumulation 2 at span 2
     (momentum: its state ZeRO-1, the lane gradient all-reduced in its
     lane group and cut to the rank's part) and local steps 2 at span 2
     (sgd); world 2 mean (sgd) and momentum with combine_delay=1 (sum,
     adascale and adasum-linear run across ranks in phase 13 (e)); params
     bitwise equal across ranks after every step; step, combine,
     exchange, all-reduce and staging ms, staged bytes and each rank's
     peak (their sum at most RANK_MEM_GIB). `block_dots` and
     `block_combine` must launch in the phase (counters zeroed at its
     start; rank 0's of each launch added). `--combiners-only` builds the
     kernels and runs this phase alone.
 10. subsystems (ROADMAP item 8; runs last): (a) `fit_adaptive` with the
     real `BatchController` on phase 5's model (momentum, span P10_SPAN,
     batch P10_BATCH capped at P10_MAX_BATCH, P10_STEPS steps): the
     noise scale of every step, the resize step and plan (batch doubled,
     span kept at dp 1, LR times the AdaScale gain), the boundary save's
     stall and write and the restore's load / crc / copy seconds, step ms
     before and after, peak at most P10_MEM_GIB, each step once in order
     and the rows doubled at the boundary (if the noise scale never
     enters the band, a FINDING line and the same machinery with a
     scripted plan). (c) phase 9 (a)'s delayed combine through
     `DelayedCombineStream`: a warm-up round, then P10_SPIKE_ROUNDS rounds
     with `comm_spike` events and as many without, params and carry
     bitwise equal, each round's ms. (d) serve chaos on phase 4's widths
     at P10_SERVE_LAYERS layers: slow prefill, P10_PAGES pages, two
     requests with a deadline they cannot meet, a drain, the ladder, and
     hot-reload watching a checkpoint whose newest step is bit-flipped:
     every request terminal, the reload falling back to the step before,
     no page leaked after the drain and the prefix flush, both attention
     kernels launched. (b) `fit_elastic` in 4 rank processes on cuda:0
     over gloo with phase 9 (c)'s model (sgd): a node loss at P10_LOSS_STEP
     whose boundary save is bit-flipped (4 -> 2 ranks, restored from the
     periodic save before it and the step replayed), then capacity back
     after one step (2 -> 4, the gain-rescaled LR): the steps seen, the
     replayed step's batch checksum equal to the first attempt's, one
     fallback and the bad step quarantined on every rank, the same logs
     and LR everywhere, params bitwise across ranks after every step,
     step ms at each world, the rebuilds' seconds and the saves' and
     restores' timings. `--subsystems-only` builds the kernels and runs
     this phase alone.
 11. families (ROADMAP item 6's first half): the MLA and MoE
     presets at full width, random weights from SEED. (a) mixtral-8x22b,
     depth P11_MIXTRAL_LAYERS, bf16: `ServeEngine`, paged, 4 slots, a
     4,600-token prompt (flash in window mode, decode over the rolling
     pages) and three short ones, P11_GEN tokens each; both attention
     kernels must launch; then the kernel arm against attn_impl="plain":
     router choices are recorded (`_RouteLog`) and the forward's logits
     held within LOGIT_TOL at every position before a request's first
     routing flip, the serving prefill and one decode held on the rows
     whose routing agrees; the share of (token, k) choices that agree
     and the smallest router gap at a flip are printed. (b)
     moonshot-v1-16b-a3b, depth P11_MOONSHOT_LAYERS (1 dense + 3 MoE):
     a shared 64-token prefix (prefix extend through flash with
     q_offset), both cache segments written, then speculation k =
     P11_SPEC_K with the derived draft: tokens against plain decode,
     acceptance, pairs dropped in verify forwards. (c) minicpm3-4b at
     P11_MINICPM_LAYERS of its 62 layers: paged with and without prefix sharing and dense
     (dense == paged tokens, margins at divergences as phase 8's), the
     latent cache's bytes a token against a GQA cache of the same heads.
     (d) moonshot at P11_TRAIN_MOONSHOT layers, momentum span 2, and (e)
     minicpm3-4b at P11_TRAIN_MINICPM layers, adam span 2: three
     `TrainSession` steps (seq 512, batch 8), one `block_dots` and one
     `block_combine` per bucket a step, step 1 again bitwise and with
     combine_impl="plain" (as phase 5), step and combine ms, aux loss,
     drop fraction, peak memory at most P11_MEM_GIB.
     `--families-only` builds the kernels and runs this phase alone.
 12. recurrent (ROADMAP item 6's second half; runs last): the SSM,
     hybrid, vision-frontend and encoder-decoder presets at full width,
     random weights from SEED, bf16 for serving. (a) rwkv6-7b at
     P12_SERVE_LAYERS of its 32 layers: `ServeEngine` asked for the
     paged layout and speculation k = P11_SPEC_K must fall back to
     dense and disable
     speculation, each with its warning; 4 prompts of 24-48 tokens in
     one admission (two scan-prefill groups of unequal lengths), P12_GEN
     tokens each; the recurrent state a slot; the scan prefill's repair
     (an ended slot's leaves bitwise equal to the prefill cut at its
     length); one-token decode over 64 tokens against the chunked
     forward, within P12_FP32_TOL in fp32 compute, and in bf16 each path
     against the fp32 forward (the decode's error at most
     P12_BF16_FACTOR x the forward's own + LOGIT_TOL / 5). (b)
     hymba-1.5b at P12_SERVE_LAYERS of its 32 layers, paged (its mamba
     state dense per slot, warned and counted), one scan-prefill group
     of 4 prompts of
     48-64 tokens: the paged-decode kernel must launch (G = 5); then
     the prompts stepped through the kernel arm and one tick of
     each arm from that same cache, every layer: in bf16 every
     paged-decode call held against its plain version on the same
     inputs (KERNEL_TOL) and the tick's logits recorded (one ulp a layer
     grows to O(1) through random-weight layers), in fp32 compute the
     tick's logits held within P12_FP32_TOL. (c) hymba at P12_ROLL_LAYERS
     layers in fp32 compute (the paged kernel's fp32 path): one slot
     stepped through a P12_ROLL_PROMPT-token prompt and P12_ROLL_GEN
     tokens over its rolling 1024-row window on both arms, logits held
     within P12_FP32_TOL at every step. (d) `ServeSession.generate`'s
     stepped loop: llava-next-34b at P12_LLAVA_LAYERS layers with 576
     patch embeddings (its tokens must equal those without them: the
     reference drops them) and seamless-m4t-large-v2 at its full 24 +
     24 layers from 64 frames; each one's stepped logits at the prompt's
     last token against the teacher-forced forward within LOGIT_TOL.
     (e)-(h) three `TrainSession` steps (batch 8, span 2) of rwkv6-7b (1
     layer, adam), hymba (4 layers, momentum), llava (1 layer,
     momentum; 576 patch positions + 512 tokens) and seamless (3 + 3
     layers, momentum; 128 frames + 256 tokens) (`P12_TRAIN`), held as
     phase 11 (d)/(e) holds its runs, with the combined gradient finite.
     `phase12_launches` sums each kernel's counts over the main-path runs:
     (a)'s and (b)'s serve, (d)'s stepped loops and (e)-(h)'s
     train steps; (c) and the holds are comparisons and do not count.
     flash_attention must launch in none of them (no parallel prefill on
     these paths, training takes plain attention), as in the reference.
     `--recurrent-only` builds the kernels and runs this phase alone.
  13. model axis (runs right after phase 5, before phase 7 leaves a
     session on the card), on qwen3-32b (hf Qwen/Qwen3-32B) at full
     width, TP_LAYERS of its 64 layers, bf16 compute, seq TP_SEQ, batch
     TP_BATCH, weights from SEED, and on the MoE presets:
     (a) the twins: before the ranks start (in the whole run, beside
     phase 6's ranks), this process runs each grid run's one-process
     twin: step 1 with the run's data lanes stacked on the card (span 2,
     nothing sharded) in bf16 and fp32 compute, the bf16 step's params
     and each leaf's bf16-vs-fp32 difference saved for the ranks. A
     run's step 1 is held to its twin leaf by leaf within TP_TWIN_FACTOR
     x the twin's own bf16-vs-fp32 difference (+ TP_TWIN_FLOOR): the
     twin rule.
     (b) head padding in serving: minitron-4b (arXiv:2407.14679) at full
     width, PAD_LAYERS of 32, padded by `pad_heads_for_tp` for the
     production mesh's model axis (16): 24 / 8 heads -> 32 / 16; the
     engine's own path (`resolve_serve_parts` with that mesh) pads alike;
     weights converted from the unpadded model (`convert_gqa_params`);
     both engines serve 4 prompts of PAD_PROMPTS tokens, PAD_GEN new
     each (tick and prefill ms printed); tokens held by phase 8's rule
     (equal, or each first divergence within LOGIT_TOL by the unpadded
     model's margin), logits in fp32 compute within PAD_FP32_TOL, and
     every flash and paged-decode call of a padded run against its
     plain version (bf16 3e-2). Then the kernels at the padded shapes
     (prefill B 4 x 128, a tick over 8 pages a slot, H 32, KV 16) and
     RVH's round-0 half of the TP shard of qwen3-32b's embedding, as in
     phase 3. `phase13_launches` counts (c)'s and (e4)'s rank 0 and (b)'s
     padded run.
     (c) both axes at once: qwen3-32b in its own preset regime
     at the widths one card allows (`TrainSession.from_config` of
     `EngineConfig.preset("qwen3-32b", ...)`) on a (data 4, model 2)
     grid of eight gloo ranks sharing the card: span GRID_SPAN
     (hier-RVH, lane groups of 2), fsdp, scatter_grads and ZeRO-1
     (momentum, the pre point), bf16 compute, seq TP_SEQ, batch
     TP_BATCH, TP_STEPS steps, weights from SEED drawn a leaf at a time.
     It computes the function of its twin (2 lanes of 4 rows, Adasum,
     momentum: each lane group's two ranks take their exact token share
     of the lane), so step 1 is held to the twin by the twin rule; every
     rank keeps step 1's lane tree, and rank 0's combined tree (and
     CombineStats, where the run makes them) on the kernel arm is held
     against the plain arm's combine of the same lane tree
     (COMBINED_RTOL). Printed: per rank the GiB held of params and state
     beside the
     plan's `local_shapes`; init and step peaks a rank and their sum;
     step ms split into FSDP's all-gathers, the reduce-scatters, RVH's
     exchange, the model group's all-reduces (ms and MB), the dot sums
     and staging; rank 0's `block_dots` / `block_combine` launches
     (`phase13c_launches`); whether the leaves left whole agree
     bitwise across the ranks holding them. Then both kernels at RVH's
     round-0 half of the rank's part of the embedding
     (`phase13c_case`).
     (d) the model axis on the MoE family, in (c)'s rank processes after
     (c) frees its memory: mixtral-8x22b's own preset (d1) at full width,
     MIXTRAL_LAYERS layer, on a (data 2, model 4) grid (its experts cut
     on d_ff over the model axis, on E over the data axis), and
     moonshot-v1-16b-a3b's (d2) at MOONSHOT_LAYERS layers (the dense
     one and one MoE layer) on (c)'s grid, each through
     `TrainSession.from_config`, momentum, bf16 compute, no
     accumulation (held on the CPU). (d1)'s step 1 is held to a
     one-process twin of the same layer (its two lanes stacked, computed
     and saved before the ranks start) by the twin rule. Each run: held GiB
     = the plan's, init and step peaks a rank and summed under
     RANK_MEM_GIB, the leaves left whole bitwise across the ranks
     holding them (the router among them), step 1 again from the
     session's initial state bitwise; printed: the step split as in (c)
     with the MoE blocks' all-reduces on their own (ms and MB), rank 0's
     launches (`phase13d_launches`) and the dropped pairs. Then both
     kernels at RVH's round-0 half of a rank's part of one of mixtral's
     expert stacks, in bf16, with device times (`phase13d_case`).
     (e) every combiner on shards, in (c)'s rank processes after (d):
     (c)'s model through `TrainSession.from_config` of qwen3-32b's
     preset, one step each, and in COMB_REPEAT's runs step 1 again from
     the session's initial state. (e1) combine="sum" (the paper's baseline) and (e2)
     "adascale" in (c)'s regime, each held to a one-process twin with
     the same combiner (the two lanes stacked, computed before the ranks
     start) by the twin rule; (e3) adasum-linear with adam at the post
     point (ZeRO-1 state on the lane groups' parts); (e4) the Adasum
     tree whole-model (per_layer=False) with fsdp + scatter_grads on a
     (data 8, model 1) grid at span COMB_TREE_SPAN, the one run here
     that launches the two Adasum kernels, its combined tree on rank 0
     held against its plain arm's combine of the same lane tree (bf16
     buffers: COMBINED_BF16_RTOL). Each: held
     GiB = the plan's, init and step peaks summed under RANK_MEM_GIB,
     the leaves left whole bitwise across the ranks holding them, a
     repeat bitwise; printed: the step split as in (c) (the combiner's
     exchange and all-reduce, the dot and moment sums), staged GB and
     rank 0's launches (`phase13e_launches`).
     `--model-axis-only` builds the kernels and runs this phase alone.

The line before the last is the kernels JSON (block_dots and
block_combine rows also carry their phase-6 launches on rank 0 of each
run, `rvh_launches`, and their ms on the round-0 half, `rvh_half_ms`; every
row its launches inside phase 7, `phase7_launches`; the attention rows
their launches inside phase 8, `phase8_launches`; the Adasum rows theirs
inside phase 9, `phase9_launches`; every row its launches inside phase
10, `phase10_launches`, phase 11, `phase11_launches`, phase 12,
`phase12_launches`, and phase 13, `phase13_launches` ((c)'s and
(e4)'s rank 0, (b)'s padded run), with its case at phase 13's shapes,
`phase13_case`; the Adasum rows also each (e) run's rank-0 launches,
`phase13e_launches`), the
last line {"ok": true, "device": {...}}. Longer records go to
chiprun_out/chip_smoke.json. fp32 matmuls run in full fp32: TF32 is
switched off for cuBLAS and cuDNN.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TFLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM dense peaks
HBM_BYTES_S = 3.35e12
# kernel vs plain: both round the output once to bf16 (|out| <= ~4, so
# 2^-8 * 4 ~ 0.016) and P to bf16 before P.V (the kernels round
# unnormalised P, the plain path normalised P); fp32 differs only in
# summation order
KERNEL_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
# logits of the 8-layer bf16 model, kernel path vs plain path: unit-scale
# logits after bf16 matmuls in every layer, where the two paths round P
# and sum P.V differently, move by a few 1e-2; a masking or
# indexing fault moves them by O(1)
LOGIT_TOL = 0.25
# every attention case also against an fp32 run of the plain version on
# the same inputs: the kernel's error there may be at most ERR32_FACTOR
# times the plain bf16 version's own error plus ERR32_SLACK (both round
# the output once to bf16 and P before P.V)
ERR32_FACTOR = 2.0
ERR32_SLACK = 2e-3
LAYERS = 8      # of qwen3-32b's 64: 5.5 B params, 11 GB of bf16 weights
SEED = 0
# block_dots against its fp32 plain version: the two sum the same fp32
# products in another order (per-thread strided partials vs PyTorch's
# reduction tree), ~sqrt(block) * 2^-24 relative; each triple's error is
# taken relative to sqrt(a.a * b.b), the scale that bounds a.b
DOTS_RTOL = 1e-5
# block_combine against combine_fp32_ref, in ulps of the output dtype at
# the scale |s1*a| + |s2*b|: the kernel rounds s2*b and then one fma, the
# plain version rounds both products and the sum; a bf16 output can then
# land one bf16 ulp apart
COMBINE_ULPS = 2
EPS_OF = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}
TRAIN_LAYERS = 1   # of gemma-7b's 28: 1.063 B params, 4.25 GB of fp32
                   # weights (depth cut for the script's time limit)
TRAIN_RUNS = (("momentum", 4), ("adam", 2))      # (optimizer, span)
# params after one step, kernel arms vs plain arms on the card: the two
# differ in the dots' summation order and the combine's rounding (~1e-7
# relative on an update of lr=1e-3 times the combined gradient), which can
# still flip the rounding of p + delta: one ulp of a unit-scale fp32
# param is 1.2e-7
TRAIN_PARAM_TOL = 1e-6
# the combine's output (step 1, kernel arms vs plain arms, same input
# lanes), leaf by leaf relative to the leaf's largest element, and each
# CombineStats level triple relative to its largest entry: the dots'
# summation order moves the Adasum scalars by ~1e-7 relative and each
# level's combine rounds once more (fp32 ulp 6e-8), over at most two
# levels; a pair or block read from the wrong place moves them by O(1)
COMBINED_RTOL = 1e-5
# the same on bf16 buffers (phase 13 (e4)'s lane gradients): each RVH
# round rounds its output to bf16 in both arms, the plain arm also its
# scalars (the reference's rule without its kernels); one bf16 ulp of a
# leaf's largest element is at most 2^-7 of it, a round's a straddled
# rounding boundary, over (e4)'s two rounds
COMBINED_BF16_RTOL = 2 * 2.0 ** -7


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


def _device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one fn() call in ms, without the host: `calls`
    calls captured in one CUDA graph, the graph replayed `replays` times
    (CUDA events around each replay), the median replay over `calls`.
    `_time_ms` times a call with the host work of its launch; for a call
    of tens of microseconds that is most of it, and it drifts with the
    host, so kernel and yardstick are also compared by this time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return statistics.median(times)


def _sdpa(q, k, v, mask=None, is_causal=False):
    """One library attention call on [B,H,T,Dh] q and [B,KV,S,Dh] k/v."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          is_causal=is_causal,
                                          enable_gqa=True)


# ------------------------------------------------------------ kernel phase
def _scale_check(out, ref, ref32, late_rows: bool = False) -> dict:
    """The kernel's error against an fp32 run of the plain version on the
    same (working-dtype-valued) inputs, held to ERR32_FACTOR times the
    plain working-dtype version's own error against that run plus
    ERR32_SLACK: the absolute KERNEL_TOL is loose beside outputs of
    typical size ~0.05, this check scales with what the dtype allows.
    With late_rows ([B, T, ...] outputs), the same check again over the
    last half of the query rows alone: causal rows near the start attend
    few keys and have outputs of order 1, which set the whole-tensor
    limit; a fault in the late rows (the causal frontier of the last
    tiles) is held to the limit those rows themselves allow."""
    def errs(a, b, c):
        err = (a.float() - c).abs().max().item()
        limit = (ERR32_FACTOR * (b.float() - c).abs().max().item()
                 + ERR32_SLACK)
        return err, limit
    err32, lim32 = errs(out, ref, ref32)
    res = {"err32": err32, "err32_limit": lim32, "err32_ok": err32 <= lim32}
    if late_rows:
        h = out.shape[1] // 2
        late, late_lim = errs(out[:, h:], ref[:, h:], ref32[:, h:])
        res.update(late_err32=late, late_err32_limit=late_lim,
                   err32_ok=res["err32_ok"] and late <= late_lim)
    return res


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
    ref32 = FA.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = _scale_check(out, ref, ref32, late_rows=True)
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
    # library yardstick: SDPA on its fused backends where it has the
    # mask (plain causal; q_offset = S - T is the lower-right causal
    # mask), a dense bool mask only for the window
    from torch.nn.attention.bias import causal_lower_right
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    plain_causal = causal and not window and q_offset == 0 and T == S
    if plain_causal or not (causal or window):
        mask = None
    elif causal and not window and q_offset == S - T:
        mask = causal_lower_right(T, S)
    else:
        mask = m

    def kernel():
        return FA.flash_attention(q, k, v, **kw)

    def library():
        return _sdpa(qt, kt, vt, mask, plain_causal)
    lib_out = library()            # the yardstick computes the same function
    lib_err = (lib_out.transpose(1, 2).float() - ref32).abs().max().item()
    del ref32, lib_out
    return {
        "kernel": "flash_attention", "case": name, "dtype": dtype,
        "shape": dict(B=B, T=T, S=S, H=H, KV=KV, Dh=Dh, causal=causal,
                      window=window, q_offset=q_offset),
        "max_abs_err": err, "tol": KERNEL_TOL[dtype], **scale,
        "ok": finite and err <= KERNEL_TOL[dtype] and scale["err32_ok"]
        and lib_err <= KERNEL_TOL[dtype],
        "library_err32": lib_err,
        "ms": _time_ms(kernel),
        "plain_ms": _time_ms(lambda: FA.flash_attention_ref(q, k, v, **kw),
                             iters=5, warmup=1),
        "library_ms": _time_ms(library),
        "device_ms": _device_ms(kernel),
        "library_device_ms": _device_ms(library),
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
    again = FA.paged_decode_attention(q, kp, vp, table, posv,
                                      rolling=rolling)
    ref = FA.paged_decode_attention_ref(q, kp, vp, table, posv,
                                        rolling=rolling)
    ref32 = FA.paged_decode_attention_ref(q.float(), kp.float(), vp.float(),
                                          table, posv, rolling=rolling)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = _scale_check(out, ref, ref32)
    bitwise = torch.equal(out, again)
    finite = bool(torch.isfinite(out.float()).all())
    splits, pps = FA.decode_plan(B, KV, P, FA._sm_count(q.device))
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

    def kernel():
        return FA.paged_decode_attention(q, kp, vp, table, posv,
                                         rolling=rolling)

    def library():
        return _sdpa(q4, kf, vf, mask)
    lib_err = (library()[:, :, 0].float() - ref32).abs().max().item()
    del ref32
    return {
        "kernel": "paged_decode_attention", "case": name, "dtype": dtype,
        "shape": dict(B=B, pages_per_slot=P, page_size=ps, H=H, KV=KV,
                      Dh=Dh, rolling=rolling, pos=list(pos),
                      free_slots=list(free_slots)),
        "splits": splits, "pages_per_split": pps, "bitwise_repeat": bitwise,
        "max_abs_err": err, "tol": KERNEL_TOL[dtype], **scale,
        "ok": finite and bitwise and err <= KERNEL_TOL[dtype]
        and scale["err32_ok"] and lib_err <= KERNEL_TOL[dtype],
        "library_err32": lib_err,
        "ms": _time_ms(kernel),
        "plain_ms": _time_ms(lambda: FA.paged_decode_attention_ref(
            q, kp, vp, table, posv, rolling=rolling)),
        "library_ms": _time_ms(library),
        "device_ms": _device_ms(kernel),
        "library_device_ms": _device_ms(library),
        "bound_ms": 1e3 * max(t_flop, t_byte),
        "bound_by": "operations" if t_flop >= t_byte else "bytes",
    }


def _adasum_pair(n, block, dtype, seed, segments=1, pairs=1, flat=False):
    """`pairs` lane pairs of a bucket buffer [2 * pairs, n] on the card,
    read in place as [pairs, n] row views with row stride 2n (how a tree
    level reads its pairs), plus fp32 per-block scalars in [0.5, 1.5],
    pair-major. With segments > 1 every segment gets its own scale, as
    the leaves of a bucket do. flat=True (one pair): the two 1-D halves
    of a [2n] round buffer, as an RVH round hands them over (`buf[:n]`,
    a view of the bucket, and the received half)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn(2 * pairs, n, generator=g, device="cuda")
    if segments > 1:
        scale = torch.rand(segments, generator=g, device="cuda") * 4 + 0.01
        seg = torch.arange(n, device="cuda") * segments // n
        buf *= scale[seg]
    buf = buf.to(getattr(torch, dtype))
    y = buf.view(pairs, 2, n)
    nblk = pairs * (n // block)
    s1 = torch.rand(nblk, generator=g, device="cuda") + 0.5
    s2 = torch.rand(nblk, generator=g, device="cuda") + 0.5
    if flat:
        half = buf.view(-1)
        return buf, half[:n], half[n:], s1, s2
    return buf, y[:, 0], y[:, 1], s1, s2


def _adasum_case(name, n, block, dtype="float32", segments=1, seed=2,
                 pairs=1, flat=False, device=False):
    """block_dots and block_combine on `pairs` lane pairs of n elements
    each (flat: RVH's two 1-D halves); two result rows. Each pair row is
    held to the plain versions on its own (a[r] is a unit-stride view: no
    copy). `device`: each row also gives the kernel's and the library
    call's device time alone (`_device_ms`)."""
    import torch
    from repro_torch.kernels import adasum as K
    buf, a, b, s1, s2 = _adasum_pair(n, block, dtype, seed, segments, pairs,
                                     flat)
    item = buf.element_size()
    nb = n // block                               # blocks a pair row
    dots = K.block_dots(a, b, block_elems=block)
    out = K.block_combine(a, b, s1, s2, block_elems=block)
    torch.cuda.synchronize()
    rows_of = (lambda t: [t]) if flat else list
    A, B, O = rows_of(a), rows_of(b), rows_of(out)
    assert not flat or a.data_ptr() == buf.data_ptr(), "the half was copied"
    d_abs = d_rel = c_abs = ulps = 0.0
    for r in range(pairs):
        rows = slice(r * nb, (r + 1) * nb)
        dref = K.block_dots_ref(A[r], B[r], block)
        scale = torch.stack([(dref[:, 1] * dref[:, 2]).sqrt(), dref[:, 1],
                             dref[:, 2]], dim=-1)
        d_err = (dots[rows] - dref).abs()
        d_abs = max(d_abs, d_err.max().item())
        d_rel = max(d_rel, (d_err / scale.clamp(min=1e-30)).max().item())
        cref = K.combine_fp32_ref(A[r], B[r], s1[rows], s2[rows], block)
        c_err = (O[r].float() - cref.float()).reshape(nb, block).abs()
        del cref
        mag = (s1[rows, None] * A[r].reshape(nb, block).float()).abs()
        mag += (s2[rows, None] * B[r].reshape(nb, block).float()).abs()
        c_abs = max(c_abs, c_err.max().item())
        ulps = max(ulps, (c_err / (EPS_OF[dtype] * mag).clamp(min=1e-30)
                          ).max().item())
        del c_err, mag
    finite = bool(torch.isfinite(dots).all() and torch.isfinite(out).all())
    del out, O
    # yardsticks: one library call on the same work (copies not timed)
    X = buf.view(pairs, 2, nb, block).transpose(1, 2).reshape(
        pairs * nb, 2, block)
    S = torch.stack([s1, s2], -1)[:, None, :].to(X.dtype)
    shape = dict(n=n, block_elems=block, rows=pairs,
                 row_stride=0 if flat else 2 * n, segments=segments)
    elems = pairs * n
    t_dots = 2 * elems * item / HBM_BYTES_S
    t_comb = (3 * elems * item + 8 * pairs * nb) / HBM_BYTES_S
    rows = [{
        "kernel": "block_dots", "case": name, "dtype": dtype, "shape": shape,
        "max_abs_err": d_abs, "err": d_rel, "tol": DOTS_RTOL,
        "ok": finite and d_rel <= DOTS_RTOL,
        "ms": _time_ms(lambda: K.block_dots(a, b, block_elems=block)),
        "plain_ms": _time_ms(lambda: K.block_dots(a, b, block_elems=block,
                                                  plain=True)),
        "library_ms": _time_ms(lambda: torch.bmm(X, X.transpose(1, 2))),
        # 6 FLOP a pair of elements against 2 * itemsize bytes
        "bound_ms": 1e3 * max(t_dots, 6 * elems / TFLOPS["float32"]),
        "bound_by": "bytes",
    }, {
        "kernel": "block_combine", "case": name, "dtype": dtype,
        "shape": shape, "max_abs_err": c_abs, "err": ulps,
        "tol": COMBINE_ULPS, "ok": finite and ulps <= COMBINE_ULPS,
        "ms": _time_ms(lambda: K.block_combine(a, b, s1, s2,
                                               block_elems=block)),
        "plain_ms": _time_ms(lambda: K.block_combine(
            a, b, s1, s2, block_elems=block, plain=True)),
        "library_ms": _time_ms(lambda: torch.bmm(S, X)),
        "bound_ms": 1e3 * max(t_comb, 3 * elems / TFLOPS["float32"]),
        "bound_by": "bytes",
    }]
    if device:
        for row, kern, lib in (
                (rows[0], lambda: K.block_dots(a, b, block_elems=block),
                 lambda: torch.bmm(X, X.transpose(1, 2))),
                (rows[1], lambda: K.block_combine(a, b, s1, s2,
                                                  block_elems=block),
                 lambda: torch.bmm(S, X))):
            row["device_ms"] = _device_ms(kern)
            row["library_device_ms"] = _device_ms(lib)
            torch.cuda.empty_cache()
    del X, S, buf, a, b, A, B, dots
    torch.cuda.empty_cache()
    return rows


def _adasum_refusal():
    """A shape the kernels do not take must raise before any launch."""
    import torch
    from repro_torch.kernels import adasum as K
    from repro_torch.kernels import build
    before = dict(build.LAUNCHES)
    a = torch.zeros(8192 + 256, device="cuda")
    for fn in (lambda: K.block_dots(a, a, block_elems=8192),
               lambda: K.block_combine(a, a, torch.ones(1, device="cuda"),
                                       torch.ones(1, device="cuda"),
                                       block_elems=8192)):
        try:
            fn()
        except ValueError:
            continue
        raise AssertionError("n not a multiple of the block was accepted")
    assert build.LAUNCHES == before, "a refused shape was counted"
    print("[smoke] adasum kernels refuse n % block_elems != 0: ok")


def _gemma_small_buckets():
    """(padded_len, block, segments) of the train phase's buckets of
    small leaves (block below 8192): the norms."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core import combine as C
    from repro_torch.core.fusion import Spec
    from repro_torch.models.transformer import param_spec
    cfg = dataclasses.replace(get_config("gemma-7b"), n_layers=TRAIN_LAYERS)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return Spec((2,) + tuple(node[0]), torch.float32)
    plan = C.fused_plan(T.leaves(walk(param_spec(cfg))), C.CombineConfig())
    return [(layout.padded_len, block, layout.num_segments)
            for _, layout, block, _ in plan if block < 8192]


def _split_edges(B, KV, P, ps):
    """pos 0, then positions on both sides of the first split boundaries
    of the decode planner at this shape (the last row of a split and the
    first row of the next)."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    splits, pps = FA.decode_plan(B, KV, P, FA._sm_count(
        torch.device("cuda")))
    edge = pps * ps
    return [0, edge - 1, edge, 2 * edge - 1][:B]


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
        # gemma-7b's serve widths (G=1, Dh=256) and a 64-wide head
        _flash_case("gemma_d256", 1, 1024, 1024, H=16, KV=16, Dh=256),
        _flash_case("d64", 2, 1024, 1024, H=32, KV=8, Dh=64),
        _decode_case("serve_tick", 4, 128, [964, 980, 1001, 990]),
        _decode_case("linear", 8, 64, mixed),
        _decode_case("rolling", 8, 64, mixed, rolling=True),
        _decode_case("trash_slots", 8, 64, mixed, free_slots=(1, 6)),
        _decode_case("fp32", 4, 8, [0, 40, 127, 300], dtype="float32",
                     H=8, KV=2),
        # split-K: one slot, every page live (many splits); a batch that
        # fills the card (one split); pos 0 and pos on both sides of a
        # split boundary; rolling past cap; gemma-7b's G=1, Dh=256
        _decode_case("b1_all_pages", 1, 128, [2047]),
        _decode_case("b32_one_split", 32, 16,
                     [(37 * i) % 256 for i in range(32)]),
        _decode_case("split_edges", 4, 128, _split_edges(4, 8, 128, 16)),
        _decode_case("rolling_wrap", 4, 128, [2048, 2100, 3071, 4095],
                     rolling=True),
        _decode_case("gemma_d256", 4, 128, [964, 980, 1001, 990], H=16,
                     KV=16, Dh=256),
        # the MoE presets' shapes in phase 11: mixtral's prefill of a
        # ~4,600-token prompt in window mode (H 48, KV 8, window 4096)
        # and its rolling decode over 256 pages a slot; moonshot's prefix
        # extend (H = KV = 16: a 64-token prefix, a 256-token tail bucket)
        _flash_case("mixtral_w4096", 1, 4600, 4600, window=4096, H=48,
                    KV=8),
        _flash_case("moonshot_ext", 2, 256, 320, q_offset=64, H=16, KV=16),
        _decode_case("mixtral_roll", 4, 256, [4615, 315, 532, 827],
                     rolling=True, H=48, KV=8),
        # hymba-1.5b's decode in phase 12: G = 25 / 5 = 5 (padded to 8
        # inside the kernel), Dh 64, rolling over its 1024-token window
        # (64 pages of 16), every slot past the window
        _decode_case("hymba_roll", 4, 64, [1100, 1300, 2047, 1500],
                     rolling=True, H=25, KV=5, Dh=64),
        # and phase 12 (b)'s serving shape: 16 pages a slot, rolling
        # mode before the window wraps (prompts of 48-64, 32 new tokens)
        _decode_case("hymba_serve", 4, 16, [48, 67, 81, 95], rolling=True,
                     H=25, KV=5, Dh=64),
    ]
    embed = 256_000 * 3072                 # gemma-7b's tied embedding
    cases += _adasum_case("embed_fp32", embed, 8192)     # main path first
    # the span-4 tree's level 0: two pairs of a [4, L] buffer (row stride
    # 2L), so pair 1's rows, blocks and scalars sit past offset 0
    cases += _adasum_case("embed_fp32_x2", embed, 8192, pairs=2)
    # RVH at world 4 (phase 6): round 0 dots and combines the bucket's
    # 1-D halves, round 1 its quarters
    cases += _adasum_case("rvh_half_w4", embed // 2, 8192, flat=True)
    cases += _adasum_case("rvh_quarter_w4", embed // 4, 8192, flat=True)
    cases += _adasum_case("embed_bf16", embed, 8192, "bfloat16")
    cases += _adasum_case("w_up", TRAIN_LAYERS * 3072 * 24576, 8192)
    for n, block, segs in _gemma_small_buckets():   # block_norms, final_norm
        cases += _adasum_case(f"norms_b{block}", n, block, segments=segs)
    cases += _adasum_case("granule256", 256 * 4096, 256)
    _adasum_refusal()
    print(f"{'kernel':24s} {'case':14s} {'err':>9s} {'tol':>7s} "
          f"{'err32':>9s} {'lim32':>9s} {'late32':>9s} {'latelim':>9s} "
          f"{'ms':>9s} {'plain_ms':>9s} {'lib_ms':>9s} {'bound_ms':>9s} "
          f"{'dev_ms':>9s} {'lib_dev':>9s}")
    for c in cases:
        e32 = (f"{c['err32']:9.2e} {c['err32_limit']:9.2e}" if "err32" in c
               else f"{'-':>9s} {'-':>9s}")
        late = (f"{c['late_err32']:9.2e} {c['late_err32_limit']:9.2e}"
                if "late_err32" in c else f"{'-':>9s} {'-':>9s}")
        dev = (f"{c['device_ms']:9.4f} {c['library_device_ms']:9.4f}"
               if "device_ms" in c else f"{'-':>9s} {'-':>9s}")
        print(f"{c['kernel']:24s} {c['case']:14s} "
              f"{c.get('err', c['max_abs_err']):9.2e} "
              f"{c['tol']:7.0e} {e32} {late} {c['ms']:9.4f} "
              f"{c['plain_ms']:9.4f} {c['library_ms']:9.4f} "
              f"{c['bound_ms']:9.4f} {dev} "
              f"{'ok' if c['ok'] else 'FAIL'}"
              + (f" splits={c['splits']} bitwise={c['bitwise_repeat']}"
                 if "splits" in c else ""))
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
    for name in ("flash_attention", "paged_decode_attention"):
        assert launches[name] > 0, f"{name} never launched on the main path"
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
    # phase 8 serves the same model, params and prompts
    return result, (cfg, model, params, prompts,
                    [h.tokens for h in handles])


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
                if "flash_wgmma_kernel" in k or "flash_fwd_kernel" in k
                or "paged_decode_" in k}
        out[name] = {"wall_ms": wall, "device_busy_ms": busy,
                     "idle_share": 1.0 - busy / wall,
                     "port_kernels_ms": sum(mine.values()), "top": top}
        print(f"[smoke] profile {name}: wall_ms={wall:.2f} "
              f"device_busy_ms={busy:.2f} idle_share={1 - busy / wall:.3f} "
              f"port_kernels_ms={sum(mine.values()):.2f} | {card}")
        for k, v in top:
            print(f"[smoke]   {v:9.3f} ms  {k[:100]}")
    return out


# ------------------------------------------------- serving extensions phase
SPEC_K = 4
# the reference benchmark's workload (benchmarks/serve_spec.py):
# (prompt tokens, generated tokens), 4 slots, arrivals 2 ticks apart
SPEC_WORKLOAD = [(12, 96), (17, 92), (9, 100), (14, 94)]
SPEC_STAGGER = 2
SPEC_ARRIVALS = ([1] + [0] * (SPEC_STAGGER - 1)) * len(SPEC_WORKLOAD)
# phase 8 (c): phase 4's six requests need ~62 pages of 16 rows each at
# the end (64 shared system-prompt rows), so half of full provisioning
# (257 of 513 pages) holds all four slots and never preempts; 180 pages
# fill up at admission with three requests, whose growth then preempts
# the youngest (page arithmetic of these prompt lengths, host-side only)
PREEMPT_PAGES = 180


def _agreement(a, b) -> dict:
    """Token streams a vs b (lists of lists): the share of positions
    equal, and each stream's first differing index (None if equal)."""
    n = sum(len(x) for x in a)
    eq = sum(int(x == y) for s, t in zip(a, b) for x, y in zip(s, t))
    first = [next((i for i, (x, y) in enumerate(zip(s, t)) if x != y), None)
             for s, t in zip(a, b)]
    return {"equal_share": eq / n, "first_divergence": first,
            "all_equal": a == b}


def _timed(fn):
    """(fn(), its wall seconds), the card synchronised on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _top2_gaps(x) -> list:
    """Per row of x [n,V]: top-1 minus top-2."""
    import torch
    v = torch.topk(x, 2, -1).values
    return (v[:, 0] - v[:, 1]).tolist()


def _first_tokens(a, b) -> dict:
    """Greedy tokens of two paths' logits a, b [n,V] (fp32): equal or
    not, the largest logit difference, the smallest top-1/top-2 gap of
    b, and the rows whose tokens differ although their gap is wider than
    twice that difference (rounding cannot explain those)."""
    diff = (a - b).abs().max().item()
    gaps = _top2_gaps(b)
    ta, tb = a.argmax(-1).tolist(), b.argmax(-1).tolist()
    return {"tokens": [ta, tb], "equal": ta == tb,
            "max_abs_logit_diff": diff, "min_top2_gap": min(gaps),
            "unexplained": [i for i, (x, y) in enumerate(zip(ta, tb))
                            if x != y and gaps[i] > 2 * diff]}


def _launch_count(fn) -> dict:
    """fn() under torch.profiler: the kernels it launched (the runtime's
    launch calls) and the device operations the card ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches = device_ops = 0
    for e in prof.key_averages():
        if e.key.startswith("cudaLaunchKernel"):
            launches += e.count
        elif getattr(e, "device_type", None) is not None \
                and "CUDA" in str(e.device_type):
            device_ops += e.count
    return {"kernel_launches": launches, "device_ops": device_ops}


def _one_slot_cache(model, params, prompt, cap):
    """A one-slot paged cache of capacity `cap` holding `prompt`'s
    prefill rows; returns (last-position logits [1,V] fp32, cache)."""
    import numpy as np
    import torch
    from repro_torch.engine.serving.slots import paged_insert_rows
    toks = torch.tensor(np.asarray(prompt, np.int32)[None], device="cuda")
    lens = torch.tensor([len(prompt)], dtype=torch.int32, device="cuda")
    logits, rows = model.prefill_cache(params, toks, lens, cap)
    pps = cap // 16
    cache = model.init_cache(params, 1, cap, paged=(16, pps + 1))
    tables = torch.arange(1, pps + 1, device="cuda",
                          dtype=torch.int32)[None]
    paged_insert_rows(cache, rows, torch.zeros(1, device="cuda",
                                               dtype=torch.long),
                      tables, tables)
    return logits[:, -1].float(), cache


def _divergence_margins(model, params, prompts, a, b, cap) -> list:
    """For each pair of greedy streams a, b that differ, at their first
    differing index i: how much `model`'s logits at that position (one
    slot: prefill, then one-row paged decodes of the common tokens
    a[:i]) prefer a[i] over b[i]. A divergence that rounding explains has
    a margin within the paths' logit difference (LOGIT_TOL); a fault in
    a path (a row read from the wrong place) gives O(1)."""
    import torch
    out = []
    for p, s, t in zip(prompts, a, b):
        i = next((j for j, (x, y) in enumerate(zip(s, t)) if x != y), None)
        if i is None:
            continue
        lg, cache = _one_slot_cache(model, params, p, cap)
        for j in range(i):
            step, cache = model.decode_step(params, torch.tensor(
                [[s[j]]], dtype=torch.int32, device="cuda"), cache)
            lg = step[:, -1].float()
        out.append(lg[0, s[i]].item() - lg[0, t[i]].item())
        del cache
    return out


def _sliced_target(params, layers):
    """benchmarks/serve_spec.py's construction: blocks 1.. get attention
    `wo` and the MLP down-projection zeroed (each a residual
    passthrough), so the target computes exactly its first block; the
    draft is that block (views of the same tensors)."""
    import torch
    mask = torch.zeros(layers, 1, 1, device="cuda",
                       dtype=params["blocks"]["attn"]["wo"].dtype)
    mask[0] = 1
    blocks = dict(params["blocks"])
    blocks["attn"] = dict(blocks["attn"], wo=blocks["attn"]["wo"] * mask)
    blocks["mlp"] = dict(blocks["mlp"], w_down=blocks["mlp"]["w_down"] * mask)
    target = dict(params, blocks=blocks)

    def first(node):
        return ({k: first(v) for k, v in node.items()}
                if isinstance(node, dict) else node[:1])
    return target, dict(target, blocks=first(blocks))


def ext_phase(card: str, cfg, model, params, prompts, served):
    """Phase 8: the serving extensions on phase 4's qwen3-32b (full
    width, LAYERS deep, bf16 random weights from SEED), its prompts and
    `served`, its greedy tokens."""
    import numpy as np
    import torch
    from repro_torch.engine import (EngineConfig, GenerationRequest,
                                    ServeEngine, ServeSession)
    from repro_torch.engine.serving.engine import (_make_parallel_prefill,
                                                   _make_scan_prefill)
    from repro_torch.engine.serving.slots import (insert_rows_at,
                                                  paged_insert_rows)
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    plain = build_model(cfg, compute_dtype=torch.bfloat16,
                        param_dtype=torch.bfloat16, attn_impl="plain")
    V = cfg.vocab_size
    base = dict(max_slots=4, max_len=2048, page_size=16,
                param_dtype="bfloat16")
    arrivals = [1, 2, 1, 1, 1]                  # phase 4's
    out = {"card": card}
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    build.reset_launches()

    # (a) dense vs paged: phase 4's requests without prefix sharing (the
    # dense layout has none), so under plain attention both layouts run
    # the same shapes and the same arithmetic
    runs = {}
    for tag, m, layout in (("dense_plain", plain, "dense"),
                           ("paged_plain", plain, "paged"),
                           ("dense_kernel", model, "dense"),
                           ("paged_kernel", model, "paged")):
        eng = ServeEngine(EngineConfig(kv_layout=layout, prefix_sharing=False,
                                       **base), m, params)
        hs, wall = _timed(lambda: _greedy(eng, prompts, arrivals, 32))
        tp = eng.throughput()
        assert tp["completed"] == 6 and eng.leaked_pages() == 0, tp
        runs[tag] = {"tokens": [h.tokens for h in hs],
                     "decode_tick_ms": tp["decode_tick_ms_mean"],
                     "prefill_ms": tp["prefill_ms_mean"], "wall_s": wall,
                     "tok_s": tp["tok_s"]}
        del eng
    plain_eq = _agreement(runs["paged_plain"]["tokens"],
                          runs["dense_plain"]["tokens"])
    kern_eq = _agreement(runs["paged_kernel"]["tokens"],
                         runs["dense_plain"]["tokens"])
    # the first step's logits (prefill, then one decode of the same
    # token): paged kernel path vs dense plain path, two prompts
    n = 2
    toks = np.zeros((n, 1024), np.int32)
    lens = np.asarray([len(p) for p in prompts[:n]], np.int32)
    for i in range(n):
        toks[i, :lens[i]] = prompts[i]
    toks_t, lens_t = torch.from_numpy(toks).cuda(), \
        torch.from_numpy(lens).cuda()
    first, nxt = {}, None
    for tag, m in (("kernel_paged", model), ("plain_dense", plain)):
        logits, rows = m.prefill_cache(params, toks_t, lens_t, 2048)
        logits = logits[:, -1].float()
        if nxt is None:
            nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        slots = torch.arange(n, device="cuda")
        if tag == "kernel_paged":
            pps = 2048 // 16
            cache = m.init_cache(params, n, 2048, paged=(16, n * pps + 1))
            tables = (torch.arange(n * pps, device="cuda", dtype=torch.int32)
                      .reshape(n, pps) + 1)
            paged_insert_rows(cache, rows, slots, tables, tables)
        else:
            cache = m.init_cache(params, n, 2048, per_slot=True)
            insert_rows_at(cache, rows, slots)
        dl, _ = m.decode_step(params, nxt, cache)
        first[tag] = (logits, dl[:, -1].float())
        del cache, rows
    kern_eq["margins"] = _divergence_margins(
        model, params, prompts, runs["paged_kernel"]["tokens"],
        runs["dense_plain"]["tokens"], 2048)
    errs = {step: (first["kernel_paged"][i] - first["plain_dense"][i])
            .abs().max().item() for i, step in enumerate(("prefill",
                                                          "decode"))}
    out["a_dense_vs_paged"] = {
        "prefix_sharing": False,
        "plain_paged_vs_plain_dense": plain_eq,
        "kernel_paged_vs_plain_dense": kern_eq,
        "first_step_logit_err": errs, "tol": LOGIT_TOL,
        **{f"{k}_ms": {t: r[f"{k}_ms"] for t, r in runs.items()}
           for k in ("decode_tick", "prefill")},
        "tok_s": {t: r["tok_s"] for t, r in runs.items()}}
    print(f"[smoke] ext (a) dense vs paged, plain attention: tokens equal="
          f"{plain_eq['all_equal']}; kernel paged vs plain dense: equal "
          f"share={kern_eq['equal_share']:.3f} first divergence="
          f"{kern_eq['first_divergence']} margins="
          f"{[round(m, 4) for m in kern_eq['margins']]}; first-step logits "
          f"max_abs "
          f"prefill={errs['prefill']:.4f} decode={errs['decode']:.4f} (tol "
          f"{LOGIT_TOL}); decode_tick_ms " + " ".join(
              f"{t}={r['decode_tick_ms']:.2f}" for t, r in runs.items())
          + f" | {card}")
    assert plain_eq["all_equal"], "dense != paged under plain attention"
    assert max(errs.values()) <= LOGIT_TOL, errs
    assert all(abs(m) <= LOGIT_TOL for m in kern_eq["margins"]), kern_eq
    del runs, first
    _free()

    # (b) speculation, k=4, on the reference benchmark's workload
    target, dparams = _sliced_target(params, cfg.n_layers)
    rng = np.random.RandomState(SEED + 1)
    sprompts = [rng.randint(0, V, p) for p, _ in SPEC_WORKLOAD]
    sgen = [g for _, g in SPEC_WORKLOAD]
    scfg = dict(max_slots=4, page_size=16, param_dtype="bfloat16",
                max_len=max(p + g for p, g in SPEC_WORKLOAD) + 1 + SPEC_K)
    scap = EngineConfig(**scfg).serve_max_len()
    draft_cfg = {"n_layers": 1, "name": f"{cfg.name}-slice"}

    def spec_engine(k, tgt, draft=None, spec=None, **kw):
        return ServeEngine(EngineConfig(speculation_k=k, draft_config=spec,
                                        **scfg, **kw), model, tgt,
                           draft_params=draft)
    make = {"plain": lambda: spec_engine(0, target),
            "spec": lambda: spec_engine(SPEC_K, target, dparams, draft_cfg)}
    toks_b, accs = {}, []
    for tag in ("plain", "spec"):        # warm-up; tokens; acceptance a tick
        eng = make[tag]()
        if tag == "spec":
            verify = eng._verify

            def spy(*a, _e=eng, _v=verify):
                o = _v(*a)
                acc = o[2].tolist()
                accs.append({h.request.request_id: acc[s]
                             for s, h in _e.scheduler.active.items()})
                return o
            eng._verify = spy
        hs = _greedy(eng, sprompts, SPEC_ARRIVALS, sgen)
        toks_b[tag] = [h.tokens for h in hs]
    res = {}
    for tag in ("plain", "spec", "spec", "plain"):    # timed, in turns
        eng = make[tag]()
        hs, wall = _timed(lambda: _greedy(eng, sprompts, SPEC_ARRIVALS,
                                          sgen))
        tp = eng.throughput()
        assert tp["completed"] == 4 and eng.leaked_pages() == 0, tp
        r = res.setdefault(tag, {"wall_s": [], "tok_s": []})
        r["wall_s"].append(wall)
        r["tok_s"].append(tp["generated_tokens"] / wall)
        r["dispatches_per_token"] = tp["decode_steps"] / tp[
            "generated_tokens"]
        r["decode_tick_ms"] = tp["decode_tick_ms_mean"]
        if tag == "spec":
            r.update(acceptance=tp["spec_acceptance_rate"],
                     spec_ticks=tp["spec_ticks"],
                     draft_prefills=tp["draft_prefills"])
            spec = eng
    # the draft's launches in one tick: one propose at the workload's
    # positions, profiled
    tok1 = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    pos1 = torch.tensor([p for p, _ in SPEC_WORKLOAD], dtype=torch.int32,
                        device="cuda")
    res["spec"]["draft_tick"] = _launch_count(lambda: spec._propose(
        spec._draft_params, tok1, spec._draft_cache, pos1))
    del eng, spec
    # the k+1 trap: a request's acceptance on the tick after one of its
    # full-accept ticks (a k-step draft leaves a hole there)
    after_full = [nxt[r] for cur, nxt in zip(accs, accs[1:])
                  for r, a in cur.items() if a == SPEC_K and r in nxt]
    # the first tick of request 0: verify row t against a plain decode at
    # pos + t over the same tokens (its plain greedy continuation)
    spec_toks = torch.tensor([toks_b["plain"][0][:SPEC_K + 1]],
                             dtype=torch.int32, device="cuda")
    _, cache = _one_slot_cache(model, target, sprompts[0], scap)
    vlog, _ = model.verify_step(target, spec_toks, cache)
    _, cache = _one_slot_cache(model, target, sprompts[0], scap)
    dlog = []
    for t in range(SPEC_K + 1):
        lg, cache = model.decode_step(target, spec_toks[:, t:t + 1], cache)
        dlog.append(lg[0, -1].float())
    vd = _first_tokens(vlog[0].float(), torch.stack(dlog))
    del cache, vlog, dlog
    spec_eq = _agreement(toks_b["spec"], toks_b["plain"])
    spec_eq["margins"] = _divergence_margins(model, target, sprompts,
                                             toks_b["plain"], toks_b["spec"],
                                             scap)
    # the auto-derived draft: quarter depth, random weights
    eng = spec_engine(SPEC_K, params)
    hs, wall = _timed(lambda: _greedy(eng, sprompts, SPEC_ARRIVALS, sgen))
    tp = eng.throughput()
    assert tp["completed"] == 4, tp
    derived = {"wall_s": wall, "tok_s": tp["generated_tokens"] / wall,
               "acceptance": tp["spec_acceptance_rate"],
               "dispatches_per_token": tp["dispatches_per_token"],
               "spec_ticks": tp["spec_ticks"],
               "draft_layers": eng._draft_model.cfg.n_layers,
               "draft_tick": _launch_count(lambda: eng._propose(
                   eng._draft_params, tok1, eng._draft_cache, pos1))}
    del eng
    for r in res.values():
        r["tok_s_mean"] = statistics.mean(r["tok_s"])
        r["wall_s_mean"] = statistics.mean(r["wall_s"])
    rs, rp = res["spec"], res["plain"]
    out["b_speculation"] = {
        "k": SPEC_K, "workload": SPEC_WORKLOAD, "stagger": SPEC_STAGGER,
        "plain": rp, "spec_sliced": rs, "spec_derived": derived,
        "spec_vs_plain_tokens": spec_eq,
        "accept_after_full_accept": after_full,
        "first_tick_verify_vs_decode": vd}
    print(f"[smoke] ext (b) k={SPEC_K}: plain tok_s={rp['tok_s_mean']:.1f} "
          f"wall_s={rp['wall_s_mean']:.3f} dispatches/token="
          f"{rp['dispatches_per_token']:.3f}; sliced draft tok_s="
          f"{rs['tok_s_mean']:.1f} wall_s={rs['wall_s_mean']:.3f} "
          f"dispatches/token={rs['dispatches_per_token']:.3f} acceptance="
          f"{rs['acceptance']:.3f} spec_ticks={rs['spec_ticks']} draft "
          f"launches/tick={rs['draft_tick']['kernel_launches']}; derived "
          f"draft ({derived['draft_layers']} layers) tok_s="
          f"{derived['tok_s']:.1f} acceptance={derived['acceptance']:.3f} "
          f"dispatches/token={derived['dispatches_per_token']:.3f} "
          f"launches/tick={derived['draft_tick']['kernel_launches']}; spec "
          f"tokens equal to plain share={spec_eq['equal_share']:.3f} first "
          f"divergence={spec_eq['first_divergence']} margins="
          f"{[round(m, 4) for m in spec_eq['margins']]}; "
          f"verify vs decode, first tick: logits max_abs="
          f"{vd['max_abs_logit_diff']:.4f} min top-2 gap="
          f"{vd['min_top2_gap']:.4f} | {card}")
    assert rs["acceptance"] > 0.9, rs
    assert all(abs(m) <= LOGIT_TOL for m in spec_eq["margins"]), spec_eq
    assert after_full and statistics.mean(
        min(a, 1) for a in after_full) > 0.9, after_full

    # (c) recompute preemption under a short pool, phase 4's requests
    eng = ServeEngine(EngineConfig(kv_pages=PREEMPT_PAGES, **base), model,
                      params)
    hs, wall = _timed(lambda: _greedy(eng, prompts, arrivals, 32))
    tp = eng.throughput()
    assert tp["completed"] == 6 and tp["preemptions"] > 0, tp
    eng.flush_prefix()
    assert eng.leaked_pages() == 0 and eng._pool.pages_used == 0
    pre_eq = _agreement([h.tokens for h in hs], served)
    pre_eq["margins"] = _divergence_margins(model, params, prompts, served,
                                            [h.tokens for h in hs], 2048)
    out["c_preemption"] = {"kv_pages": PREEMPT_PAGES, "full": 4 * 128 + 1,
                           "preemptions": tp["preemptions"],
                           "retries": tp["retries"],
                           "prefill_calls": tp["prefill_calls"],
                           "wall_s": wall, "tok_s": tp["tok_s"],
                           "vs_phase4": pre_eq}
    print(f"[smoke] ext (c) kv_pages={PREEMPT_PAGES} of {4 * 128 + 1}: "
          f"preemptions={tp['preemptions']} completed={tp['completed']} "
          f"leaked=0; tokens equal to phase 4 (full provisioning) share="
          f"{pre_eq['equal_share']:.3f} first divergence="
          f"{pre_eq['first_divergence']} margins="
          f"{[round(m, 4) for m in pre_eq['margins']]} | {card}")
    assert all(abs(m) <= LOGIT_TOL for m in pre_eq["margins"]), pre_eq
    del eng, hs

    # (d) resilience: deadlines, drain, the ladder
    eng = ServeEngine(EngineConfig(**base), model, params)
    kill = _greedy(eng, prompts[:2], [2], 32, deadline_s=0.005)
    assert all(h.failed and h.finish_reason == "deadline" for h in kill)
    assert eng.stats["deadline_kills"] == 2
    hs = [eng.submit(GenerationRequest(p, max_new_tokens=8))
          for p in prompts]
    eng.step()                                 # four admitted, two queued
    eng.request_drain()
    eng.drain()
    reasons = [h.finish_reason for h in hs]
    assert reasons.count("drained") == 2 and reasons.count("length") == 4
    eng.flush_prefix()
    assert eng.leaked_pages() == 0 and eng._pool.pages_used == 0
    del eng
    # the ladder: speculation on, an arena of half full provisioning
    ladder_pages = 4 * (scap // 16) // 2 + 1
    eng = spec_engine(SPEC_K, target, dparams, draft_cfg,
                      pressure_ladder=True, kv_pages=ladder_pages)
    ticks = []
    tick = eng._decode_tick

    def watch():
        before = eng.stats["spec_ticks"]
        tick()
        ticks.append((eng._ladder.level, eng.stats["spec_ticks"] - before))
    eng._decode_tick = watch
    _greedy(eng, sprompts, SPEC_ARRIVALS, sgen)
    tp = eng.throughput()
    eng.flush_prefix()
    shed = [k for lv, k in ticks if lv >= 1]
    out["d_resilience"] = {
        "deadline_kills": 2, "drained": reasons.count("drained"),
        "ladder_kv_pages": ladder_pages,
        "ladder_max_level": max(lv for lv, _ in ticks),
        "ladder_changes": tp["degradation_changes"],
        "ticks_at_level_ge1": len(shed), "spec_ticks_at_level_ge1": sum(shed),
        "spec_ticks": tp["spec_ticks"], "preemptions": tp["preemptions"],
        "completed": tp["completed"]}
    print(f"[smoke] ext (d) deadline kills=2 (terminal), drained="
          f"{reasons.count('drained')}; ladder (kv_pages={ladder_pages} of "
          f"{4 * (scap // 16) + 1}, spec on) "
          f"max level={out['d_resilience']['ladder_max_level']}, "
          f"{len(shed)} ticks at level >= 1 with {sum(shed)} spec ticks "
          f"({tp['spec_ticks']} in all), preemptions={tp['preemptions']}; "
          f"no leaks | {card}")
    assert out["d_resilience"]["ladder_max_level"] >= 1 and sum(shed) == 0
    assert tp["completed"] == 4 and eng.leaked_pages() == 0 \
        and eng._pool.pages_used == 0
    del eng, target, dparams
    _free()

    # (e) scan prefill vs parallel prefill, plain attention: two prompts
    # (each request's own tokens, past the shared system prompt)
    short = [prompts[0][64:104], prompts[1][64:128]]
    toks = np.zeros((2, 64), np.int32)
    for i, p in enumerate(short):
        toks[i, :len(p)] = p
    tt = torch.from_numpy(toks).cuda()
    lt = torch.tensor([len(p) for p in short], dtype=torch.int32,
                      device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan_lg, _ = _make_scan_prefill(plain, 2048)(params, tt, lt)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    par_lg, _ = _make_parallel_prefill(plain, 2048)(params, tt, lt)
    e = _first_tokens(scan_lg, par_lg.float())
    e_tok = {}
    for mode in ("scan", "parallel"):
        eng = ServeEngine(EngineConfig(prefill_mode=mode,
                                       prefix_sharing=False, **base), plain,
                          params)
        e_tok[mode] = [h.tokens[0] for h in
                       _greedy(eng, short, [2], 1)]
        del eng
    out["e_scan_prefill"] = {**e, "engine_first_tokens": e_tok,
                             "scan_s": scan_s, "prompt_lens": [40, 64]}
    print(f"[smoke] ext (e) scan vs parallel prefill (40, 64 tokens), plain "
          f"attention: first tokens equal={e['equal']} {e['tokens']}; logits "
          f"max_abs={e['max_abs_logit_diff']:.4f} min top-2 gap="
          f"{e['min_top2_gap']:.4f}; engines {e_tok}; scan prefill "
          f"{scan_s * 1e3:.0f} ms | {card}")
    assert e["max_abs_logit_diff"] <= LOGIT_TOL and not e["unexplained"], e
    assert e_tok["scan"] == e["tokens"][0] and \
        e_tok["parallel"] == e["tokens"][1], e_tok

    # (f) the legacy ServeSession loop, one batch of 2, plain attention:
    # stepped (one token at a time, dense cache) vs fused (the engine)
    batch = np.stack([prompts[2][64:112], prompts[3][64:112]])
    sess = ServeSession(EngineConfig(prefix_sharing=False, **base), plain,
                        params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stepped = sess.generate(batch, 16, stepped_prefill=True).cpu().numpy()
    f_stepped_s = time.perf_counter() - t0
    fused = sess.generate(batch, 16).cpu().numpy()
    # the first step of each path on the shapes it runs: the stepped loop
    # on a cache of 48 + 16 + 1 rows, the engine's prefill on its bucket
    # (64) and capacity (128)
    bt = torch.from_numpy(batch.astype(np.int32)).cuda()
    cache = plain.init_cache(params, 2, 48 + 16 + 1)
    for t in range(48):
        slg, cache = plain.decode_step(params, bt[:, t:t + 1], cache)
    flg, _ = plain.prefill_cache(
        params, torch.nn.functional.pad(bt, (0, 16)),
        torch.full((2,), 48, dtype=torch.int32, device="cuda"), 128)
    f1 = _first_tokens(slg[:, -1].float(), flg[:, -1].float())
    f_eq = _agreement(stepped[:, 48:].tolist(), fused[:, 48:].tolist())
    del sess, cache
    out["f_legacy"] = {"stepped_vs_fused": f_eq, "first_step": f1,
                       "stepped_s": f_stepped_s}
    print(f"[smoke] ext (f) legacy ServeSession.generate, batch 2 x 48: "
          f"stepped vs fused tokens equal={f_eq['all_equal']} share="
          f"{f_eq['equal_share']:.3f} first divergence="
          f"{f_eq['first_divergence']}; first-step logits max_abs="
          f"{f1['max_abs_logit_diff']:.4f} min top-2 gap="
          f"{f1['min_top2_gap']:.4f}; stepped loop {f_stepped_s:.2f} s"
          f" | {card}")
    assert (stepped[:, :48] == batch).all() and (fused[:, :48] == batch).all()
    assert f1["max_abs_logit_diff"] <= LOGIT_TOL and not f1["unexplained"]
    assert [r[0] for r in stepped[:, 48:].tolist()] == f1["tokens"][0]
    assert [r[0] for r in fused[:, 48:].tolist()] == f1["tokens"][1]

    torch.cuda.synchronize()
    out["launches"] = dict(build.LAUNCHES)
    out["phase_s"] = time.perf_counter() - t_phase
    for name in ("flash_attention", "paged_decode_attention"):
        assert out["launches"][name] > 0, f"{name} never launched in phase 8"
    print(f"[smoke] ext launches={out['launches']} phase_s="
          f"{out['phase_s']:.1f} | {card}")
    print("SERVE_EXT " + json.dumps(out, default=str))
    return out


# ------------------------------------------------------------- train phase
class _CombineTimer:
    """Wraps every combiner `build_runtime` makes so each call is
    bracketed by CUDA events (the engine's own combiners, timed from
    outside). keep=True also keeps a copy of the first call's combined
    leaves and CombineStats levels in `kept`, on the host or on
    `keep_on`. keep_input=True keeps a host copy of the first call's
    input tree in `kept_input`."""

    def __init__(self, keep: bool = False, keep_on: str = "cpu",
                 keep_input: bool = False):
        self.events = []
        self.keep = keep
        self.keep_on = keep_on
        self.kept = None
        self.keep_input = keep_input
        self.kept_input = None

    def wrap(self, make):
        def make_timed(*args, **kwargs):
            fn = make(*args, **kwargs)

            def timed(stacked):
                import torch
                if self.keep_input and self.kept_input is None:
                    from repro_torch import tree as T
                    self.kept_input = T.map(
                        lambda x: x.to("cpu", copy=True), stacked)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(stacked)
                b.record()
                self.events.append((a, b))
                if self.keep and self.kept is None:
                    from repro_torch import tree as T
                    comb, stats = out if isinstance(out, tuple) \
                        else (out, None)
                    self.kept = (
                        [x.to(self.keep_on, copy=True)
                         for x in T.leaves(comb)],
                        None if stats is None else
                        stats["levels"].to(self.keep_on, copy=True))
                return out
            timed.combine_path = getattr(fn, "combine_path", "")
            return timed
        return make_timed

    def take_ms(self) -> float:
        import torch
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        self.events = []
        return ms


@contextlib.contextmanager
def _timing_combiners(timer):
    """Every combiner `build_runtime` makes in the block is wrapped by
    `timer` (None: left as is)."""
    from repro_torch.engine import build as engine_build
    make = engine_build.make_combiner
    if timer is not None:
        engine_build.make_combiner = timer.wrap(make)
    try:
        yield
    finally:
        engine_build.make_combiner = make


def _session(model, timer=None, combine_impl="kernel", *, device="cuda",
             comm=None, dist_backend=None, **fields):
    """`TrainSession.from_config` on gemma-7b at seq 512, global batch 8,
    64 MB buckets, weights from SEED on `device`; `fields` set the rest
    of the EngineConfig."""
    import torch
    from repro_torch.engine import EngineConfig, TrainSession
    cfg = EngineConfig(**{**dict(arch="gemma-7b", seq_len=512, global_batch=8,
                                 fusion_threshold_mb=64, steps=3,
                                 log_every=1), **fields})
    with _timing_combiners(timer):
        return TrainSession.from_config(
            cfg, model=model, device=device,
            generator=torch.Generator(device=device).manual_seed(SEED),
            callbacks=[], combine_impl=combine_impl, comm=comm,
            dist_backend=dist_backend)


def _warm_up() -> threading.Thread:
    """Start, on a thread of its own, what a process's first checkpointed
    backward on the card pays once (torch's lazy imports, cuBLAS's
    handles; ~13 s in a fresh process beside busy ranks), so that it
    overlaps work that leaves this thread waiting; join the thread
    before the first step. Raises there if it failed."""
    def run():
        try:
            import torch
            from torch.utils.checkpoint import checkpoint
            x = torch.randn(256, 256, device="cuda", dtype=torch.bfloat16,
                            requires_grad=True)
            checkpoint(lambda a: (a @ a).float().sum(), x,
                       use_reentrant=False).backward()
            torch.cuda.synchronize()
        except BaseException as e:       # re-raised by join()
            th.error = e
    th = threading.Thread(target=run, name="warm-up")
    th.error = None
    th.start()
    return th


def _join(th: threading.Thread) -> None:
    th.join()
    if th.error is not None:
        raise th.error


def _free():
    """Return the memory of what the caller just deleted to the card."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _step_once(model, optimizer, span, combine_impl="kernel", **fields):
    """Step 1 from fresh state; returns the params leaves and a copy of
    the combine's output on the card (leaves, CombineStats levels).
    `fields`: further EngineConfig fields (e.g. the arch)."""
    from repro_torch import tree as T
    timer = _CombineTimer(keep=True, keep_on="cuda")
    s = _session(model, timer, combine_impl, optimizer=optimizer, span=span,
                 backend="gspmd_tree", **fields)
    s.step(s.batch(0))
    params = T.leaves(s.state["params"])
    del s
    _free()
    return params, timer.kept


def _rel_err(got, want) -> float:
    """Largest |got - want| over the largest |want|, in fp64."""
    want = want.double()
    return ((got.double() - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


def _profile_step(session, card, optimizer, span):
    """A fourth step under torch.profiler: device busy time, idle share,
    the Adasum kernels' share and the top kernels by device time."""
    wall, kern = _profiled(lambda: session.step(session.batch(3)))
    busy = sum(kern.values())
    mine = sum(v for k, v in kern.items()
               if "block_dots_kernel" in k or "block_combine_kernel" in k)
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:10]
    print(f"[smoke] profile train {optimizer} span={span} step: wall_ms="
          f"{wall:.1f} device_busy_ms={busy:.1f} idle_share="
          f"{1 - busy / wall:.3f} adasum_kernels_ms={mine:.2f} | {card}")
    for k, v in top:
        print(f"[smoke]   {v:9.3f} ms  {k[:100]}")
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall, "adasum_kernels_ms": mine,
            "top": top}


def train_phase(card: str, profile: bool = False):
    import math
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.control.noise import STAT_KEYS
    from repro_torch.core import combine as C
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    full = get_config("gemma-7b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    print(f"[smoke] train model {cfg.name}: full width d_model={cfg.d_model}"
          f" heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim="
          f"{cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"tied={cfg.tie_embeddings}; depth cut {full.n_layers} -> "
          f"{TRAIN_LAYERS} layers; {cfg.param_count() / 1e9:.3f}B params in "
          f"fp32, bf16 compute, seq 512, global batch 8")
    model = build_model(cfg, compute_dtype=torch.bfloat16,
                        param_dtype=torch.float32)
    runs = {}
    for optimizer, span in TRAIN_RUNS:
        timer = _CombineTimer()
        torch.cuda.reset_peak_memory_stats()
        s = _session(model, timer, optimizer=optimizer, span=span,
                     backend="gspmd_tree")
        leaves = T.leaves(s.state["params"])
        plan = C.fused_plan([x.expand((span,) + tuple(x.shape))
                             for x in leaves], C.CombineConfig(
            fusion_threshold_mb=s.config.fusion_threshold_mb))
        levels = int(math.log2(span))
        per_step = len(plan) * levels
        p0 = [x.to("cpu", copy=True) for x in leaves]
        torch.cuda.synchronize()
        build.reset_launches()
        steps = []
        for step in range(3):
            t0 = time.perf_counter()
            m = s.step(s.batch(step))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            comb = timer.take_ms()
            steps.append({"step": step, "ms": ms, "combine_ms": comb,
                          "loss": m["loss"],
                          **{k: m[k] for k in STAT_KEYS}})
            if step == 0:      # kept on the host: no card memory
                sums1 = _checksums(s.state["params"])
                p1 = [x.to("cpu", copy=True)
                      for x in T.leaves(s.state["params"])]
                update = max((x - y).abs().max().item()
                             for x, y in zip(p1, p0))
                del p0
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        meta = s.runtime.combine_path, s.runtime.dopt.point
        prof = _profile_step(s, card, optimizer, span) if profile else None
        del s, leaves
        _free()
        for st in steps:
            bad = [k for k in ("loss",) + STAT_KEYS
                   if not math.isfinite(st[k])]
            assert not bad, f"{optimizer}: non-finite {bad} at {st}"
        for k in ("block_dots", "block_combine"):
            assert launches[k] == 3 * per_step, (
                f"{optimizer} span {span}: {k} launched {launches[k]} times,"
                f" expected {3 * per_step} ({len(plan)} buckets x {levels} "
                f"levels x 3 steps)")
        # step 1 again from fresh state: kernel path (bitwise) and the
        # plain arms on the card (combine output and stats within
        # COMBINED_RTOL, params within TRAIN_PARAM_TOL), compared on the
        # card now that the main session (and its peak) is gone
        p1 = [x.cuda() for x in p1]
        again, (g_kern, lv_kern) = _step_once(model, optimizer, span)
        bitwise = all(torch.equal(x, y) for x, y in zip(p1, again))
        del again
        _free()
        plain, (g_plain, lv_plain) = _step_once(model, optimizer, span,
                                                combine_impl="plain")
        err = max((x - y).abs().max().item() for x, y in zip(p1, plain))
        comb_err = max(_rel_err(x, y) for x, y in zip(g_kern, g_plain))
        stats_err = max(_rel_err(x, y) for x, y in zip(lv_kern, lv_plain))
        levels_kern = lv_kern.tolist()
        del plain, p1, g_kern, g_plain
        _free()
        steady = steps[1:]
        ms = statistics.mean(st["ms"] for st in steady)
        comb = statistics.mean(st["combine_ms"] for st in steady)
        run = {"optimizer": optimizer, "span": span, "point": meta[1],
               "combine_path": meta[0], "buckets": len(plan),
               "blocks": sorted({b for _, _, b, _ in plan}),
               "levels": levels, "launches": launches,
               "launches_per_step": per_step, "steps": steps,
               "step_ms_steady": ms, "combine_ms_steady": comb,
               "combine_share": comb / ms, "peak_mem_gib": peak / 2 ** 30,
               "bitwise_repeat": bitwise, "plain_max_abs_err": err,
               "plain_tol": TRAIN_PARAM_TOL, "update_max_abs": update,
               "combined_rel_err": comb_err, "stats_rel_err": stats_err,
               "combined_rtol": COMBINED_RTOL, "levels": levels_kern,
               "params_sums_step1": sums1, "profile": prof}
        runs[f"{optimizer}_span{span}"] = run
        print(f"[smoke] train {optimizer} span={span} point={meta[1]} "
              f"path={meta[0]} buckets={len(plan)} levels={levels} "
              f"launches={ {k: launches[k] for k in ('block_dots', 'block_combine')} } "
              f"losses={[round(st['loss'], 4) for st in steps]}")
        print(f"[smoke] train {optimizer} span={span}: step_ms="
              f"{[round(st['ms'], 1) for st in steps]} steady_ms={ms:.1f} "
              f"combine_ms={comb:.1f} combine_share={comb / ms:.3f} "
              f"peak_mem_gib={peak / 2 ** 30:.1f} lane_cos="
              f"{steps[-1]['lane_cos']:.4f} noise_scale="
              f"{steps[-1]['noise_scale']:.4g} | {card}")
        print(f"[smoke] train {optimizer} span={span}: step 1 repeated "
              f"bitwise_equal={bitwise}; kernel vs plain combine: output "
              f"rel_err={comb_err:.3e} stats rel_err={stats_err:.3e} (tol "
              f"{COMBINED_RTOL}), levels={levels_kern}; params "
              f"max_abs_err={err:.3e} (tol {TRAIN_PARAM_TOL}) against a "
              f"step-1 update of max {update:.3e}")
        assert bitwise, f"{optimizer}: step 1 is not bitwise repeatable"
        assert comb_err <= COMBINED_RTOL, (
            f"{optimizer}: combine output kernel vs plain {comb_err}")
        assert stats_err <= COMBINED_RTOL, (
            f"{optimizer}: CombineStats kernel vs plain {stats_err}")
        assert err <= TRAIN_PARAM_TOL, f"{optimizer}: kernel vs plain {err}"
        assert peak / 2 ** 30 <= 70, f"peak {peak / 2 ** 30:.1f} GiB > 70"
    return {"layers": TRAIN_LAYERS, "full_layers": full.n_layers,
            "runs": runs}


# ------------------------------------------------------------- ranks phase
# minicpm3-4b (hf openbmb/MiniCPM3-4B) at full width, RANK_LAYERS of its
# 62 layers: 250.7 M params, 1.00 GB fp32 (phase 9 (c)'s model). Until
# phase 13 (e) came this was gemma-7b at 1 of 28 layers (1.063 B, 4.25
# GB), whose gloo traffic took a quarter of the time limit; the paths the
# runs drive do not depend on the model
RANK_ARCH = "minicpm3-4b"
RANK_LAYERS = 1
# (tag, optimizer, world, wire compression, EngineConfig fields). (a): RVH
# at span == dp on four ranks (two rounds), momentum (pre-point ZeRO-1,
# RVH without its allgather) with fsdp — item 7a's run B; it also saves,
# restores and redoes its last step (phase 7 (d)). (b): adam at the post
# point, per-rank whole state, int8. (A): item 7a's run A: ZeRO-2 lane
# gradients, post-point ZeRO-1 in each lane group and FSDP params, with
# accumulation
RANK_RUNS = (
    ("a", "momentum", 4, "none", dict(span=0, backend="rvh", fsdp=True)),
    ("b", "adam", 2, "int8", {}),
    ("A", "adam", 4, "none", dict(span=2, backend="gspmd_tree", fsdp=True,
                                  scatter_grads=True, accum_steps=2)),
)
RANK_CKPT = "a"            # the run that checkpoints (phase 7 (d))
RANK_SYNTHETIC = ("a", "b")  # the runs that check RVH of random lanes and
                             # the checkpoint gather too
RANK_PLAIN = ("a", "b", "A")  # the runs that take step 1 on the plain arm
# the runs whose step 1 in fp32 compute is held against one process under
# --witness: (A), whose lane gradients (ZeRO-2), state (ZeRO-1) and params
# are all sharded, so that its step with whole params still shards the
# rest. Not in the whole run: it costs ~1 min of the time limit
RANK_WITNESS = ("A",)
# besides its own step with the params whole, the sharded run whose peak
# must stay below another's (its tag): (A) below (b), adam at world 2
# with whole params, whole lane gradients and per-rank whole state
SHARD_BELOW = {"A": "b"}
RANK_BATCH = 8     # global batch: 2 rows a rank at world 4, 4 at world 2
RANK_STEPS = 1     # the main path's steps (one, for the script's time
                   # limit); each run's repeat, with warm buffers, is
                   # timed as its steady step. The checkpointing run
                   # saves before its last and redoes it (phase 7 (d))
RANK_MEM_GIB = 72  # the ranks' summed peak allocation may not pass this
RANK_TIMEOUT_S = 420
# a sharded run's step-1 params against (1) the same step on the same
# ranks with the params whole (fsdp off; ZeRO-1 stays, and in run A
# scatter_grads), and (2) in RANK_WITNESS's runs,
# the step in fp32 compute against one process with the lanes stacked
# and nothing sharded. (2) is in fp32 because a rank computes its 1/g of
# a microbatch's rows, and bf16 matmuls round differently over other row
# counts, which moves adam's step-1 update of the many elements whose
# gradient is near eps well past 1e-6. Both: within TRAIN_PARAM_TOL but
# for at most this fraction of the elements, none beyond two steps of
# the learning rate (1e-3)
SHARD_FLIP_FRACTION = 1e-3
SHARD_MAX_ABS = 2e-3
# (2) holds adam's first moment m (0.1 x the lane gradient at step 1)
# within WITNESS_M_RTOL of its leaf's largest |m| (the CPU tests' rule
# for state: the same fp32 sums in another order), and each param within
# TRAIN_PARAM_TOL except where a lane's |m| is at most WITNESS_M_FLOOR
# (|gradient| <= 100 x adam's eps of 1e-8): there the step-1 update
# lr·g/(|g| + eps) moves by up to lr for a change of g of order eps, so
# those may differ by up to SHARD_MAX_ABS
WITNESS_M_RTOL = 1e-4
WITNESS_M_FLOOR = 1e-7
# int8 kernel arm vs plain arm: both quantize the same raw lane halves in
# round 0; after it the two arms' combine outputs differ in the last bits,
# which can send an element within an ulp of a rounding boundary one
# quantization step (its 128-block absmax / 127) apart. At most this
# fraction of the elements may do so, none by more than two steps of the
# leaf's largest value
INT8_FLIP_FRACTION = 1e-3


def _checksums(tree, piece: int = 1 << 26):
    """Per leaf: the int64 sum of its bit patterns and its float64 sum,
    on the card, a piece at a time (a whole-leaf cast of the embedding
    would take 6 GiB); a different bit anywhere changes them."""
    import torch
    from repro_torch import tree as T
    out = []
    for x in T.leaves(tree):
        flat = x.detach().contiguous().view(-1)
        bits, fsum = 0, 0.0
        for s in range(0, flat.numel(), piece):
            part = flat[s:s + piece]
            ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
            bits += int(part.view(ints[part.element_size()]).long().sum())
            fsum += float(part.double().sum())
        out.append((bits, fsum))
    return out


def _all_equal(obj, group=None) -> bool:
    """Whether every rank (of `group`, default all) passed the same
    `obj`."""
    import torch.distributed as dist
    seen = [None] * dist.get_world_size(group)
    dist.all_gather_object(seen, obj, group=group)
    return all(x == seen[0] for x in seen)


def _int8_close(got, want, tol):
    """(largest error over the leaf's largest value, fraction of elements
    beyond tol x that value, largest error in steps of that value / 127)."""
    got, want = got.double(), want.double()
    scale = want.abs().max().clamp(min=1e-30)
    err = (got - want).abs()
    return ((err.max() / scale).item(), (err > tol * scale).double().mean()
            .item(), (err.max() / (scale / 127)).item())


def _synthetic_rvh(comm, world, compress):
    """RVH of random lanes (a few M elements, ten leaves of their own
    scales, several buckets) on the card against the single-process fused
    tree of all lanes, run on rank 0."""
    import torch
    from repro_torch import tree as T
    from repro_torch.core import combine as C
    from repro_torch.core import rvh
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    shapes = [(1536, 1024), (3_000_000,), (4096, 257), (777,), (3, 24576),
              (250_000,), (64, 64), (1_000_001,), (5,), (8192, 33)]
    lanes = {f"l{i}": torch.randn((world,) + s, generator=g, device="cuda")
             * (0.5 + i) for i, s in enumerate(shapes)}
    cfg = C.CombineConfig(compress=compress, fusion_threshold_mb=4)
    mine = {k: v[comm.rank].clone() for k, v in lanes.items()}
    got = rvh.adasum_rvh_pytree(mine, comm, compress=compress,
                                bucket_bytes=cfg.fusion_bytes, donate=True)
    same = _all_equal(_checksums(got))
    res = {"compress": compress, "elements": sum(x.numel() for x in
                                                 T.leaves(mine)),
           "bitwise_across_ranks": same}
    if comm.rank == 0:
        want = C.fused_combine_tree(lanes, cfg)
        errs = [_int8_close(got[k], want[k], COMBINED_RTOL) for k in lanes]
        res["rel_err"] = max(e[0] for e in errs)
        res["steps"] = max(e[2] for e in errs)
        res["ok"] = same and (res["rel_err"] <= COMBINED_RTOL
                              if compress == "none" else res["steps"] <= 2)
    return res


def _gather_check(comm, world) -> bool:
    """`Comm.gather_to_host` on the card (the path a ranked checkpoint
    takes at the post point): rows from ranks 0, g, 2g, ... onto rank 0's
    host, each row its sender's, one copy a sender counted as staged and
    none elsewhere; every rank's verdict, gathered."""
    import torch
    srcs = list(range(0, world, max(1, world // 2)))
    x = torch.full((1 << 22,), float(comm.rank + 1), device="cuda")
    before = comm.staged_bytes
    rows = comm.gather_to_host(x, srcs)
    staged = comm.staged_bytes - before
    ok = staged == (x.numel() * 4 if comm.rank in srcs else 0)
    if comm.rank == 0:
        ok = ok and rows.device.type == "cpu" and all(
            bool((rows[i] == r + 1).all()) for i, r in enumerate(srcs))
    else:
        ok = ok and rows is None
    return _all_equal(ok) and ok


def rank_worker(spec: dict) -> int:
    """One rank of phase 6 (run as its own process, all on cuda:0): the
    main path's RANK_STEPS steps, then step 1 twice more from fresh state
    (kernel, plain arm; the kernel arm's repeat is a one-step
    checkpointing run's redo), then the synthetic RVH check; writes a
    JSON record."""
    import math
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core import rvh
    from repro_torch.engine import build_runtime
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    world, optimizer, compress = spec["world"], spec["optimizer"], \
        spec["compress"]
    ckpt_dir = spec.get("ckpt_dir")
    shard = spec.get("shard") or {}     # runs A and B: fsdp, scatter_grads
    rank = int(os.environ["RANK"])
    lead = rank == 0
    cfg = dataclasses.replace(get_config(RANK_ARCH), n_layers=RANK_LAYERS)
    model = build_model(cfg, compute_dtype=torch.bfloat16,
                        param_dtype=torch.float32)
    rec = {"rank": rank, "world": world, "optimizer": optimizer,
           "compress": compress, "shard": shard}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    timer = _CombineTimer(keep=lead)
    # under torchrun's environment the session starts the process group
    s = _session(model, timer, device="cuda:0", dist_backend="gloo",
                 optimizer=optimizer, compress=compress, arch=RANK_ARCH,
                 global_batch=RANK_BATCH, ckpt_dir=ckpt_dir or "", **shard)
    comm = s.comm
    rt = s.runtime
    zplan = rt.plan
    rec["init_s"] = time.perf_counter() - t0
    gib = lambda b: f"{b / 2 ** 30:.2f}"
    mem = lambda: (f"{gib(torch.cuda.memory_allocated())} GiB allocated, "
                   f"peak {gib(torch.cuda.max_memory_allocated())}")
    print(f"[rank {rank}] session up in {rec['init_s']:.1f}s: {mem()}",
          flush=True)
    # the init draws the whole params on every rank before it shards them:
    # the run's peak is the steps'
    rec["init_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    # the RVH buckets of a step: over the span ranks of a member position,
    # on the lane gradient's layout (the plan's shards where it has one)
    if zplan is None:
        leaves, dims = T.leaves(s.state["params"]), None
    else:
        leaves = [torch.empty(sh, device="meta")
                  for sh in zplan.local_shapes("grads")]
        dims = zplan.dims
    g = world // rt.span
    plan = rvh.rvh_plan(leaves, rt.span, rank // g,
                        bucket_bytes=rt.dopt.cfg.fusion_bytes,
                        shard_dims=dims)
    rounds = int(math.log2(rt.span))
    # what the plan shards (whole leaves are held alike on every rank)
    whole = [zplan is None or not zplan.fsdp or d is None
             for d in (zplan.dims if zplan else leaves)]
    shared = lambda sums: [c for c, w in zip(sums, whole) if w]
    rec.update(buckets=len(plan), rounds=rounds,
               combine_path=rt.combine_path, point=rt.dopt.point,
               span=rt.span, dist_backend=s.run_metadata()["dist_backend"],
               sharded_leaves=0 if zplan is None else
               sum(d is not None for d in zplan.dims),
               held_gib={"params": _gib_of(s.state["params"]),
                         "state": _gib_of(s.state["opt"]["inner"])})
    comm.timing = True
    comm.take_ms()
    torch.cuda.synchronize()
    build.reset_launches()
    steps = []
    ck = {}
    last = spec["steps"] - 1
    for step in range(spec["steps"]):
        if ckpt_dir and step == last:  # phase 7 (d): save the last step's
            t0 = time.perf_counter()   # input state, all ranks
            s.save_sync(last)
            ck["save_s"] = time.perf_counter() - t0
        staged0 = comm.total_staged_bytes()
        t0 = time.perf_counter()
        m = s.step(s.batch(step))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        sums = _checksums(s.state["params"])
        steps.append({"step": step, "ms": ms, "combine_ms": timer.take_ms(),
                      "loss": m["loss"], "lane_cos": m["lane_cos"],
                      "comm": comm.take_ms(),
                      "staged_bytes": comm.total_staged_bytes() - staged0,
                      "mem_gib": torch.cuda.memory_allocated() / 2 ** 30,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "bitwise_across_ranks": _all_equal(shared(sums))})
        print(f"[rank {rank}] step {step} {ms:.0f} ms: {mem()}", flush=True)
        if step == 0:
            sums1 = sums
            p1 = ([x.to("cpu", copy=True) for x in T.leaves(s.state["params"])]
                  if lead else None)
    rec["launches"] = dict(build.LAUNCHES)
    comm.timing = False
    rec["steps"] = steps

    def timed_step(fn):
        """fn() (one step), timed as the repeat is: ms, the combine's ms,
        the comm's ms by kind and the bytes staged; returns (its result,
        that record)."""
        comm.timing = True
        comm.take_ms()
        staged0 = comm.total_staged_bytes()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        got = {"ms": 1e3 * (time.perf_counter() - t0),
               "combine_ms": timer.take_ms(), "comm": comm.take_ms(),
               "staged_bytes": comm.total_staged_bytes() - staged0}
        comm.timing = False
        return out, got

    sharded = zplan is not None and zplan.fsdp
    # a one-step checkpointing run's redo is step 1 again, with warm
    # buffers: it is the repeat too (bitwise, and timed as the steady step)
    redo_repeats = bool(ckpt_dir) and last == 0
    if ckpt_dir:   # restore the last step's input on every rank, redo it
        t0 = time.perf_counter()
        assert s.restore(last) == last
        ck["restore_s"] = time.perf_counter() - t0
        ck.update({k: v for k, v in s.checkpoint.timings.items()
                   if k != "snapshot_s" or lead})
        _, redo = timed_step(lambda: s.step(s.batch(last)))
        ck["redo_bitwise"] = _checksums(s.state["params"]) == sums
        rec["ckpt"] = ck
        print(f"[rank {rank}] checkpoint: {ck}", flush=True)
        if redo_repeats:
            rec["repeat_step"] = redo
            rec["repeat_bitwise"] = ck["redo_bitwise"]
            if sharded:   # this rank's step-1 params, for the whole run
                mine1 = [x.to("cpu", copy=True)
                         for x in T.leaves(s.state["params"])]
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    kept = timer.kept
    s.state = None
    _free()
    # step 1 from fresh state: the kernel arm again (bitwise), then the
    # plain arms on the card. The fresh params are drawn from the same
    # seed as the session's (which rank 0 broadcast), so the runtimes run
    # without a second session and broadcast
    def fresh_step(rt):
        params = model.init(torch.Generator(device="cuda:0").manual_seed(SEED))
        if rt.plan is not None:
            params = rt.plan.shard_params(params)
        state = {"params": params, "opt": rt.dopt.init(params), "step": 0}
        return rt.train_step(state, batch0)[0]

    batch0 = s.batch(0)
    if not redo_repeats:
        # the repeat is a step with warm buffers: a one-step run's steady
        # one
        again, rec["repeat_step"] = timed_step(
            lambda: fresh_step(s.runtime))
        rec["repeat_bitwise"] = _checksums(again["params"]) == sums1
        if sharded:    # this rank's step-1 params, for the whole run
            mine1 = [x.to("cpu", copy=True)
                     for x in T.leaves(again["params"])]
        del again
        _free()
    if lead:
        rec["update_max_abs"] = max(x.abs().max().item() for x in kept[0])
    if spec.get("plain"):
        ptimer = _CombineTimer(keep=lead)
        with _timing_combiners(ptimer):
            prt = build_runtime(model, s.config.run_policy(),
                                lr=s.config.lr, comm=comm,
                                combine_impl="plain")
        plain = fresh_step(prt)
        if lead:   # the combine's output and stats of step 1, then params
            rec["stats_rel_err"] = _rel_err(kept[1], ptimer.kept[1])
            cerr = [_int8_close(x, y, COMBINED_RTOL)
                    for x, y in zip(ptimer.kept[0], kept[0])]
            rec["combined_rel_err"] = max(e[0] for e in cerr)
            rec["combined_flip_fraction"] = max(e[1] for e in cerr)
            rec["combined_steps"] = max(e[2] for e in cerr)
            perr = [(x.cpu() - y).abs()
                    for x, y in zip(T.leaves(plain["params"]), p1)]
            rec["params_max_abs_err"] = max(e.max().item() for e in perr)
            rec["params_flip_fraction"] = max(
                (e > TRAIN_PARAM_TOL).double().mean().item() for e in perr)
            del perr
        del plain, prt, ptimer
    del kept, p1
    _free()
    def held(got, want) -> tuple:
        """Every rank's params `got` (its pieces) against the same pieces
        of the whole leaves `want`: the largest |difference| and the
        largest share of a leaf's elements past TRAIN_PARAM_TOL, over
        every rank."""
        errs = []
        for i, (x, y) in enumerate(zip(got, want)):
            if zplan.fsdp and zplan.dims[i] is not None:
                y = zplan.piece(i, y)
            e = (x.cpu() - y.cpu()).abs()
            errs.append((e.max().item(),
                         (e > TRAIN_PARAM_TOL).double().mean().item()))
            del e
        import torch.distributed as dist
        seen = [None] * world
        dist.all_gather_object(seen, (max(a for a, _ in errs),
                                      max(b for _, b in errs)))
        return max(a for a, _ in seen), max(b for _, b in seen)

    if sharded:    # the same step 1 with the params whole (fsdp off)
        rec["peak_gib_all"] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        urt = build_runtime(model, dataclasses.replace(
            s.config.run_policy(), fsdp=False), lr=s.config.lr, comm=comm)
        whole1 = fresh_step(urt)
        rec["whole_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["whole_max_abs_err"], rec["whole_flip_fraction"] = held(
            mine1, T.leaves(whole1["params"]))
        del whole1, urt, mine1
        _free()
    if spec.get("witness"):
        # step 1 in fp32 compute against the same step in one process with
        # the lanes stacked (nothing sharded; its params saved by the
        # parent before the ranks started)
        model32 = build_model(cfg, compute_dtype=torch.float32,
                              param_dtype=torch.float32)
        wrt = build_runtime(model32, s.config.run_policy(), lr=s.config.lr,
                            comm=comm)
        got = fresh_step(wrt)
        want = torch.load(spec["witness"], mmap=True)
        mine = _witness_errs(zplan, got, want, rank // g)
        del got, wrt, model32, want
        _free()
        import torch.distributed as dist
        seen = [None] * world
        dist.all_gather_object(seen, mine)
        rec["witness"] = {
            "m_rel_err": max(x["m_rel_err"] for x in seen),
            "params_max_abs_err": max(x["max_abs"] for x in seen),
            "params_max_abs_err_held": max(x["max_abs_held"] for x in seen),
            "elements": sum(x["elements"] for x in seen),
            "exempt": sum(x["exempt"] for x in seen),
            "exempt_past_tol": sum(x["exempt_past_tol"] for x in seen),
            "worst_leaf": max((x["worst"] for x in seen),
                              key=lambda w: w[1])}
    if spec.get("synthetic"):
        rec["synthetic"] = [_synthetic_rvh(comm, world, "none")]
        if compress != "none":
            rec["synthetic"].append(_synthetic_rvh(comm, world, compress))
        rec["gather_ok"] = _gather_check(comm, world)
    rec["staged_bytes_total"] = comm.total_staged_bytes()
    rec.setdefault("peak_gib_all",
                   torch.cuda.max_memory_allocated() / 2 ** 30)
    s.close()
    Path(spec["out"]).write_text(json.dumps(rec, default=str))
    return 0


def _witness_errs(plan, got, want, lane: int) -> dict:
    """This rank's step-1 state `got` (fp32 compute, sharded by `plan`)
    against `want`, the same step in one process (`_witness_step`): the
    largest |m - m_one| over its leaf's largest |m_one|; the params'
    largest |difference| overall and where every lane's |m| passes
    WITNESS_M_FLOOR (held to TRAIN_PARAM_TOL); how many elements are
    exempt and how many of those pass TRAIN_PARAM_TOL; and the leaf with
    the most elements past it (index, count, size)."""
    import torch
    from repro_torch import tree as T
    out = {"m_rel_err": 0.0, "max_abs": 0.0, "max_abs_held": 0.0,
           "elements": 0, "exempt": 0, "exempt_past_tol": 0,
           "worst": (None, 0, 0)}
    mm = T.leaves(got["opt"]["inner"]["m"])
    for i, x in enumerate(T.leaves(got["params"])):
        lanes = want["m"][i]                       # [span, ...] whole
        ref = plan.take(i, lanes[lane], "state")
        err = (mm[i].cpu() - ref).abs().max().item()
        out["m_rel_err"] = max(out["m_rel_err"],
                               err / max(want["m_max"][i], 1e-30))
        e = (x.cpu() - plan.take(i, want["params"][i], "params")).abs()
        small = plan.take(i, lanes[0], "params").abs()
        for l in range(1, lanes.shape[0]):
            torch.minimum(small, plan.take(i, lanes[l], "params").abs(),
                          out=small)
        exempt = small <= WITNESS_M_FLOOR
        past = e > TRAIN_PARAM_TOL
        out["max_abs"] = max(out["max_abs"], e.max().item())
        held = e[~exempt]
        if held.numel():
            out["max_abs_held"] = max(out["max_abs_held"],
                                      held.max().item())
        out["elements"] += e.numel()
        out["exempt"] += int(exempt.sum())
        out["exempt_past_tol"] += int((past & exempt).sum())
        n = int(past.sum())
        if n > out["worst"][1]:
            out["worst"] = (i, n, e.numel())
        del e, small, exempt, past
    return out


def _gib_of(tree) -> float:
    """GiB of a tree's tensors."""
    from repro_torch import tree as T
    return sum(x.numel() * x.element_size() for x in T.leaves(tree)) / 2**30


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn_ranks(world: int, tag: str, spec: dict,
                 flag: str = "--rank-worker", beside=None) -> list:
    """`world` rank processes of this script, run with `flag` and `spec`
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT as torchrun sets
    them); any rank failing or outliving RANK_TIMEOUT_S fails the phase,
    and every process is stopped before this returns. Each rank writes
    its record to the JSON file `spec["out"]` names. `beside()`, when
    given, runs in this process while the ranks run, and the records
    come back with its result, as (records, result)."""
    out = ROOT / "build" / "ranks"            # gitignored, beside the kernels
    out.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    procs, logs = [], []
    for r in range(world):
        rspec = dict(spec, out=str(out / f"{tag}_rank{r}.json"))
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        log = open(out / f"{tag}_rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), flag,
             json.dumps(rspec)], env=env, stdout=log,
            stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        got = beside() if beside is not None else None
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks {tag} outlived "
                                     f"{RANK_TIMEOUT_S}s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            text = (out / f"{tag}_rank{r}.log").read_text()
            print(f"--- rank {r} of {tag} (rc {procs[r].returncode}):\n"
                  f"{text[-3000:]}", file=sys.stderr)
        raise AssertionError(f"ranks {tag}: rank(s) {bad} failed")
    recs = [json.loads((out / f"{tag}_rank{r}.json").read_text())
            for r in range(world)]
    return recs if beside is None else (recs, got)


def ranks_phase(card: str, witness: bool = False, beside=None):
    """Phase 6: multi-rank Adasum (RVH across ranks) through
    `TrainSession` in rank processes that share this machine's one
    card over gloo, the data axis sharded in runs (a) and (A); with
    `witness`, RANK_WITNESS's runs also hold their step 1 in fp32 compute
    against one process. `beside` maps a run's tag to work for this
    process while that run's ranks run (~15 GiB of the card); their
    results come back under "beside", by tag."""
    import torch
    _free()
    print(f"[smoke] ranks: before launching, this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved | {card}")
    print(f"[smoke] ranks: gloo over host memory, every rank on cuda:0 (this"
          f" machine has {torch.cuda.device_count()} card); exchanged halves"
          f" are staged through pinned host buffers; NCCL was not run; "
          f"exchange times are host loopback times | {card}")
    import shutil
    beside = beside or {}
    runs, besides = {}, {}
    for tag, optimizer, world, compress, fields in RANK_RUNS:
        # the checkpointing run's directory and the witness's params go
        # under build/, gitignored
        ckpt = ROOT / "build" / "ckpt_ranks" if tag == RANK_CKPT else None
        wpath = ROOT / "build" / "ranks" / f"witness_{tag}.pt" \
            if witness and tag in RANK_WITNESS else None
        t0 = time.perf_counter()
        try:
            if wpath:
                _witness_step(optimizer, world, fields, wpath, card)
            recs = _spawn_ranks(world, f"{optimizer}_w{world}", {
                "world": world, "optimizer": optimizer,
                "compress": compress, "shard": fields,
                "steps": 1 if fields.get("fsdp") else RANK_STEPS,
                "ckpt_dir": str(ckpt) if ckpt else "",
                "synthetic": tag in RANK_SYNTHETIC,
                "plain": tag in RANK_PLAIN,
                "witness": str(wpath) if wpath else ""},
                beside=beside.get(tag))
            if tag in beside:
                recs, besides[tag] = recs
        finally:
            if ckpt:
                shutil.rmtree(ckpt, ignore_errors=True)
            if wpath:
                wpath.unlink(missing_ok=True)
        runs[f"{optimizer}_w{world}"] = _rank_run(
            card, tag, recs, time.perf_counter() - t0)
    key = lambda t: "{}_w{}".format(*_rank_run_of(t)[1:3])
    for tag, near in SHARD_BELOW.items():
        got, want = runs[key(tag)], runs[key(near)]
        print(f"[smoke] ranks peaks: ({tag}) sharded "
              f"{[round(x, 2) for x in got['peak_gib']]} GiB a rank, "
              f"holding params {got['held_gib'][0]['params']:.3f} and state "
              f"{got['held_gib'][0]['state']:.3f} GiB, beside the unsharded "
              f"({near})'s {[round(x, 2) for x in want['peak_gib']]}, "
              f"holding {want['held_gib'][0]['params']:.3f} and "
              f"{want['held_gib'][0]['state']:.3f} | {card}")
        assert max(got["peak_gib"]) < min(want["peak_gib"]), (
            f"({tag}): a rank's peak {max(got['peak_gib']):.2f} GiB is not "
            f"below ({near})'s {min(want['peak_gib']):.2f}")
    return {"layers": RANK_LAYERS, "runs": runs, "beside": besides}


def _witness_step(optimizer: str, world: int, fields: dict, path: Path,
                  card: str) -> None:
    """Step 1 of a phase-6 run in this process, in fp32 compute, with its
    `world` ranks' lanes stacked and nothing sharded (fsdp and
    scatter_grads change nothing on one device), saved to `path` for the
    ranks to hold theirs against: its params and adam's first moment m
    ([span, ...], one row a lane), whole, and each m leaf's largest
    |m|."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(RANK_ARCH), n_layers=RANK_LAYERS)
    model = build_model(cfg, compute_dtype=torch.float32,
                        param_dtype=torch.float32)
    rest = {k: v for k, v in fields.items() if k not in ("span", "backend")}
    span = fields.get("span") or world
    t0 = time.perf_counter()
    s = _session(model, optimizer=optimizer, span=span, backend="gspmd_tree",
                 global_batch=RANK_BATCH, arch=RANK_ARCH, **rest)
    s.step(s.batch(0))
    m = T.leaves(s.state["opt"]["inner"]["m"])
    torch.save({"params": [x.cpu() for x in T.leaves(s.state["params"])],
                "m": [x.cpu() for x in m],
                "m_max": [x.abs().max().item() for x in m]}, path)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del s, m
    _free()
    torch.cuda.reset_peak_memory_stats()
    print(f"[smoke] ranks: one process, lanes stacked, fp32 compute, "
          f"{optimizer} span {span}: step 1 params and m saved in "
          f"{time.perf_counter() - t0:.1f} s (peak {peak:.2f} GiB) | {card}")


def _rank_run_of(tag: str) -> tuple:
    """The RANK_RUNS entry of `tag`."""
    return next(r for r in RANK_RUNS if r[0] == tag)


def _rank_run(card: str, tag: str, recs: list, wall: float) -> dict:
    """One run of phase 6 from its ranks' records: printed and checked
    (see the module docstring)."""
    lead = recs[0]
    world, optimizer, compress = lead["world"], lead["optimizer"], \
        lead["compress"]
    shard = lead["shard"]
    sharded = "whole_max_abs_err" in lead
    name = f"({tag}) {optimizer} world={world} compress={compress}" + "".join(
        f" {k}={v}" for k, v in shard.items() if k != "backend")
    per_step = lead["buckets"] * lead["rounds"]
    nsteps = len(lead["steps"])
    for rec in recs:
        for k in ("block_dots", "block_combine"):
            assert rec["launches"][k] == nsteps * per_step > 0, (
                f"{name} rank {rec['rank']}: {k} launched "
                f"{rec['launches'][k]} times, expected "
                f"{nsteps * per_step} ({lead['buckets']} buckets x "
                f"{lead['rounds']} rounds x {nsteps} steps)")
    # the steps after the first, else the repeat of step 1 (warm buffers)
    steady = [r["steps"][1:] or [r["repeat_step"]] for r in recs]
    mean = lambda f: statistics.mean(f(st) for rs in steady for st in rs)
    part = lambda n: mean(lambda st: st["comm"].get(n, 0.0))
    peaks = [r["peak_gib"] for r in recs]
    peaks_all = [r["peak_gib_all"] for r in recs]
    bitwise = all(st["bitwise_across_ranks"] for r in recs
                  for st in r["steps"])
    repeat = all(r["repeat_bitwise"] for r in recs)
    run = {"tag": tag, "world": world, "optimizer": optimizer,
           "compress": compress, "fields": shard, "point": lead["point"],
           "span": lead["span"], "combine_path": lead["combine_path"],
           "buckets": lead["buckets"], "rounds": lead["rounds"],
           "sharded_leaves": lead["sharded_leaves"],
           "launches": [r["launches"] for r in recs],
           "losses": [st["loss"] for st in lead["steps"]],
           "step_ms": [[st["ms"] for st in r["steps"]] for r in recs],
           "step_ms_steady": mean(lambda st: st["ms"]),
           "combine_ms_steady": mean(lambda st: st["combine_ms"]),
           **{f"{n}_ms_steady": part(n) for n in (
               "exchange", "reduce_scatter", "all_gather", "allreduce",
               "stage", "dots_sum", "kernels")},
           "staged_gb_per_step": mean(lambda st: st["staged_bytes"]) / 1e9,
           "held_gib": [r["held_gib"] for r in recs],
           "peak_gib": peaks, "peak_gib_sum": sum(peaks),
           "peak_gib_all_checks": peaks_all,
           "init_peak_gib": [r["init_peak_gib"] for r in recs],
           "bitwise_across_ranks": bitwise, "repeat_bitwise": repeat,
           "wall_s": wall, "init_s": [r["init_s"] for r in recs],
           **{k: lead[k] for k in lead if k.endswith(
               ("_err", "_abs", "_fraction", "_steps"))}}
    for k in ("synthetic", "gather_ok"):
        if k in lead:
            run[k] = lead[k] if k == "synthetic" else \
                [r[k] for r in recs]
    if sharded:
        run["whole_peak_gib"] = [r["whole_peak_gib"] for r in recs]
    witness = lead.get("witness")
    if witness:
        run["witness"] = witness
    if "ckpt" in lead:
        run["ckpt"] = {
            "redo_bitwise": [r["ckpt"]["redo_bitwise"] for r in recs],
            "save_s": lead["ckpt"]["save_s"],
            "snapshot_s": lead["ckpt"].get("snapshot_s"),
            "write_s": lead["ckpt"].get("write_s"),
            "write_bytes": lead["ckpt"].get("write_bytes"),
            "restore_s": [r["ckpt"]["restore_s"] for r in recs],
            "crc_s": [r["ckpt"]["crc_s"] for r in recs]}
    r0 = [{k: n[k] for k in ("block_dots", "block_combine")}
          for n in run["launches"]]
    print(f"[smoke] ranks {name} point={run['point']} "
          f"path={run['combine_path']} span={run['span']} sharded leaves="
          f"{run['sharded_leaves']} buckets={run['buckets']} rounds="
          f"{run['rounds']} launches per rank={r0} losses="
          f"{[round(x, 4) for x in run['losses']]} | {card}")
    print(f"[smoke] ranks {name}: step_ms={run['step_ms_steady']:.1f} "
          f"combine_ms={run['combine_ms_steady']:.1f} of which exchange_ms="
          f"{run['exchange_ms_steady']:.1f}; reduce_scatter_ms="
          f"{run['reduce_scatter_ms_steady']:.1f} all_gather_ms="
          f"{run['all_gather_ms_steady']:.1f} allreduce_ms="
          f"{run['allreduce_ms_steady']:.1f} (staging_ms="
          f"{run['stage_ms_steady']:.1f}; gloo over host loopback, not "
          f"NCCL) dots_sum_ms={run['dots_sum_ms_steady']:.1f} dots+combine "
          f"kernels_ms={run['kernels_ms_steady']:.1f}; staged "
          f"{run['staged_gb_per_step']:.2f} GB a step per rank; phase wall "
          f"{wall:.1f}s | {card}")
    print(f"[smoke] ranks {name}: held GiB per rank (params, state)="
          f"{[(round(h['params'], 3), round(h['state'], 3)) for h in run['held_gib']]}"
          f" peak_gib per rank={[round(x, 2) for x in peaks]} sum="
          f"{sum(peaks):.2f} (limit {RANK_MEM_GIB}; init peak "
          f"{max(run['init_peak_gib']):.2f}; with the checks after the run "
          f"{sum(peaks_all):.2f}) | {card}")
    whole = (f"; vs step 1 with the params whole (fsdp off; peak "
             f"{[round(x, 2) for x in run['whole_peak_gib']]} GiB): "
             f"max_abs_err={lead['whole_max_abs_err']:.3e} flip fraction "
             f"{lead['whole_flip_fraction']:.2e} (tol {TRAIN_PARAM_TOL} but "
             f"{SHARD_FLIP_FRACTION}, none past {SHARD_MAX_ABS})"
             if sharded else "")
    if witness:
        w = witness
        whole += (f"; fp32 compute vs one process, lanes stacked, nothing "
                  f"sharded: adam m rel_err={w['m_rel_err']:.3e} (tol "
                  f"{WITNESS_M_RTOL}); params max_abs_err="
                  f"{w['params_max_abs_err_held']:.3e} where every lane's "
                  f"|m| > {WITNESS_M_FLOOR} (tol {TRAIN_PARAM_TOL}), "
                  f"{w['params_max_abs_err']:.3e} overall (tol "
                  f"{SHARD_MAX_ABS}); {w['exempt']} of {w['elements']} "
                  f"elements at or below the floor, {w['exempt_past_tol']} "
                  f"of them past {TRAIN_PARAM_TOL}; most past it in leaf "
                  f"{w['worst_leaf'][0]}: {w['worst_leaf'][1]} of "
                  f"{w['worst_leaf'][2]}")
    syn = run.get("synthetic")
    extra = (f"; synthetic RVH vs fused tree (compress, rel_err, steps): "
             f"{[(x['compress'], x['rel_err'], x['steps']) for x in syn]}; "
             f"gather_to_host ok={run['gather_ok']}" if syn else "")
    plain = "stats_rel_err" in lead
    held = (f"kernel vs plain: combined rel_err="
            f"{lead['combined_rel_err']:.3e} (flip fraction "
            f"{lead['combined_flip_fraction']:.2e}, largest "
            f"{lead['combined_steps']:.3f} steps) stats rel_err="
            f"{lead['stats_rel_err']:.3e} (tol {COMBINED_RTOL}); params "
            f"max_abs_err={lead['params_max_abs_err']:.3e} (tol "
            f"{TRAIN_PARAM_TOL}, flip fraction "
            f"{lead['params_flip_fraction']:.2e})" if plain else
            "no plain arm (RANK_PLAIN)")
    print(f"[smoke] ranks {name}: {'whole ' if sharded else ''}params "
          f"bitwise equal across ranks after every step={bitwise}; step 1 "
          f"repeated bitwise={repeat}; {held} against a step-1 update of "
          f"max {lead['update_max_abs']:.3e}{whole}{extra} | {card}")
    assert bitwise, f"{name}: params differ across ranks"
    assert repeat, f"{name}: step 1 is not bitwise repeatable"
    if syn:
        assert all(x["ok"] and x["bitwise_across_ranks"] for x in syn), syn
        assert all(run["gather_ok"]), (
            f"{name}: Comm.gather_to_host rows or staged bytes wrong: "
            f"{run['gather_ok']}")
    if not plain:
        pass
    elif compress == "none":
        assert lead["stats_rel_err"] <= COMBINED_RTOL, name
        assert lead["combined_rel_err"] <= COMBINED_RTOL, name
        assert lead["params_max_abs_err"] <= TRAIN_PARAM_TOL, name
    else:
        assert lead["stats_rel_err"] <= COMBINED_RTOL, name
        assert lead["combined_flip_fraction"] <= INT8_FLIP_FRACTION, name
        assert lead["combined_steps"] <= 2, name
        assert lead["params_flip_fraction"] <= INT8_FLIP_FRACTION, name
        assert lead["params_max_abs_err"] <= (
            2 * lead["update_max_abs"] / 127 + TRAIN_PARAM_TOL), name
    if sharded:
        assert run["sharded_leaves"] > 0, name
        assert lead["whole_flip_fraction"] <= SHARD_FLIP_FRACTION, name
        assert lead["whole_max_abs_err"] <= SHARD_MAX_ABS, name
        assert max(peaks) < min(run["whole_peak_gib"]), (
            f"{name}: a rank's peak {max(peaks):.2f} GiB is not below its "
            f"step with the params whole, {min(run['whole_peak_gib']):.2f}")
    if witness:
        assert witness["m_rel_err"] <= WITNESS_M_RTOL, (name, witness)
        assert witness["params_max_abs_err_held"] <= TRAIN_PARAM_TOL, (
            name, witness)
        assert witness["params_max_abs_err"] <= SHARD_MAX_ABS, (
            name, witness)
    assert sum(peaks) <= RANK_MEM_GIB, (
        f"{name}: summed peak {sum(peaks):.1f} GiB > {RANK_MEM_GIB}")
    return run


# -------------------------------------------------------- checkpoint phase
CKPT_LAYERS = 1    # of gemma-7b's 28: 1.063 B params, 4.25 GB of fp32;
                   # with momentum's per-lane state at span 2, 12.75 GB a
                   # checkpoint
CKPT_SERVE = dict(max_slots=4, max_len=512, page_size=16)


def _host_ram_available() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def _captured(fn):
    """fn() with its standard output captured and echoed; returns
    (result, text)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    print(buf.getvalue(), end="")
    return out, buf.getvalue()


def _greedy(engine, prompts, arrivals, gen, **req):
    """Submit prompts in arrival groups of the given sizes (0: a tick
    with no arrival), one tick after each group; returns the handles
    after the engine drains. gen: tokens a request, or one per prompt;
    req: further GenerationRequest fields."""
    from repro_torch.engine import GenerationRequest
    gens = gen if isinstance(gen, (list, tuple)) else [gen] * len(prompts)
    handles, i = [], 0
    for size in arrivals:
        for _ in range(size):
            handles.append(engine.submit(GenerationRequest(
                prompts[i], max_new_tokens=gens[i], **req)))
            i += 1
        engine.step()
    engine.drain()
    return handles


def ckpt_phase(card: str, ranks: dict):
    """Phase 7: checkpoints, resume, serving a checkpoint, hot-reload."""
    import shutil
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core import combine as C
    from repro_torch.engine import EngineConfig, ServeEngine, TrainSession
    from repro_torch.engine.session import CheckpointCallback
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    full = get_config("gemma-7b")
    cfg = dataclasses.replace(full, n_layers=CKPT_LAYERS)
    model = build_model(cfg, compute_dtype=torch.bfloat16,
                        param_dtype=torch.float32)
    root = ROOT / "build" / "ckpt"          # gitignored
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rec = {"layers": CKPT_LAYERS}
    fields = dict(arch="gemma-7b", seq_len=512, global_batch=8,
                  fusion_threshold_mb=64, optimizer="momentum", span=2,
                  backend="gspmd_tree", combine_point="post",
                  ckpt_dir=str(root), ckpt_every=2, log_every=1)

    def session(callbacks=(), **over):
        ecfg = EngineConfig(**{**fields, **over})
        return TrainSession.from_config(
            ecfg, model=model, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(SEED),
            callbacks=list(callbacks))

    def state_sums(s):
        """Checksums of every tensor leaf and the step counters."""
        leaves = T.leaves(s.state)
        return (_checksums([x for x in leaves if isinstance(x, torch.Tensor)]),
                [x for x in leaves if not isinstance(x, torch.Tensor)])

    try:
        # (a) train, save, resume ------------------------------------
        a = session([CheckpointCallback(2)], device_stage=True)
        size = sum(x.numel() * x.element_size()
                   for x in T.leaves(a.state) if isinstance(x, torch.Tensor))
        disk = shutil.disk_usage(root).free
        ram = _host_ram_available()
        print(f"[smoke] ckpt: gemma-7b full width, {CKPT_LAYERS} of "
              f"{full.n_layers} layers, {cfg.param_count() / 1e9:.3f}B "
              f"params fp32, momentum span 2 at the post point: a "
              f"checkpoint holds {size / 1e9:.2f} GB; free disk at {root}: "
              f"{disk / 1e9:.1f} GB, host RAM available {ram / 1e9:.1f} GB")
        assert disk >= 2 * size and ram >= 2 * size, (
            f"phase 7 needs twice the checkpoint's {size / 1e9:.2f} GB free "
            f"on disk ({disk / 1e9:.1f} GB) and in host RAM "
            f"({ram / 1e9:.1f} GB)")
        build.reset_launches()
        hist = a.fit(2)
        a.checkpoint.wait()
        t = dict(a.checkpoint.timings)
        sums2 = _checksums(a.state["params"])
        a.step(a.batch(2))
        torch.cuda.synchronize()
        sums3 = state_sums(a)
        rec["save"] = {"bytes": t["write_bytes"], "snapshot_s":
                       t["snapshot_s"], "write_s": t["write_s"],
                       "steps_ms": [1e3 * h["s"] for h in hist]}
        print(f"[smoke] ckpt save step 2: caller-blocking snapshot "
              f"{1e3 * t['snapshot_s']:.0f} ms, background write "
              f"{t['write_s']:.2f} s for {t['write_bytes'] / 1e9:.2f} GB "
              f"({t['write_bytes'] / 1e9 / t['write_s']:.2f} GB/s) | {card}")

        leaves = T.leaves(a.state["params"])
        plan = C.fused_plan([x.expand((2,) + tuple(x.shape)) for x in leaves],
                            C.CombineConfig(fusion_threshold_mb=64))
        resumed = {}
        for tag, over in (("prefetch_on", dict(device_stage=True)),
                          ("prefetch_off", dict(prefetch=False))):
            b = session(**over)
            torch.cuda.synchronize()
            build.reset_launches()
            hist, text = _captured(lambda: b.fit(3))
            torch.cuda.synchronize()
            launches = dict(build.LAUNCHES)
            assert "resumed from step 2" in text, text
            assert [h["step"] for h in hist] == [2] and b.state["step"] == 3
            bitwise = state_sums(b) == sums3
            bt = dict(b.checkpoint.timings)
            # one more step from the live state (no restore: the
            # checkpoint is behind it), the first one's warm-up gone
            steady = b.fit(4)[0]["s"]
            resumed[tag] = {"bitwise": bitwise, "step_ms": 1e3 * hist[0]["s"],
                            "steady_step_ms": 1e3 * steady,
                            "launches": launches, "load_s": bt["load_s"],
                            "crc_s": bt["crc_s"], "copy_s": bt["copy_s"]}
            adasum = {k: launches[k] for k in ("block_dots",
                                               "block_combine")}
            print(f"[smoke] ckpt resume ({tag}): restore load "
                  f"{bt['load_s']:.2f} s + crc {bt['crc_s']:.2f} s + copy "
                  f"onto the card {bt['copy_s']:.2f} s; step 2->3 "
                  f"{1e3 * hist[0]['s']:.1f} ms, 3->4 {1e3 * steady:.1f} ms;"
                  f" launches "
                  f"{adasum}"
                  f" ({len(plan)} buckets x 1 level); step-3 params and "
                  f"momentum state bitwise equal to the uninterrupted run: "
                  f"{bitwise} | {card}")
            assert bitwise, f"{tag}: resumed step 3 differs"
            for k in ("block_dots", "block_combine"):
                assert launches[k] == len(plan), (tag, k, launches[k])
            b.close()
            del b
            _free()
        rec["resume"] = resumed

        # (b) serve the checkpoint -----------------------------------
        rng = np.random.RandomState(SEED + 7)
        V = cfg.vocab_size
        prompts = [rng.randint(0, V, rng.randint(150, 260)) for _ in range(6)]
        build.reset_launches()
        eng, text = _captured(lambda: ServeEngine.from_config(
            EngineConfig(**CKPT_SERVE, ckpt_dir=str(root)), model=model,
            device="cuda"))
        assert "serving checkpoint step 2" in text and eng.loaded_step == 2
        p2 = eng.params
        assert _checksums(p2) == sums2, "served params != step-2 params"
        got = [h.tokens for h in _greedy(eng, prompts, [1, 2, 1, 1, 1], 16)]
        torch.cuda.synchronize()
        serve_launches = dict(build.LAUNCHES)
        direct = ServeEngine(EngineConfig(**CKPT_SERVE), model, p2)
        want = [h.tokens for h in _greedy(direct, prompts, [1, 2, 1, 1, 1],
                                          16)]
        st = dict(eng.checkpoint.timings)
        rec["serve"] = {"tokens_equal": got == want,
                        "launches": serve_launches,
                        "restore_load_s": st["load_s"],
                        "restore_crc_s": st["crc_s"]}
        attn = {k: serve_launches[k] for k in ("flash_attention",
                                               "paged_decode_attention")}
        print(f"[smoke] ckpt serve step 2: 6 requests on 4 slots, greedy "
              f"tokens equal to an engine given the params directly: "
              f"{got == want}; launches "
              f"{attn};"
              f" params-only restore load {st['load_s']:.2f} s + crc "
              f"{st['crc_s']:.2f} s | {card}")
        assert got == want
        assert all(len(x) == 16 for x in got)
        for k in ("flash_attention", "paged_decode_attention"):
            assert serve_launches[k] > 0, f"{k} never launched serving"
        del eng, direct

        # (c) hot-reload ------------------------------------------------
        hr = ServeEngine(EngineConfig(**CKPT_SERVE, ckpt_dir=str(root),
                                      hot_reload=True), model, p2,
                         checkpoint=a.checkpoint, loaded_step=2)
        polls, ticks = [], []
        poll, tick = hr._reloader.poll, hr._decode_tick

        def timed_poll():
            t0 = time.perf_counter()
            out = poll()
            polls.append((time.perf_counter() - t0, out is not None))
            return out

        def timed_tick():
            n = hr.stats["transition_ticks"]
            t0 = time.perf_counter()
            tick()
            ticks.append((time.perf_counter() - t0,
                          hr.stats["transition_ticks"] > n))
        hr._reloader.poll, hr._decode_tick = timed_poll, timed_tick
        from repro_torch.engine import GenerationRequest
        h_old = hr.submit(GenerationRequest(prompts[0], max_new_tokens=24))
        for _ in range(3):
            hr.step()
        assert not h_old.done
        a.save(3)                      # async: the write is in flight
        snap = a.checkpoint.timings["snapshot_s"]
        h_new = hr.submit(GenerationRequest(prompts[1], max_new_tokens=12))
        hr.drain()
        rt = dict(a.checkpoint.timings)
        swap_s = [dt for dt, swapped in polls if swapped]
        trans = [dt for dt, x in ticks if x]
        normal = [dt for dt, x in ticks if not x]
        solo = []
        for params, h in ((p2, h_old), (a.state["params"], h_new)):
            e = ServeEngine(EngineConfig(**CKPT_SERVE), model, params)
            hs = e.submit(GenerationRequest(h.request.prompt,
                                            max_new_tokens=len(h.tokens)))
            e.drain()
            solo.append(hs.tokens == h.tokens)
            del e
        rec["hot_reload"] = {
            "reloads": hr.stats["reloads"],
            "transition_ticks": hr.stats["transition_ticks"],
            "versions": [h_old.version, h_new.version],
            "tokens_equal_pinned": solo, "snapshot_s": snap,
            "write_s": rt["write_s"], "swap_poll_s": swap_s,
            "restore_load_s": rt["load_s"], "restore_crc_s": rt["crc_s"],
            "transition_tick_ms": [1e3 * x for x in trans],
            "normal_tick_ms_median": 1e3 * statistics.median(normal)}
        print(f"[smoke] ckpt hot-reload: step 3 saved mid-stream (snapshot "
              f"{1e3 * snap:.0f} ms, write {rt['write_s']:.2f} s); the poll "
              f"that swapped took {[round(x, 2) for x in swap_s]} s (barrier "
              f"on the write, then load {rt['load_s']:.2f} s + crc "
              f"{rt['crc_s']:.2f} s); reloads={hr.stats['reloads']} "
              f"transition_ticks={hr.stats['transition_ticks']} tick ms: "
              f"transition {[round(1e3 * x, 2) for x in trans]}, normal "
              f"median {1e3 * statistics.median(normal):.2f}; versions "
              f"{(h_old.version, h_new.version)}; tokens equal to an engine "
              f"on the pinned step alone (step 2, step 3): {solo} | {card}")
        assert hr.stats["reloads"] == 1 and hr.stats["transition_ticks"] >= 1
        assert (h_old.version, h_new.version) == (0, 1) and all(solo)
        assert hr.leaked_pages() == 0
        del hr
        a.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (d) ranks: phase 6's checkpointing run saved its last step, restored
    # it in place on every rank and redid the step
    _, opt, world, _, _ = _rank_run_of(RANK_CKPT)
    first = ranks["runs"][f"{opt}_w{world}"]
    rec["ranks"] = first["ckpt"]
    print(f"[smoke] ckpt ranks ({RANK_CKPT}: {opt} world={world}):"
          f" {first['ckpt']} | {card}")
    assert all(first["ckpt"]["redo_bitwise"]), first["ckpt"]
    return rec


SCAN_REPS = 5
_AB = {"serve": ("--serve-only", "SERVE"), "scan": ("--scan-only", "SCAN")}


def scan_phase(card: str) -> dict:
    """Phase 8 (e)'s scan prefill alone, on the serve phase's model
    (qwen3-32b at LAYERS layers, bf16 random weights from SEED, plain
    attention): a group of prompts of 40 and 64 tokens at cap 2048, as
    phase 8 (e) runs it, and a group of 16, 32, 48 and 64 at cap 4096;
    each timed SCAN_REPS times after one warm-up. Returns {group: [ms]}."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine.serving.engine import _make_scan_prefill
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("qwen3-32b"), n_layers=LAYERS)
    plain = build_model(cfg, compute_dtype=torch.bfloat16,
                        param_dtype=torch.bfloat16, attn_impl="plain")
    params = plain.init(torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    rng = np.random.RandomState(SEED)
    out = {}
    for lens, cap in (((40, 64), 2048), ((16, 32, 48, 64), 4096)):
        toks = np.zeros((len(lens), max(lens)), np.int32)
        for i, n in enumerate(lens):
            toks[i, :n] = rng.randint(0, cfg.vocab_size, n)
        tt = torch.from_numpy(toks).cuda()
        lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
        prefill = _make_scan_prefill(plain, cap)
        times = []
        for _ in range(SCAN_REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, tt, lt)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        out[f"{'/'.join(map(str, lens))}@{cap}"] = times[1:]
    print(f"[smoke] scan prefill ms {out} | {card}")
    return out


def run_ab(other: Path, mode: str) -> int:
    """The serve phase (mode 'serve') or the scan prefill (mode 'scan')
    on `other`'s package and on this tree's, in turns other, this, this,
    other, each run a process of this script with --serve-only or
    --scan-only; prints each run's output and one SERVE_AB or SCAN_AB
    line."""
    flag, key = _AB[mode]
    trees = [("other", other.resolve() / "src"), ("this", ROOT / "src")]
    if not (trees[0][1] / "repro_torch").is_dir():
        print(f"chip_smoke: {other} holds no src/repro_torch",
              file=sys.stderr)
        return 2
    runs = []
    for tag, src in (trees[0], trees[1], trees[1], trees[0]):
        print(f"=== {mode} on {tag}: {src}", flush=True)
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), flag,
             str(src)], capture_output=True, text=True, timeout=900)
        print(proc.stdout, end="")
        print(proc.stderr, end="", file=sys.stderr)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(key + " ")]
        if proc.returncode or not lines:
            print(f"chip_smoke: {mode} on {tag} failed "
                  f"(rc {proc.returncode})", file=sys.stderr)
            return 1
        runs.append({"tree": tag,
                     **json.loads(lines[-1][len(key) + 1:])})
    print(f"{key}_AB " + json.dumps(runs))
    return 0


# -------------------------------------------------------- combiners phase
# (a) the delayed combine on stacked lanes: the train phase's model with
# momentum at span P9_SPAN; the pending carry is span lanes of fp32
# params, and a round holds two of it (the one the correction reads, the
# one the local step writes)
P9_SPAN = 2
P9_STEPS = 3
P9_MEM_GIB = 70
# overlapped and serial rounds, in turns; their medians give the hidden
# fraction
P9_OVERLAP_ROUNDS = 3       # of each kind (cut for the time limit)
# (c) mean, accumulation, local steps and the delayed combine across
# ranks (sum, adascale and adasum-linear run across ranks in phase 13
# (e), on shards and whole leaves), and phase 10 (b)'s elastic drill:
# P9_RANK_ARCH
# at full width, P9_RANK_LAYERS layer (minicpm3-4b, hf
# openbmb/MiniCPM3-4B: 250.7 M params, 1.00 GB fp32, against gemma-7b's
# 1.063 B and 4.25 GB at one layer, whose gloo traffic would make these
# two phases a third of the script; the paths they drive do not depend
# on the model), all ranks on cuda:0 over gloo,
# one launch a world size, in turn (a world of 2 is its own process
# group: torch's new_group is collective over every process, so two ranks
# of a four-rank launch cannot build their runtime's groups alone; a
# launch holds ~15 GiB of the card, beside phase 7's ~50 in this
# process). Each run:
# (name, EngineConfig fields, steps); one step runs every leg of a
# synchronous path, the delayed run's second step is its first with a
# nonzero carry
P9_RANK_ARCH = "minicpm3-4b"
P9_RANK_LAYERS = 1
P9_RANK_RUNS = {
    4: (("span2_accum2_momentum", dict(span=2, backend="gspmd_tree",
                                       optimizer="momentum", accum_steps=2),
         1),
        ("span2_local2_sgd", dict(span=2, backend="gspmd_tree",
                                  optimizer="sgd", local_steps=2), 1)),
    2: (("mean_sgd", dict(combine="mean", optimizer="sgd"), 1),
        ("delay_momentum", dict(optimizer="momentum", combine_delay=1), 2)),
}


def _host_leaves(tree) -> list:
    from repro_torch import tree as T
    return [x.to("cpu", copy=True) for x in T.leaves(tree)]


def _delay_session(model, timer=None, impl="kernel", **fields):
    return _session(model, timer, impl, **{**dict(
        optimizer="momentum", span=P9_SPAN, backend="gspmd_tree",
        combine_delay=1), **fields})


def _timed_s(fn):
    """(fn(), wall seconds to the end of its work on the card)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _union(spans):
    """Sorted, merged copies of the (start, end) intervals `spans`."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _stream_trace(fn, path: Path) -> dict:
    """fn() under torch.profiler, its trace gzipped to `path`. Returns,
    in ms from the window's start: per CUDA stream its busy time (the
    union of its kernels, copies and sets), first and last activity and
    its three longest idle gaps; the time two or more streams were busy
    at once; per host thread its kernel launches and CUDA runtime time;
    and the runtime calls with the most time."""
    import gzip
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    raw = path.with_suffix("")
    prof.export_chrome_trace(str(raw))
    events = [e for e in json.loads(raw.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    with gzip.open(path, "wb") as f:
        f.write(raw.read_bytes())
    raw.unlink()
    start = min(e["ts"] for e in events)
    ms = lambda us: (us - start) / 1e3
    by_stream, runtime, threads = {}, {}, {}
    for e in events:
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            sid = (e.get("args") or {}).get("stream", e.get("tid"))
            by_stream.setdefault(str(sid), []).append(
                (ms(e["ts"]), ms(e["ts"] + e["dur"])))
        elif cat in ("cuda_runtime", "cuda_driver"):
            n, t = runtime.get(e["name"], (0, 0.0))
            runtime[e["name"]] = (n + 1, t + e["dur"] / 1e3)
            th = threads.setdefault(str(e.get("tid")), {
                "launches": 0, "runtime_ms": 0.0})
            th["runtime_ms"] += e["dur"] / 1e3
            th["launches"] += "LaunchKernel" in e["name"]
    streams, edges = {}, []
    for sid, spans in by_stream.items():
        merged = _union(spans)
        gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged,
                                                            merged[1:])),
                      reverse=True)[:3]
        streams[sid] = {"ops": len(spans),
                        "busy_ms": sum(b - a for a, b in merged),
                        "first_ms": merged[0][0], "last_ms": merged[-1][1],
                        "gaps_ms": [[at, g] for g, at in gaps]}
        edges += [(a, 1) for a, _ in merged] + [(b, -1) for _, b in merged]
    multi, live, prev = 0.0, 0, None
    for at, d in sorted(edges):
        if live >= 2:
            multi += at - prev
        live, prev = live + d, at
    top = sorted(runtime.items(), key=lambda kv: -kv[1][1])[:6]
    return {"wall_ms": 1e3 * wall, "streams": streams,
            "multi_stream_busy_ms": multi, "threads": threads,
            "runtime_top": [[k, n, t] for k, (n, t) in top]}


def _trace_line(tag: str, tr: dict) -> str:
    main = max(tr["streams"], key=lambda k: tr["streams"][k]["busy_ms"])
    parts = []
    for sid, st in sorted(tr["streams"].items(),
                          key=lambda kv: -kv[1]["busy_ms"]):
        parts.append(f"stream {sid}{' (main)' if sid == main else ''}: "
                     f"{st['ops']} ops busy {st['busy_ms']:.1f} ms from "
                     f"{st['first_ms']:.1f} to {st['last_ms']:.1f}, longest "
                     f"gaps {[[round(a, 1), round(g, 1)] for a, g in st['gaps_ms']]}")
    threads = {k: (v["launches"], round(v["runtime_ms"], 1))
               for k, v in tr["threads"].items()}
    runtime = [[k, n, round(t, 1)] for k, n, t in tr["runtime_top"]]
    return (f"{tag} round: wall {tr['wall_ms']:.1f} ms; "
            f"{'; '.join(parts)}; two streams busy at once "
            f"{tr['multi_stream_busy_ms']:.1f} ms; host threads (launches, "
            f"runtime ms) {threads}; runtime calls (count, ms) {runtime}")


@contextlib.contextmanager
def _triple_dtypes(seen: set):
    """Each CombineStats the combiners stack in the block adds the dtypes
    of its per-level dot triples to `seen` (taken before the cast to fp32
    that CombineStats makes, as the reference's does)."""
    from repro_torch.core import combine, rvh
    from repro_torch.engine import registry
    mods = (combine, rvh, registry)
    stack = combine.stack_stats

    def spy(collect):
        seen.update(str(t.dtype).replace("torch.", "") for t in collect)
        return stack(collect)
    for m in mods:
        m.stack_stats = spy
    try:
        yield seen
    finally:
        for m in mods:
            m.stack_stats = stack


def _alloc_counts() -> dict:
    """The caching allocator's counts of device allocations and frees and
    of allocations retried after it released cached memory, and the
    reserved GiB."""
    import torch
    st = torch.cuda.memory_stats()
    return {"device_allocs": st.get("num_device_alloc", 0),
            "device_frees": st.get("num_device_free", 0),
            "alloc_retries": st.get("num_alloc_retries", 0),
            "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}


def delayed_part(card: str, model, profile: bool = False) -> dict:
    """Phase 9 (a): the delayed combine on stacked lanes."""
    import torch
    from repro_torch import tree as T
    from repro_torch.core.combine import build_delayed_correction
    med = statistics.median
    n = model.cfg.param_count()
    lane_gb = 4 * n / 1e9
    rec = {"span": P9_SPAN, "params": n, "pending_gb": P9_SPAN * lane_gb,
           "pending_double_gb": 2 * P9_SPAN * lane_gb}
    print(f"[smoke] combiners (a) delayed momentum span={P9_SPAN}: pending "
          f"carry {P9_SPAN} x {lane_gb:.2f} GB fp32 = "
          f"{P9_SPAN * lane_gb:.2f} GB, double-buffered "
          f"{2 * P9_SPAN * lane_gb:.2f} GB (at span 4: "
          f"{8 * lane_gb:.1f} GB, over the {P9_MEM_GIB} GiB peak with the "
          f"params, state and a step) | {card}")
    torch.cuda.reset_peak_memory_stats()
    # the single-program step; the cold start; kernel vs plain correction
    s = _delay_session(model)
    zero = all(bool((x == 0).all()) for x in T.leaves(
        s.runtime.correction_fn(s.state["pending"])))
    single_ms = []
    for step in range(P9_STEPS):
        _, dt = _timed_s(lambda: s.step(s.batch(step)))
        single_ms.append(1e3 * dt)
        if step == 0:          # the step-1 carry: a real one
            corr, dt = _timed_s(
                lambda: s.runtime.correction_fn(s.state["pending"]))
            rec["correction_ms"] = 1e3 * dt
            kern = _host_leaves(corr)
            del corr
            plain = build_delayed_correction(s.runtime.dopt.cfg,
                                             impl="plain")(s.state["pending"])
            rec["correction_rel_err"] = max(
                _rel_err(x.cuda(), y) for x, y in zip(kern, T.leaves(plain)))
            del plain, kern
            _free()
    single = _checksums([s.state["params"], s.state["pending"]])
    rec["single_step_ms"] = single_ms
    rec["peak_gib_single"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rec["cold_start_zero"] = zero
    del s
    _free()
    # the stream (the correction on a thread and a CUDA stream of its own)
    # and the serial step from the same start, in turns, each taking the
    # state the other left: stream (the zero carry), serial, stream
    torch.cuda.reset_peak_memory_stats()
    s = _delay_session(model)
    stream = s.use_delayed_stream()

    def serial_round(step):
        s.state, _ = stream.serial_step(s.state, s.batch(step))
    compute, waits = [], []
    for step in range(P9_STEPS):
        if step % 2:
            serial_round(step)
            continue
        m = s.step(s.batch(step))
        compute.append(m["compute_s"])
        waits.append(m["combine_wait_s"])
    rec["stream_serial_bitwise"] = _checksums(
        [s.state["params"], s.state["pending"]]) == single
    rec["compute_s"], rec["combine_wait_s"] = compute, waits
    # the overlap, as benchmarks/delayed_combine.py measures it: latency
    # added to the exchange leg so one exchange ~ one local step (the last
    # stream round's, past the warm-up), then overlapped and serial
    # (exchange first) rounds in turns
    exch = med(stream.combine_time(s.state["pending"]) for _ in range(3))
    stream.comm_delay = max(compute[-1] - exch, 1e-3)
    combine_s = med(stream.combine_time(s.state["pending"])
                    for _ in range(3))
    out = ROOT / "chiprun_out"
    rec["trace"] = {}
    # a first overlapped round at this delay, untimed (traced with
    # --profile): its correction lands beside the local step's backward
    # for the first time
    step = P9_STEPS
    alloc0 = _alloc_counts()
    if profile:
        out.mkdir(exist_ok=True)
        rec["trace"]["first_overlapped"] = _stream_trace(
            lambda: s.step(s.batch(step)),
            out / "p9_first_overlapped_trace.json.gz")
    else:
        s.step(s.batch(step))
    step += 1
    alloc1 = _alloc_counts()
    overlap, serial = [], []
    for _ in range(P9_OVERLAP_ROUNDS):
        overlap.append(_timed_s(lambda: s.step(s.batch(step)))[1])
        serial.append(_timed_s(lambda: serial_round(step + 1))[1])
        step += 2
    alloc2 = _alloc_counts()
    rec["allocator"] = {
        "first_overlapped": {k: alloc1[k] - alloc0[k] for k in alloc0},
        "timed_rounds": {k: alloc2[k] - alloc1[k] for k in alloc0}}
    rec.update(exchange_exec_s=exch, injected_comm_delay_s=
               stream.comm_delay, combine_s=combine_s,
               overlap_step_s=overlap, serial_step_s=serial,
               overlap_median_s=med(overlap), serial_median_s=med(serial),
               hidden_fraction=(med(serial) - med(overlap)) / combine_s)
    if profile:            # one more round of each, traced
        rec["trace"].update(
            overlapped=_stream_trace(lambda: s.step(s.batch(step)),
                                     out / "p9_overlapped_trace.json.gz"),
            serial=_stream_trace(lambda: serial_round(step + 1),
                                 out / "p9_serial_trace.json.gz"))
        for tag, tr in rec["trace"].items():
            print(f"[smoke] combiners (a) profile {_trace_line(tag, tr)} "
                  f"| {card}")
    rec["peak_gib_stream"] = torch.cuda.max_memory_allocated() / 2 ** 30
    s.close()
    del s, stream
    _free()
    print(f"[smoke] combiners (a): single-program step_ms="
          f"{[round(x, 1) for x in single_ms]}; stream compute_s="
          f"{[round(x, 4) for x in compute]} combine_wait_s="
          f"{[round(x, 4) for x in waits]}; correction alone "
          f"{rec['correction_ms']:.1f} ms; with comm_delay "
          f"{rec['injected_comm_delay_s']:.4f} s, {P9_OVERLAP_ROUNDS} rounds "
          f"each: serial {[round(x, 4) for x in serial]} (median "
          f"{rec['serial_median_s']:.4f}) s, overlapped "
          f"{[round(x, 4) for x in overlap]} (median "
          f"{rec['overlap_median_s']:.4f}) s, exchange {combine_s:.4f} s, "
          f"hidden_fraction {rec['hidden_fraction']:.3f}; allocator over "
          f"the untimed first overlapped round {rec['allocator']['first_overlapped']}"
          f", over the timed rounds {rec['allocator']['timed_rounds']}; "
          f"peak_gib single "
          f"{rec['peak_gib_single']:.1f} stream {rec['peak_gib_stream']:.1f}"
          f" | {card}")
    print(f"[smoke] combiners (a): cold-start correction zero={zero}; "
          f"stream and serial rounds in turns bitwise="
          f"{rec['stream_serial_bitwise']}; correction kernel vs plain "
          f"rel_err={rec['correction_rel_err']:.3e} (tol {COMBINED_RTOL})")
    assert zero, "the step-0 correction of the zero carry is not zero"
    assert rec["stream_serial_bitwise"], \
        "stream and serial rounds differ from single-program"
    assert rec["correction_rel_err"] <= COMBINED_RTOL, rec
    assert max(rec["peak_gib_single"], rec["peak_gib_stream"]) \
        <= P9_MEM_GIB, rec
    return rec


def fp64_part(card: str, model, sync_sums=None) -> dict:
    """Phase 9 (b): two steps of phase 5's first train run (momentum,
    span 4) with fp64 dots, kernel arm and plain arm, beside fp32. The
    fp32 run names combine_delay=0: it builds no delayed piece and its
    first step is bitwise phase 5's synchronous one (`sync_sums`, its
    params checksums; None when phase 5 did not run)."""
    import torch
    from repro_torch import tree as T
    optimizer, span = TRAIN_RUNS[0]
    rec = {}
    runs = (("fp64_kernel", "float64", "kernel", {}),
            ("fp64_plain", "float64", "plain", {}),
            ("fp32_kernel", "float32", "kernel", {"combine_delay": 0}))
    base = None
    for tag, acc, impl, extra in runs:
        timer = _CombineTimer(keep=True, keep_on="cuda")
        torch.cuda.reset_peak_memory_stats()
        s = _session(model, timer, impl, optimizer=optimizer, span=span,
                     backend="gspmd_tree", acc_dtype=acc, **extra)
        rt = s.runtime
        delayed = "pending" in s.state or any(
            f is not None for f in (rt.correction_fn, rt.local_fn,
                                    rt.fold_fn))
        with _triple_dtypes(set()) as triples:
            s.step(s.batch(0))
            first = timer.take_ms()
            sums = _checksums(s.state["params"])
            s.step(s.batch(1))
        run = {"acc_dtype": acc, "impl": impl, "combine_ms_step1": first,
               "combine_ms_step2": timer.take_ms(),
               "triples_dtype": sorted(triples),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        p2 = T.leaves(s.state["params"])
        del s, rt
        _free()
        comb, levels = timer.kept
        run["levels_dtype"] = str(levels.dtype).replace("torch.", "")
        if base is None:
            base = (p2, comb, levels)
        else:
            run["combined_rel_err"] = max(
                _rel_err(x, y) for x, y in zip(base[1], comb))
            run["stats_rel_err"] = _rel_err(base[2], levels)
            run["params_max_abs_diff"] = max(
                (x - y).abs().max().item() for x, y in zip(base[0], p2))
        if extra:
            run["delayed_pieces"] = delayed
            run["sync_bitwise"] = (None if sync_sums is None
                                   else sums == sync_sums)
        rec[tag] = run
        del p2, comb, levels
    del base
    _free()
    kp, pp, fp = rec["fp64_kernel"], rec["fp64_plain"], rec["fp32_kernel"]
    print(f"[smoke] combiners (b) acc_dtype: combine ms (step 2) fp64 "
          f"kernel {kp['combine_ms_step2']:.1f}, fp64 plain "
          f"{pp['combine_ms_step2']:.1f}, fp32 kernel "
          f"{fp['combine_ms_step2']:.1f}; dot triples dtype "
          f"{[rec[t]['triples_dtype'] for t in rec]} (CombineStats levels "
          f"{[rec[t]['levels_dtype'] for t in rec]}); fp64 kernel vs plain: "
          f"combined rel_err={pp['combined_rel_err']:.3e} stats rel_err="
          f"{pp['stats_rel_err']:.3e} (tol {COMBINED_RTOL}) params (step 2) "
          f"max_abs_diff={pp['params_max_abs_diff']:.3e}; fp64 vs fp32 "
          f"params max_abs_diff={fp['params_max_abs_diff']:.3e}; fp32 "
          f"combine_delay=0: delayed pieces built={fp['delayed_pieces']}, "
          f"step 1 bitwise phase 5's synchronous step="
          f"{'not checked (phase 5 did not run)' if sync_sums is None else fp['sync_bitwise']}"
          f" | {card}")
    assert pp["combined_rel_err"] <= COMBINED_RTOL, rec
    assert pp["stats_rel_err"] <= COMBINED_RTOL, rec
    assert pp["params_max_abs_diff"] <= TRAIN_PARAM_TOL, rec
    assert [rec[t]["triples_dtype"] for t in rec] == [
        ["float64"], ["float64"], ["float32"]], \
        "the dots were summed in another dtype"
    assert not fp["delayed_pieces"], "combine_delay=0 built delayed pieces"
    assert fp["sync_bitwise"] in (None, True), \
        "combine_delay=0 differs from the synchronous step"
    return rec


def combiners_worker(spec: dict) -> int:
    """One rank of phase 9 (c) (its own process, all on cuda:0 over
    gloo): every run of P9_RANK_RUNS[world] for its steps through
    `TrainSession`, params checked bitwise across the ranks after every
    step; writes a JSON record."""
    import math
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.parallel.comm import Comm
    world, rank = spec["world"], int(os.environ["RANK"])
    cfg = dataclasses.replace(get_config(P9_RANK_ARCH),
                              n_layers=P9_RANK_LAYERS)
    model = build_model(cfg, compute_dtype=torch.bfloat16,
                        param_dtype=torch.float32)
    comm = Comm.init("gloo", torch.device("cuda:0"))
    build.reset_launches()
    runs = []
    for name, fields, steps in P9_RANK_RUNS[world]:
        torch.cuda.reset_peak_memory_stats()
        timer = _CombineTimer()
        t0 = time.perf_counter()
        s = _session(model, timer, device="cuda:0", comm=comm,
                     global_batch=RANK_BATCH, arch=P9_RANK_ARCH, **fields)
        run = {"name": name, "init_s": time.perf_counter() - t0,
               "path": s.runtime.combine_path,
               "point": s.runtime.dopt.point, "steps": []}
        comm.timing = True
        comm.take_ms()
        for step in range(steps):
            staged0 = comm.total_staged_bytes()
            m, dt = _timed_s(lambda: s.step(s.batch(step)))
            run["steps"].append({
                "ms": 1e3 * dt, "loss": m["loss"],
                "finite": math.isfinite(m["loss"]),
                "combine_ms": timer.take_ms(), "comm": comm.take_ms(),
                "staged_bytes": comm.total_staged_bytes() - staged0,
                "bitwise_across_ranks": _all_equal(
                    _checksums(s.state["params"]))})
            print(f"[rank {rank}] {name} step {step} {1e3 * dt:.0f} ms",
                  flush=True)
        comm.timing = False
        run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        s.state = None
        del s
        comm.free_buffers()
        _free()
        runs.append(run)
    rec = {"rank": rank, "world": world, "runs": runs,
           "launches": dict(build.LAUNCHES)}
    comm.close()
    Path(spec["out"]).write_text(json.dumps(rec, default=str))
    return 0


def combiners_phase(card: str, profile: bool = False,
                    sync_sums=None, beside=None) -> dict:
    """Phase 9: the delayed combine on stacked lanes, fp64 dots, and mean,
    accumulation, local steps and the delayed combine across ranks (one
    launch a world, in turn, `beside()` in this process meanwhile; its
    result under "beside")."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("gemma-7b"), n_layers=TRAIN_LAYERS)
    model = build_model(cfg, compute_dtype=torch.bfloat16,
                        param_dtype=torch.float32)
    build.reset_launches()
    print(f"[smoke] combiners: before the phase this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved | {card}")
    part_s = {}
    rec = {"delayed": delayed_part(card, model, profile)}
    part_s["a"] = time.perf_counter() - t_phase
    rec["acc_dtype"] = fp64_part(card, model, sync_sums)
    part_s["b"] = time.perf_counter() - t_phase - part_s["a"]
    launches = dict(build.LAUNCHES)
    del model
    _free()
    worlds = sorted(P9_RANK_RUNS, reverse=True)
    print(f"[smoke] combiners (c) ranks: gloo over host memory, every rank "
          f"on cuda:0, one launch a world, in turn"
          f"{'; phase 7 in this process meanwhile' if beside else ''}; this "
          f"process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
          f"reserved | {card}")
    got = {}

    def launches_in_turn():
        for w in worlds:
            t0 = time.perf_counter()
            got[w] = _spawn_ranks(w, f"combiners_w{w}", {"world": w},
                                  flag="--combiners-worker")
            part_s[f"c_world{w}"] = time.perf_counter() - t0

    if beside is None:
        launches_in_turn()
    else:
        # the launches from a thread that only starts and watches the
        # rank processes; `beside` keeps this thread (phase 7 installs a
        # signal handler, which only the main thread may)
        def watch():
            try:
                launches_in_turn()
            except BaseException as e:          # re-raised below
                got["error"] = e
        th = threading.Thread(target=watch, name="p9c-ranks")
        th.start()
        try:
            rec["beside"] = beside()
        finally:
            th.join()
        if "error" in got:
            raise got["error"]
    ranks = {}
    for world in worlds:
        recs = got[world]
        for k in ("block_dots", "block_combine"):   # rank 0's
            launches[k] += recs[0]["launches"][k]
        for i, (name, fields, steps) in enumerate(P9_RANK_RUNS[world]):
            runs = [r["runs"][i] for r in recs]
            # the last step over ranks
            mean = lambda f: statistics.mean(f(run["steps"][-1])
                                             for run in runs)
            part = lambda key: mean(lambda st: st["comm"].get(key, 0.0))
            peaks = [run["peak_gib"] for run in runs]
            out = {"world": world, "fields": fields, "steps": steps,
                   "path": runs[0]["path"], "point": runs[0]["point"],
                   "losses": [st["loss"] for st in runs[0]["steps"]],
                   "step_ms_each": [statistics.mean(
                       run["steps"][k]["ms"] for run in runs)
                       for k in range(steps)],
                   "step_ms": mean(lambda st: st["ms"]),
                   "combine_ms": mean(lambda st: st["combine_ms"]),
                   "exchange_ms": part("exchange"),
                   "allreduce_ms": part("allreduce"),
                   "staging_ms": part("stage"),
                   "dots_sum_ms": part("dots_sum"),
                   "staged_gb_per_step": mean(lambda st: st["staged_bytes"])
                   / 1e9,
                   "peak_gib": peaks, "peak_gib_sum": sum(peaks),
                   "init_s": max(run["init_s"] for run in runs),
                   "bitwise_across_ranks": all(
                       st["bitwise_across_ranks"] for run in runs
                       for st in run["steps"]),
                   "finite": all(st["finite"] for run in runs
                                 for st in run["steps"])}
            ranks[name] = out
            print(f"[smoke] combiners (c) world={world} {name} path="
                  f"{out['path']} point={out['point']}: step_ms="
                  f"{[round(x, 1) for x in out['step_ms_each']]}, the last:"
                  f" combine_ms={out['combine_ms']:.1f} "
                  f"exchange_ms={out['exchange_ms']:.1f} allreduce_ms="
                  f"{out['allreduce_ms']:.1f} (staging_ms="
                  f"{out['staging_ms']:.1f}; gloo host loopback) staged "
                  f"{out['staged_gb_per_step']:.2f} GB a step a rank; peak "
                  f"GiB a rank {[round(x, 2) for x in peaks]} (sum "
                  f"{sum(peaks):.1f}); init {out['init_s']:.1f} s; losses "
                  f"{[round(x, 4) for x in out['losses']]}; bitwise across "
                  f"ranks={out['bitwise_across_ranks']} | {card}")
            assert out["bitwise_across_ranks"], f"{name}: params differ"
            assert out["finite"], f"{name}: non-finite loss"
            assert sum(peaks) <= RANK_MEM_GIB, (name, peaks)
        ranks[f"wall_s_world{world}"] = part_s[f"c_world{world}"]
    rec["ranks"] = ranks
    rec["launches"] = launches
    rec["part_s"] = part_s
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[smoke] combiners launches={ {k: launches[k] for k in ('block_dots', 'block_combine')} } "
          f"parts { {k: round(v, 1) for k, v in part_s.items()} } s, "
          f"phase {rec['phase_s']:.1f}s | {card}")
    for k in ("block_dots", "block_combine"):
        assert launches[k] > 0, f"{k} never launched in phase 9"
    return rec


# ------------------------------------------------ layered subsystems phase
# (a) the adaptive-batch controller on one card: the train model, momentum,
# span P10_SPAN, batch P10_BATCH, capped at P10_MAX_BATCH; the real
# BatchController (warm-up 4) with P10_PATIENCE / P10_COOLDOWN resizes
# after step 4 at the earliest, so P10_STEPS leaves three steps at the new
# batch. P10_GROW_THRESHOLD puts the band (ema noise > threshold x batch)
# below any positive noise scale a step can measure
P10_SPAN = 2
P10_BATCH = 8
P10_MAX_BATCH = 16
P10_PATIENCE = 2
P10_COOLDOWN = 1
P10_STEPS = 8
P10_GROW_THRESHOLD = 1e-3
P10_MEM_GIB = 70
# (b) elastic ranks: phase 9 (c)'s model at world 4, sgd, span one lane
# a rank, one save of step P10_SAVE_STEP (no final save), a node loss at
# P10_LOSS_STEP whose boundary save is bit-flipped, capacity back after
# one step at world 2; P10_RANK_STEPS in all
P10_SAVE_STEP = 1
P10_LOSS_STEP = 2
P10_RANK_STEPS = 3
# (c) comm_spike: the delayed combine (phase 9 (a)'s run), an unspiked
# warm-up round, then P10_SPIKE_ROUNDS rounds: a spike of P10_SPIKE_S
# after each of them but the last in one run, none in the other
P10_SPIKE_ROUNDS = 3
P10_SPIKE_S = 0.5
# (d) serve chaos: phase 4's widths at P10_SERVE_LAYERS layers (the
# watched checkpoint is written twice and read back three times), 4
# slots, P10_PAGES pages of 16 rows (the six requests need ~70 at once),
# slow prefill, two requests with a deadline they cannot meet, a drain
P10_SERVE_LAYERS = 2
P10_PAGES = 40
P10_PREFILL_SLEEP_S = 0.02


def _mem() -> str:
    """This process's card memory: allocated, peak and reserved GiB."""
    import torch
    g = lambda b: f"{b / 2 ** 30:.2f}"
    return (f"{g(torch.cuda.memory_allocated())} GiB allocated, peak "
            f"{g(torch.cuda.max_memory_allocated())}, reserved "
            f"{g(torch.cuda.memory_reserved())}")


def _p10_dir(name: str) -> Path:
    import shutil
    d = ROOT / "build" / name               # gitignored, beside the kernels
    shutil.rmtree(d, ignore_errors=True)
    return d


class _P10Record:
    """A Callback (duck-typed) recording, on this process: each step's
    start (step, the session's dp, rows, batch checksum), each step's
    seconds and params checksums, each fit start (start, dp, span, the
    restore's timings and the wall since the last boundary), and each
    session's checkpoint manager (its save timings; not the session,
    whose state would then outlive it)."""

    def __init__(self):
        self.seen, self.rows, self.sums, self.dps = [], [], {}, []
        self.steps, self.digests, self.managers = [], {}, []
        self.boundary_t = None
        self.replayed_equal = True

    def on_fit_start(self, session, start):
        ck = session.checkpoint
        self.managers.append(ck)
        print(f"[rank {os.environ.get('RANK', 0)}] fit start {start} at dp "
              f"{session.runtime.dp_total}: {_mem()}", flush=True)
        self.dps.append({"start": start, "dp": session.runtime.dp_total,
                         "span": session.runtime.span,
                         "restore": dict(ck.timings) if ck else {},
                         "rebuild_s": (None if self.boundary_t is None else
                                       time.perf_counter() - self.boundary_t)})

    def on_step_start(self, session, step):
        import numpy as np
        tok = session.source.batch(step)["tokens"]
        key = float(np.asarray(tok, np.float64).sum())
        self.replayed_equal &= self.sums.setdefault(step, key) == key
        self.seen.append(step)
        self.rows.append((step, session.config.global_batch, tok.shape[0]))

    def on_step_end(self, session, step, metrics, dt):
        log = session.elastic_log or {}
        seg = (log.get("restarts", 0) + log.get("grow_backs", 0)
               + len(session.resize_log))
        self.steps.append({"step": step, "dp": session.runtime.dp_total,
                           "batch": session.config.global_batch, "s": dt,
                           "noise_scale": metrics.get("noise_scale")})
        self.digests[f"{seg}:{step}"] = _checksums(session.state["params"])
        print(f"[rank {os.environ.get('RANK', 0)}] step {step} at dp "
              f"{session.runtime.dp_total} {1e3 * dt:.0f} ms: {_mem()}",
              flush=True)

    def on_fit_end(self, session, history):
        pass

    def boundary(self, session, sig):
        """`on_restart` hook: the boundary save has just ended."""
        self.boundary_t = time.perf_counter()


def _p10_adaptive(card: str, model) -> dict:
    """(a): fit_adaptive on one card with the real BatchController."""
    import torch
    from repro_torch.control import (BatchController, ControllerConfig,
                                     fit_adaptive)
    from repro_torch.engine import EngineConfig
    from repro_torch.kernels import build
    from repro_torch.runtime import plan_grow
    cfg = EngineConfig(arch="gemma-7b", seq_len=512, global_batch=P10_BATCH,
                       fusion_threshold_mb=64, optimizer="momentum",
                       span=P10_SPAN, backend="gspmd_tree", log_every=1,
                       ckpt_every=0, adaptive_batch=True,
                       grow_threshold=P10_GROW_THRESHOLD,
                       grow_patience=P10_PATIENCE,
                       grow_cooldown=P10_COOLDOWN,
                       max_global_batch=P10_MAX_BATCH,
                       ckpt_dir=str(_p10_dir("p10_adaptive")))

    class Scripted(BatchController):
        """The reference's scripted growth (tests/test_chaos.py): the
        machinery under test when the noise scale reads 0."""

        def observe(self, step, metrics):
            # where warm-up 4 and patience 2 let the real one resize
            if step == 4 and self.global_batch == P10_BATCH:
                return plan_grow(self.global_batch, self.span, self.dp_total,
                                 self.lr, max_global_batch=P10_MAX_BATCH)
            return None

    out = {}
    for mode in ("controller", "scripted"):
        rec = _P10Record()
        ctrl = (None if mode == "controller" else Scripted(
            ControllerConfig.from_engine(cfg), global_batch=P10_BATCH,
            span=P10_SPAN, dp_total=1, lr=cfg.lr))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        hist, sess = fit_adaptive(cfg, P10_STEPS, callbacks=[rec],
                                  controller=ctrl, model=model,
                                  device="cuda", generator=torch.Generator(
                                      device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # the last session stays reachable from the SIGTERM handler its
        # fit installed (10.7 GB of params and momentum on the card)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        launches = dict(build.LAUNCHES)
        noise = [st["noise_scale"] for st in rec.steps]
        print(f"[smoke] p10 (a) {mode}: noise_scale a step {noise} "
              f"(band: ema > {P10_GROW_THRESHOLD:g} x batch) | {card}")
        if mode == "controller" and not sess.resize_log:
            print(f"[smoke] p10 (a) FINDING: the noise scale at random "
                  f"weights never entered the band ({noise}); the same "
                  f"machinery with a scripted plan follows | {card}")
            out["controller_finding"] = {"noise_scale": noise}
            sess.close()
            del sess, rec
            _free()
            continue
        first = rec.managers[0]
        plan = sess.resize_log[0]
        at = plan["step"]
        before = [st["s"] for st in rec.steps if 0 < st["step"] < at]
        after = [st["s"] for st in rec.steps if st["step"] > at]
        res = {"mode": mode, "resize_step": at, "plan": plan,
               "resizes": len(sess.resize_log), "noise_scale": noise,
               "seen": rec.seen, "rows": rec.rows,
               "save_stall_s": first.timings.get("snapshot_s"),
               "write_s": first.timings.get("write_s"),
               "write_gb": first.timings.get("write_bytes", 0) / 1e9,
               "restore": rec.dps[-1]["restore"],
               "rebuild_s": wall - sum(st["s"] for st in rec.steps),
               "step_ms_before": 1e3 * statistics.median(before),
               "step_ms_after": 1e3 * statistics.median(after),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "launches": launches, "wall_s": wall,
               "losses": [h["loss"] for h in hist], "lr": sess.config.lr}
        rows = {s: n for s, _, n in rec.rows}
        print(f"[smoke] p10 (a) {mode}: resize at step {at}: batch "
              f"{plan['old_batch']}->{plan['new_batch']} span "
              f"{plan['old_span']}->{plan['new_span']} lr "
              f"{plan['old_lr']:g}->{plan['new_lr']:g} ({plan['reason']}); "
              f"save stall {res['save_stall_s']:.2f} s, write "
              f"{res['write_s']:.2f} s ({res['write_gb']:.2f} GB), restore "
              f"load/crc/copy {res['restore'].get('load_s', 0):.2f}/"
              f"{res['restore'].get('crc_s', 0):.2f}/"
              f"{res['restore'].get('copy_s', 0):.2f} s; step ms "
              f"{res['step_ms_before']:.1f} -> {res['step_ms_after']:.1f}; "
              f"rows {rows[at - 1]} -> {rows[at]}; peak "
              f"{res['peak_gib']:.2f} GiB; launches "
              f"{ {k: launches[k] for k in ('block_dots', 'block_combine')} }"
              f"; wall {wall:.1f} s | {card}")
        assert rec.seen == list(range(P10_STEPS)), rec.seen
        assert [h["step"] for h in hist] == list(range(P10_STEPS))
        assert rows[at] == 2 * rows[at - 1] == P10_MAX_BATCH, rec.rows
        assert (plan["new_batch"], plan["old_span"], plan["new_span"]) == \
            (P10_MAX_BATCH, P10_SPAN, P10_SPAN), plan
        assert sess.config.lr == plan["new_lr"] >= plan["old_lr"]
        assert all(math.isfinite(x) for x in res["losses"])
        assert res["peak_gib"] <= P10_MEM_GIB, res["peak_gib"]
        assert launches["block_dots"] > 0 and launches["block_combine"] > 0
        sess.close()
        del sess, rec, first
        _free()
        out.update(res)
        break
    return out


def _p10_spike(card: str, model) -> dict:
    """(c): comm_spike through DelayedCombineStream is latency-only."""
    import torch
    from repro_torch.chaos import ChaosCallback, ChaosSchedule, FaultEvent
    from repro_torch.kernels import build
    runs = {}
    launches = {"block_dots": 0, "block_combine": 0}
    for name in ("spiked", "plain"):
        # a spike after round r slows round r + 1's exchange: rounds 1..3
        # follow an unspiked warm-up round 0, and the spikes after rounds
        # 1..2 slow rounds 2..3
        events = ([FaultEvent(r, "comm_spike", P10_SPIKE_S)
                   for r in range(1, P10_SPIKE_ROUNDS)]
                  if name == "spiked" else [])
        build.reset_launches()
        s = _delay_session(model, optimizer="momentum", span=P9_SPAN,
                           backend="gspmd_tree")
        stream = s.use_delayed_stream(comm_delay=0.0)
        s.fit(1)
        s.callbacks = [ChaosCallback(ChaosSchedule(events))]
        hist = s.fit(1 + P10_SPIKE_ROUNDS)
        torch.cuda.synchronize()
        runs[name] = {"round_s": [h["s"] for h in hist],
                      "combine_wait_s": [h["combine_wait_s"] for h in hist],
                      "delay_after": stream.comm_delay,
                      "sums": _checksums([s.state["params"],
                                          s.state["pending"]])}
        for k in launches:
            launches[k] += build.LAUNCHES[k]
        s.close()
        s.state = None
        del s, stream
        _free()
    sp, pl = runs["spiked"], runs["plain"]
    out = {"spike_s": P10_SPIKE_S, "rounds": P10_SPIKE_ROUNDS,
           "spiked_round_s": sp["round_s"], "plain_round_s": pl["round_s"],
           "spiked_wait_s": sp["combine_wait_s"],
           "plain_wait_s": pl["combine_wait_s"],
           "bitwise": sp["sums"] == pl["sums"], "launches": launches}
    print(f"[smoke] p10 (c) comm_spike {P10_SPIKE_S:g} s after rounds "
          f"1..{P10_SPIKE_ROUNDS - 1} (round 0 a warm-up): rounds 1.."
          f"{P10_SPIKE_ROUNDS} ms spiked "
          f"{[round(1e3 * x, 1) for x in sp['round_s']]} (wait "
          f"{[round(1e3 * x, 1) for x in sp['combine_wait_s']]}) vs plain "
          f"{[round(1e3 * x, 1) for x in pl['round_s']]}; params and carry "
          f"bitwise={out['bitwise']} | {card}")
    assert out["bitwise"], "comm_spike changed the math"
    assert sp["delay_after"] == 0.0
    assert min(sp["round_s"][1:]) >= P10_SPIKE_S, sp["round_s"]
    return out


def _p10_serve(card: str) -> dict:
    """(d): serve chaos on the serve model at P10_SERVE_LAYERS layers."""
    import numpy as np
    import torch
    from repro_torch.chaos import bitflip_leaf, slow_prefill
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.engine import (EngineConfig, GenerationRequest,
                                    ServeEngine)
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("qwen3-32b"),
                              n_layers=P10_SERVE_LAYERS)
    model = build_model(cfg, compute_dtype=torch.bfloat16,
                        param_dtype=torch.bfloat16)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    mgr = CheckpointManager(_p10_dir("p10_serve"), keep=5)
    t0 = time.perf_counter()
    for step in (1, 2):
        mgr.save(step, {"params": params})
    save_s = time.perf_counter() - t0
    hit = bitflip_leaf(mgr.root)
    ecfg = EngineConfig(max_slots=4, max_len=512, page_size=16,
                        kv_pages=P10_PAGES, pressure_ladder=True,
                        hot_reload=True, ckpt_dir=str(mgr.root),
                        param_dtype="bfloat16")
    eng = ServeEngine(ecfg, model, params, checkpoint=mgr)
    undo = slow_prefill(eng, P10_PREFILL_SLEEP_S)
    rng = np.random.RandomState(SEED)
    V = cfg.vocab_size
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.submit(GenerationRequest(
        rng.randint(0, V, int(rng.randint(150, 200))), max_new_tokens=24,
        deadline_s=(1e-3 if i in (1, 4) else None))) for i in range(6)]
    for _ in range(3):
        eng.step()
    late = eng.submit(GenerationRequest(rng.randint(0, V, 120),
                                        max_new_tokens=8))
    eng.request_drain()
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    undo()
    launches = dict(build.LAUNCHES)
    tp = eng.throughput()
    reasons = [h.finish_reason for h in handles + [late]]
    leaked = eng.leaked_pages()
    eng.flush_prefix()
    out = {"layers": P10_SERVE_LAYERS, "kv_pages": P10_PAGES,
           "bitflipped_step": hit, "loaded_step": eng.loaded_step,
           "restore_fallbacks": tp["restore_fallbacks"],
           "quarantined": [q["step"] for q in mgr.quarantined],
           "reasons": reasons, "terminal": all(
               h.done for h in handles + [late]),
           "completed": tp["completed"], "failed": tp["failed"],
           "deadline_kills": tp["deadline_kills"],
           "drained": tp["drained"], "preemptions": tp["preemptions"],
           "degradation_changes": tp["degradation_changes"],
           "leaked_after_drain": leaked,
           "pages_used_after_flush": eng._pool.pages_used,
           "save_s_two_steps": save_s, "wall_s": wall,
           "launches": launches}
    print(f"[smoke] p10 (d) serve chaos, {cfg.name} at "
          f"{P10_SERVE_LAYERS} layers, kv_pages={P10_PAGES}, slow prefill "
          f"{P10_PREFILL_SLEEP_S:g} s: finish reasons {reasons}; "
          f"completed={tp['completed']} deadline_kills="
          f"{tp['deadline_kills']} drained={tp['drained']} preemptions="
          f"{tp['preemptions']} ladder changes="
          f"{tp['degradation_changes']}; hot-reload: step {hit} bit-flipped"
          f", serving step {eng.loaded_step} (fallbacks "
          f"{tp['restore_fallbacks']}, quarantined {out['quarantined']}); "
          f"leaked {leaked} after drain, pages used "
          f"{out['pages_used_after_flush']} after flush; launches "
          f"{ {k: launches[k] for k in ('flash_attention', 'paged_decode_attention')} }"
          f"; wall {wall:.1f} s | {card}")
    assert out["terminal"], reasons
    assert out["loaded_step"] == 1 and out["restore_fallbacks"] == 1
    assert out["quarantined"] == [2] and hit == 2
    assert leaked == 0 and out["pages_used_after_flush"] == 0
    assert out["deadline_kills"] >= 1
    assert launches["flash_attention"] > 0 \
        and launches["paged_decode_attention"] > 0
    eng.close()
    del eng, params, model, undo, handles, late
    _free()
    return out


def elastic_worker(spec: dict) -> int:
    """One rank of phase 10 (b) (its own process, all on cuda:0 over
    gloo): fit_elastic with a node loss, a bit-flipped boundary save and
    capacity returning; writes a JSON record."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.chaos import (CapacityReturnCallback, ChaosCallback,
                                   ChaosSchedule, FaultEvent,
                                   make_chaos_on_restart)
    from repro_torch.configs import get_config
    from repro_torch.engine import EngineConfig, fit_elastic
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.parallel.comm import Comm
    rank = int(os.environ["RANK"])
    cfg = dataclasses.replace(get_config(P9_RANK_ARCH),
                              n_layers=P9_RANK_LAYERS)
    model = build_model(cfg, compute_dtype=torch.bfloat16,
                        param_dtype=torch.float32)
    comm = Comm.init("gloo", torch.device("cuda:0"))
    ecfg = EngineConfig(arch=P9_RANK_ARCH, seq_len=512,
                        global_batch=RANK_BATCH,
                        fusion_threshold_mb=64, optimizer="sgd",
                        ckpt_every=0, log_every=1, elastic=True,
                        ckpt_dir=spec["dir"])
    sched = ChaosSchedule([FaultEvent(P10_LOSS_STEP, "node_loss"),
                           FaultEvent(0, "ckpt_bitflip")])
    rec = _P10Record()
    hook = make_chaos_on_restart(sched, spec["dir"])

    def on_restart(session, sig):
        hook(session, sig)
        rec.boundary(session, sig)

    class SaveAt:
        """The periodic save the fallback lands on, and no final save."""

        def on_fit_start(self, session, start): ...

        def on_step_start(self, session, step): ...

        def on_fit_end(self, session, history): ...

        def on_step_end(self, session, step, metrics, dt):
            if step + 1 == P10_SAVE_STEP:
                session.save(step + 1)

    cbs = [rec, SaveAt(), ChaosCallback(sched),
           CapacityReturnCallback(delay=1)]
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist, sess = fit_elastic(
        ecfg, P10_RANK_STEPS, callbacks=cbs, model=model, device="cuda:0",
        generator=torch.Generator(device="cuda:0").manual_seed(SEED),
        comm=comm, on_restart=on_restart)
    wall = time.perf_counter() - t0
    saves = [dict(ck.timings) for ck in rec.managers]
    out = {"rank": rank, "seen": rec.seen, "dps": rec.dps,
           "steps": rec.steps, "digests": rec.digests,
           "replayed_equal": rec.replayed_equal,
           "hist": [h["step"] for h in hist],
           "losses": [h["loss"] for h in hist], "log": sess.elastic_log,
           "resilience": sess.run_metadata()["resilience"],
           "lr": sess.config.lr, "dp": sess.runtime.dp_total,
           "pending": [e.kind for e in sched.pending()],
           "save_timings": saves, "wall_s": wall,
           "launches": dict(build.LAUNCHES),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    sess.close()
    comm.close()
    Path(spec["out"]).write_text(json.dumps(out, default=str))
    return 0


def _p10_elastic(card: str, beside) -> tuple:
    """(b): 4 -> 2 -> 4 gloo ranks on cuda:0 through fit_elastic, with
    `beside()` run in this process meanwhile; returns (b)'s record and
    what `beside` returned."""
    import shutil
    d = _p10_dir("p10_elastic")
    t0 = time.perf_counter()
    recs, got = _spawn_ranks(4, "elastic_w4", {"dir": str(d)},
                             flag="--elastic-worker", beside=beside)
    wall = time.perf_counter() - t0
    shutil.rmtree(d, ignore_errors=True)
    r0 = recs[0]
    keys = set().union(*(r["digests"] for r in recs))
    bitwise = all(len({json.dumps(r["digests"][k]) for r in recs
                       if k in r["digests"]}) == 1 for k in keys)
    at = {}
    for st in r0["steps"]:
        at.setdefault(st["dp"], []).append(1e3 * st["s"])
    log = r0["log"]
    gb = log["plans"][-1]
    decisions = lambda lg: [lg[k] for k in ("restarts", "grow_backs",
                                            "plans")]
    # rank 0's sessions: the restore each began with (none the first),
    # the last save each made (the boundary's, but the last session's)
    pick = lambda d, keys: {k: round(d[k], 2) for k in keys if k in d}
    segments = [{"start": x["start"], "dp": x["dp"], "span": x["span"],
                 "rebuild_s": (None if x["rebuild_s"] is None
                               else round(x["rebuild_s"], 2)),
                 "restore_s": pick(x["restore"], ("load_s", "crc_s",
                                                  "copy_s")),
                 "save_s": pick(sv, ("snapshot_s", "write_s"))}
                for x, sv in zip(r0["dps"], r0["save_timings"])]
    out = {"seen": r0["seen"], "dps": [(x["start"], x["dp"], x["span"])
                                       for x in r0["dps"]],
           "step_ms_by_dp": at, "resilience": r0["resilience"],
           "plans": log["plans"], "lr": r0["lr"], "segments": segments,
           "bitwise": bitwise,
           "replayed_equal": all(r["replayed_equal"] for r in recs),
           "peak_gib": [r["peak_gib"] for r in recs],
           "launches": r0["launches"], "wall_s": wall}
    print(f"[smoke] p10 (b) elastic, 4 gloo ranks on cuda:0 (loopback): "
          f"seen={out['seen']} fit starts (start, dp, span)={out['dps']}; "
          f"plans={log['plans']}; resilience={out['resilience']}; step ms "
          f"by dp { {k: [round(x, 1) for x in v] for k, v in at.items()} }; "
          f"rank 0's segments (rebuild s from the boundary's save to the "
          f"fit start, restore load/crc/copy s, boundary save snapshot/"
          f"write s) {segments}; peaks GiB "
          f"{[round(x, 2) for x in out['peak_gib']]}; params bitwise across "
          f"ranks every step={bitwise}; launches rank 0 "
          f"{ {k: r0['launches'][k] for k in ('block_dots', 'block_combine')} }"
          f"; wall {wall:.1f} s | {card}")
    steps = P10_RANK_STEPS
    want_seen = (list(range(P10_LOSS_STEP + 1))
                 + list(range(P10_LOSS_STEP - 1, steps)))
    assert r0["seen"] == want_seen, r0["seen"]
    assert out["dps"] == [(0, 4, 4), (P10_LOSS_STEP - 1, 2, 2),
                          (P10_LOSS_STEP, 4, 4)], out["dps"]
    assert out["replayed_equal"] and bitwise
    for r in recs:
        assert r["resilience"]["restore_fallbacks"] == 1, r["resilience"]
        assert r["resilience"]["quarantined_steps"] == [P10_LOSS_STEP]
        assert decisions(r["log"]) == decisions(log)
        assert r["lr"] == gb["new_lr"] and r["pending"] == []
        assert all(math.isfinite(x) for x in r["losses"])
    assert [p["kind"] for p in log["plans"]] == ["shrink", "grow_back"]
    assert sum(out["peak_gib"]) <= RANK_MEM_GIB, out["peak_gib"]
    assert r0["launches"]["block_dots"] > 0
    return out, got


def subsystems_phase(card: str, beside=None) -> dict:
    """Phase 10: the adaptive-batch controller, comm_spike, serve chaos and
    elastic shrink / grow-back across ranks (ROADMAP item 8); `beside()`
    runs in this process after serve chaos while the elastic ranks run,
    its result under "beside"."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    t_phase = time.perf_counter()
    part_s = {}
    cfg = dataclasses.replace(get_config("gemma-7b"), n_layers=TRAIN_LAYERS)
    model = build_model(cfg, compute_dtype=torch.bfloat16,
                        param_dtype=torch.float32)
    rec = {"adaptive": _p10_adaptive(card, model)}
    part_s["a"] = time.perf_counter() - t_phase
    print(f"[smoke] p10 (c): this process holds {_mem()} | {card}")
    t0 = time.perf_counter()
    rec["spike"] = _p10_spike(card, model)
    part_s["c"] = time.perf_counter() - t0
    del model
    _free()
    print(f"[smoke] p10 (b) ranks: gloo over host memory, every rank on "
          f"cuda:0, with (d) in this process meanwhile (its ~15 GiB beside "
          f"the ranks' ~14){', then phase 12' if beside else ''}; this "
          f"process holds {_mem()} | {card}")

    def serve_part():
        t = time.perf_counter()
        got = _p10_serve(card)
        part_s["d"] = time.perf_counter() - t
        if beside is not None:
            _free()
            t = time.perf_counter()
            rec["beside"] = beside()
            part_s["beside"] = time.perf_counter() - t
        return got

    t0 = time.perf_counter()
    rec["elastic"], rec["serve"] = _p10_elastic(card, serve_part)
    part_s["b"] = time.perf_counter() - t0
    launches = {k: rec["adaptive"]["launches"][k] + rec["spike"][
        "launches"][k] + rec["elastic"]["launches"][k]
        for k in ("block_dots", "block_combine")}
    launches.update({k: rec["serve"]["launches"][k]
                     for k in ("flash_attention", "paged_decode_attention")})
    rec["launches"] = launches
    rec["part_s"] = part_s
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[smoke] subsystems launches={launches} parts "
          f"{ {k: round(v, 1) for k, v in part_s.items()} } s, phase "
          f"{rec['phase_s']:.1f}s | {card}")
    return rec


# ------------------------------------------------- phase 11: the families
P11_MIXTRAL_LAYERS = 2      # of 56: 5.41 B params, 10.8 GB of bf16 weights
P11_MOONSHOT_LAYERS = 4     # of 48 (1 dense + 3 MoE): 2.46 B, 4.9 GB bf16
P11_TRAIN_MOONSHOT = 2      # 1 dense + 1 MoE: 1.28 B params in fp32
P11_TRAIN_MINICPM = 4       # of 62: 0.47 B params in fp32 (depth cut
                            # for the script's time limit)
P11_MINICPM_LAYERS = 8      # of 62, served (bf16): depth cut for the
                            # script's time limit
P11_MEM_GIB = 70
P11_GEN = 32
P11_SPEC_K = 4


class _RouteLog:
    """Every MoE routing decision inside the block: wraps
    `repro_torch.models.moe.top_k` (called once per `moe_apply`) and
    keeps, per call, the experts chosen [S, NL, K], each token's margin
    between its K-th and (K+1)-th router probability, and the (token, k)
    pairs past capacity (an expert's pairs beyond C, in arrival order).
    `tag` names the calls that follow (e.g. 'verify')."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.calls = []
        self.tag = ""

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = moe.top_k

        def top_k(probs, k):
            import torch
            vals, idx = self._orig(probs, k)
            with torch.no_grad():
                v1 = self._orig(probs, k + 1)[0]
                S, NL, E = probs.shape
                counts = torch.zeros(S, E, dtype=torch.long,
                                     device=probs.device)
                counts.scatter_add_(1, idx.reshape(S, -1),
                                    torch.ones_like(idx.reshape(S, -1)))
                cap = moe.capacity(self.cfg, NL)
                self.calls.append({
                    "tag": self.tag, "idx": idx.detach().clone(),
                    "gap": (v1[..., k - 1] - v1[..., k]).detach(),
                    "drops": (counts - cap).clamp(min=0).sum(),
                    "pairs": S * NL * k})
            return vals, idx
        moe.top_k = top_k
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.top_k = self._orig

    def take(self):
        out, self.calls = self.calls, []
        return out

    @staticmethod
    def drops(calls, tag=None) -> dict:
        sel = [c for c in calls if tag is None or c["tag"] == tag]
        d = sum(int(c["drops"]) for c in sel)
        p = sum(c["pairs"] for c in sel)
        return {"calls": len(sel), "pairs": p, "dropped": d,
                "drop_fraction": d / p if p else 0.0}


def _route_agreement(a, b) -> dict:
    """Two arms' routing over the same calls (same order): the share of
    (token, k) choices of `a` that `b` also made, the tokens whose expert
    sets differ, the smallest K-th / (K+1)-th margin of `b` (the plain
    arm) at such a flip, and per call the flipped token positions
    (`flip_rows`, over the call's tokens in order)."""
    assert len(a) == len(b), (len(a), len(b))
    hit = tot = flips = 0
    gaps, flip_rows = [], []
    for x, y in zip(a, b):
        same = (x["idx"][..., :, None] == y["idx"][..., None, :]).any(-1)
        hit += int(same.sum())
        tot += same.numel()
        bad = ~same.all(-1)                               # [S, NL]
        flips += int(bad.sum())
        if bool(bad.any()):
            gaps.append(float(y["gap"][bad].min()))
        flip_rows.append(bad.reshape(-1).nonzero()[:, 0].tolist())
    return {"choice_agreement": hit / tot if tot else 1.0,
            "flipped_tokens": flips,
            "min_gap_at_flip": min(gaps) if gaps else None,
            "flip_rows": flip_rows}


def _p11_build(name: str, layers: int, param_dtype: str):
    """(full config, cut config, kernel model, plain model) for a preset
    at full width, depth cut to `layers` (a MoE config's dense prefix
    kept; an encoder-decoder's both stacks)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    full = get_config(name)
    cfg = dataclasses.replace(full, n_layers=layers)
    if full.is_encoder_decoder:
        cfg = dataclasses.replace(cfg, n_encoder_layers=layers)
    dt = getattr(torch, param_dtype)
    model = build_model(cfg, compute_dtype=torch.bfloat16, param_dtype=dt)
    plain = build_model(cfg, compute_dtype=torch.bfloat16, param_dtype=dt,
                        attn_impl="plain")
    return full, cfg, model, plain


def _p11_init(model):
    import torch
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def _p11_serve_line(tag, eng, handles, launches, card,
                    phase: str = "p11") -> dict:
    import torch
    tp, kv = eng.throughput(), eng.kv_stats()
    res = {"completed": tp["completed"], "decode_steps": tp["decode_steps"],
           "prefill_calls": tp["prefill_calls"],
           "prefill_ms_mean": tp["prefill_ms_mean"],
           "decode_tick_ms_mean": tp["decode_tick_ms_mean"],
           "tok_s": tp["tok_s"], "prefix_hits": kv["prefix_hits"],
           "kv_page_bytes": kv["kv_page_bytes"],
           "peak_kv_bytes": kv["peak_kv_bytes_in_use"],
           "launches": launches,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "tokens": [h.tokens for h in handles]}
    print(f"[smoke] {phase} {tag}: completed={tp['completed']} prefill_calls="
          f"{tp['prefill_calls']} decode_steps={tp['decode_steps']} "
          f"prefix_hits={kv['prefix_hits']} prefill_ms="
          f"{tp['prefill_ms_mean']:.1f} decode_tick_ms="
          f"{tp['decode_tick_ms_mean']:.2f} tok_s={tp['tok_s']:.1f} "
          f"launches={launches} peak_mem_gib={res['peak_mem_gib']:.1f} "
          f"| {card}")
    assert eng.leaked_pages() == 0
    return res


def _p11_mixtral(card: str) -> dict:
    """(a) mixtral-8x22b serving: window 4096, a ~4,600-token prompt."""
    import numpy as np
    import torch
    from repro_torch.engine import EngineConfig, ServeEngine
    from repro_torch.engine.serving.slots import paged_insert_rows
    from repro_torch.kernels import build
    full, cfg, model, plain = _p11_build("mixtral-8x22b", P11_MIXTRAL_LAYERS,
                                         "bfloat16")
    params, init_s = _p11_init(model)
    print(f"[smoke] p11 (a) {cfg.name}: full width d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim="
          f"{cfg.resolved_head_dim} experts={cfg.n_experts}x"
          f"{cfg.moe_d_ff} top-{cfg.n_experts_per_tok} window="
          f"{cfg.sliding_window} vocab={cfg.vocab_size}; depth cut "
          f"{full.n_layers} -> {cfg.n_layers}; {cfg.param_count() / 1e9:.2f}B "
          f"params in bf16, init {init_s:.1f}s, {_mem()}")
    V = cfg.vocab_size
    rng = np.random.RandomState(SEED + 11)
    prompts = [rng.randint(0, V, n) for n in (4600, 300, 517, 812)]
    ecfg = EngineConfig(max_slots=4, max_len=8192, page_size=16,
                        param_dtype="bfloat16")
    eng = ServeEngine(ecfg, model, params)
    assert eng._pages_per_slot == 256, eng._pages_per_slot
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    build.reset_launches()
    with _RouteLog(cfg) as log:
        hs, wall = _timed(lambda: _greedy(eng, prompts, [1, 3], P11_GEN))
        launches = dict(build.LAUNCHES)
        serve_drops = _RouteLog.drops(log.take())
    res = _p11_serve_line("(a) serve mixtral", eng, hs, launches, card)
    res.update(wall_s=wall, drops=serve_drops, init_s=init_s)
    assert res["completed"] == 4 and all(len(h.tokens) == P11_GEN
                                         for h in hs)
    for k in ("flash_attention", "paged_decode_attention"):
        assert launches[k] > 0, f"{k} never launched on mixtral"
    del eng
    _free()

    # kernel arm vs plain arm. A router choice near a tie can flip
    # between the arms (bf16 attention rounds differently), moving that
    # token's output, and through attention and capacity the later
    # positions', by O(1); positions before a request's first flip (in
    # any layer) cannot see it. (1) the forward of each prompt: logits
    # held at every position before its first flip; (2) the serving
    # prefill of each prompt's agreeing prefix, then one decode of the
    # four slots over a paged cache: held on the rows whose routing
    # agrees in both calls
    L = cfg.n_layers
    fwd, routes = {}, {}
    for tag, m in (("kernel", model), ("plain", plain)):
        with _RouteLog(cfg) as log:
            fwd[tag] = [m.forward(params, torch.tensor(
                p[None].astype(np.int32), device="cuda"))[0].float()
                for p in prompts]
            routes[tag] = log.take()
    agree = _route_agreement(routes["kernel"], routes["plain"])
    first_flip = []
    for i, p in enumerate(prompts):
        bad = [j for l in range(L) for j in agree["flip_rows"][i * L + l]]
        first_flip.append(min(bad) if bad else len(p))
    held_err, all_err, n_held = 0.0, 0.0, 0
    for i in range(len(prompts)):
        d = (fwd["kernel"][i] - fwd["plain"][i]).abs().max(-1).values
        all_err = max(all_err, d.max().item())
        if first_flip[i]:
            held_err = max(held_err, d[:first_flip[i]].max().item())
            n_held += first_flip[i]
    del fwd
    print(f"[smoke] p11 (a) forward logits kernel vs plain: first routing "
          f"flip at positions {first_flip} of {[len(p) for p in prompts]}; "
          f"max_abs_err before it {held_err:.4f} over {n_held} positions "
          f"(tol {LOGIT_TOL}), over all positions {all_err:.4f}; (token, k)"
          f" choices agree {agree['choice_agreement']:.5f}, flipped tokens "
          f"{agree['flipped_tokens']}, smallest plain-arm router gap at a "
          f"flip {agree['min_gap_at_flip']} | {card}")
    assert n_held and held_err <= LOGIT_TOL, (held_err, first_flip)
    checks = {"forward": {"first_flip": first_flip, "positions_held": n_held,
                          "max_abs_err_held": held_err,
                          "max_abs_err_all": all_err, "tol": LOGIT_TOL}}
    cut = [p[:max(16, f)] for p, f in zip(prompts, first_flip)]
    cap = 4096
    pps = cap // 16
    out = {}
    for tag, m in (("kernel", model), ("plain", plain)):
        with _RouteLog(cfg) as log:
            lg, rows_all = [], []
            for p in cut:
                t = torch.tensor(p[None].astype(np.int32), device="cuda")
                n = torch.tensor([len(p)], dtype=torch.int32, device="cuda")
                logits, rows = m.prefill_cache(params, t, n, ecfg.max_len)
                lg.append(logits[:, -1].float())
                rows_all.append(rows)
            cache = m.init_cache(params, 4, ecfg.max_len,
                                 paged=(16, 4 * pps + 1))
            tables = (torch.arange(4 * pps, device="cuda", dtype=torch.int32)
                      .reshape(4, pps) + 1)
            for i, rows in enumerate(rows_all):
                paged_insert_rows(cache, rows, torch.tensor([i], device="cuda"),
                                  tables[i:i + 1], tables[i:i + 1])
            del rows_all
            if tag == "kernel":
                nxt = torch.cat(lg).argmax(-1).to(torch.int32)[:, None]
            dl, _ = m.decode_step(params, nxt, cache)
            out[tag] = (torch.cat(lg), dl[:, -1].float())
            routes[tag] = log.take()
            del cache
    # calls: prompt by prompt, layer by layer, then the decode's layers
    # (one row of the four slots' tokens)
    step_agree = _route_agreement(routes["kernel"], routes["plain"])
    pre_ok = [all(not step_agree["flip_rows"][i * L + l] for l in range(L))
              for i in range(len(cut))]
    dec_ok = [pre_ok[b] and all(b not in step_agree["flip_rows"][
        len(cut) * L + l] for l in range(L)) for b in range(4)]
    for i, step in enumerate(("prefill", "decode")):
        a, b = out["kernel"][i], out["plain"][i]
        assert a.shape == (4, V) and bool(torch.isfinite(a).all())
        rows_ok = pre_ok if step == "prefill" else dec_ok
        err = (a - b).abs().max(-1).values.tolist()
        held = [e for e, ok in zip(err, rows_ok) if ok]
        checks[step] = {"prompt_lens": [len(p) for p in cut],
                        "row_err": err, "routing_agrees": rows_ok,
                        "max_err_held": max(held) if held else None,
                        "tol": LOGIT_TOL}
        print(f"[smoke] p11 (a) {step} logits kernel vs plain on the "
              f"agreeing prefixes {[len(p) for p in cut]}: per-request "
              f"max_abs_err={[round(e, 4) for e in err]} routing agrees="
              f"{rows_ok} (tol {LOGIT_TOL} on the rows whose routing agrees)")
        assert held, f"{step}: no row with agreeing routing to hold"
        assert max(held) <= LOGIT_TOL, (step, err, rows_ok)
    print(f"[smoke] p11 (a) serve drops {serve_drops['dropped']}/"
          f"{serve_drops['pairs']} pairs | {card}")
    res["plain_checks"] = checks
    res["routing"] = {k: v for k, v in agree.items() if k != "flip_rows"}
    res.update(layers=cfg.n_layers, full_layers=full.n_layers,
               params_b=cfg.param_count() / 1e9)
    assert res["peak_mem_gib"] <= P11_MEM_GIB
    del params, model, plain, out, routes
    _free()
    return res


def _p11_moonshot(card: str) -> dict:
    """(b) moonshot-v1-16b-a3b serving: both cache segments, a shared
    system prompt, speculation with the derived draft."""
    import numpy as np
    import torch
    from repro_torch.engine import EngineConfig, ServeEngine
    from repro_torch.kernels import build
    full, cfg, model, _ = _p11_build("moonshot-v1-16b-a3b",
                                     P11_MOONSHOT_LAYERS, "bfloat16")
    params, init_s = _p11_init(model)
    print(f"[smoke] p11 (b) {cfg.name}: full width d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim="
          f"{cfg.resolved_head_dim} experts={cfg.n_experts}x{cfg.moe_d_ff} "
          f"top-{cfg.n_experts_per_tok} shared={cfg.n_shared_experts} "
          f"vocab={cfg.vocab_size}; depth cut {full.n_layers} -> "
          f"{cfg.n_layers} ({cfg.first_dense_layers} dense + "
          f"{cfg.n_layers - cfg.first_dense_layers} MoE); "
          f"{cfg.param_count() / 1e9:.2f}B params in bf16, init "
          f"{init_s:.1f}s, {_mem()}")
    V = cfg.vocab_size
    rng = np.random.RandomState(SEED + 12)
    system = rng.randint(0, V, 64)
    prompts = [np.concatenate([system, rng.randint(0, V, n)])
               for n in (183, 240, 97, 310)]
    base = dict(max_slots=4, max_len=1024, page_size=16,
                param_dtype="bfloat16")
    res = {"init_s": init_s}
    torch.cuda.reset_peak_memory_stats()
    streams = {}
    for k in (0, P11_SPEC_K):
        eng = ServeEngine(EngineConfig(speculation_k=k, **base), model,
                          params)
        with _RouteLog(cfg) as log:
            verify = eng._verify if k else None
            if k:
                def tagged(*a, _v=verify, _log=log):
                    _log.tag = "verify"
                    try:
                        return _v(*a)
                    finally:
                        _log.tag = ""
                eng._verify = tagged
            torch.cuda.synchronize()
            build.reset_launches()
            hs, wall = _timed(lambda: _greedy(eng, prompts, [1, 2, 1],
                                              P11_GEN))
            launches = dict(build.LAUNCHES)
            calls = log.take()
        tag = f"(b) serve moonshot spec_k={k}"
        run = _p11_serve_line(tag, eng, hs, launches, card)
        run.update(wall_s=wall, drops=_RouteLog.drops(calls))
        assert run["completed"] == 4
        assert run["prefix_hits"] > 0, "no prefix extend ran"
        # every prefill runs flash; a plain tick runs paged decode (spec
        # ticks verify through the plain attention, as the reference's)
        for name in ("flash_attention",) + (
                () if k else ("paged_decode_attention",)):
            assert launches[name] > 0, f"{name} never launched on moonshot"
        dense = eng.cache.dense_layers["attn"]
        pages = torch.tensor(sorted(eng._prefix.pages()), device="cuda")
        run["dense_segment_prefix_abs"] = float(
            dense.k[:, pages].float().abs().sum())
        assert run["dense_segment_prefix_abs"] > 0, \
            "the dense segment's prefix pages were never written"
        if k:
            tp = eng.throughput()
            run.update(spec_ticks=tp["spec_ticks"],
                       acceptance=tp["spec_acceptance_rate"],
                       dispatches_per_token=tp["dispatches_per_token"],
                       draft_layers=eng._draft_model.cfg.n_layers,
                       verify_drops=_RouteLog.drops(calls, "verify"))
            assert tp["spec_ticks"] > 0
        streams[k] = run["tokens"]
        res[f"spec{k}"] = run
        del eng
        _free()
    agree = _agreement(streams[P11_SPEC_K], streams[0])
    res["spec_vs_plain"] = agree
    s = res[f"spec{P11_SPEC_K}"]
    print(f"[smoke] p11 (b) spec k={P11_SPEC_K} (derived {s['draft_layers']}"
          f"-layer random draft) vs plain: equal share="
          f"{agree['equal_share']:.3f} first divergence="
          f"{agree['first_divergence']}; acceptance={s['acceptance']:.3f} "
          f"spec_ticks={s['spec_ticks']} target forwards/token="
          f"{s['dispatches_per_token']:.3f}; drops in verify forwards "
          f"{s['verify_drops']['dropped']}/{s['verify_drops']['pairs']} "
          f"pairs over {s['verify_drops']['calls']} MoE calls, all calls "
          f"{s['drops']['dropped']}/{s['drops']['pairs']} | {card}")
    res.update(layers=cfg.n_layers, full_layers=full.n_layers,
               params_b=cfg.param_count() / 1e9,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    assert res["peak_mem_gib"] <= P11_MEM_GIB
    del params, model
    _free()
    return res


def _p11_minicpm(card: str) -> dict:
    """(c) minicpm3-4b serving at P11_MINICPM_LAYERS layers: the latent
    cache, paged and dense."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import EngineConfig, ServeEngine
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("minicpm3-4b"),
                              n_layers=P11_MINICPM_LAYERS)
    model = build_model(cfg, compute_dtype=torch.bfloat16,
                        param_dtype=torch.bfloat16)
    params, init_s = _p11_init(model)
    print(f"[smoke] p11 (c) {cfg.name}: full width d_model={cfg.d_model} "
          f"heads={cfg.n_heads} q_lora={cfg.q_lora_rank} kv_lora="
          f"{cfg.kv_lora_rank} qk={cfg.qk_nope_head_dim}+"
          f"{cfg.qk_rope_head_dim} v={cfg.v_head_dim} vocab="
          f"{cfg.vocab_size}; depth cut 62 -> {cfg.n_layers}; "
          f"{cfg.param_count() / 1e9:.2f}B params in bf16, init "
          f"{init_s:.1f}s, {_mem()}")
    V = cfg.vocab_size
    rng = np.random.RandomState(SEED + 13)
    system = rng.randint(0, V, 64)
    prompts = [np.concatenate([system, rng.randint(0, V, n)])
               for n in (150, 233, 71, 288)]
    base = dict(max_slots=4, max_len=512, page_size=16,
                param_dtype="bfloat16")
    res = {"init_s": init_s}
    torch.cuda.reset_peak_memory_stats()
    for tag, kw in (("paged_shared", dict(kv_layout="paged")),
                    ("paged", dict(kv_layout="paged", prefix_sharing=False)),
                    ("dense", dict(kv_layout="dense"))):
        eng = ServeEngine(EngineConfig(**kw, **base), model, params)
        torch.cuda.synchronize()
        build.reset_launches()
        hs, wall = _timed(lambda: _greedy(eng, prompts, [1, 2, 1], P11_GEN))
        run = _p11_serve_line(f"(c) serve minicpm3 {tag}", eng, hs,
                              dict(build.LAUNCHES), card)
        run["wall_s"] = wall
        assert run["completed"] == 4
        if tag == "paged_shared":
            assert run["prefix_hits"] > 0
            run["latent_bytes_per_token"] = \
                run["kv_page_bytes"] / base["page_size"]
        res[tag] = run
        del eng
        _free()
    eq = _agreement(res["paged"]["tokens"], res["dense"]["tokens"])
    shared = _agreement(res["paged_shared"]["tokens"], res["dense"]["tokens"])
    shared["margins"] = _divergence_margins(
        model, params, prompts, res["paged_shared"]["tokens"],
        res["dense"]["tokens"], base["max_len"])
    lat = res["paged_shared"]["latent_bytes_per_token"]
    gqa = (cfg.n_layers * cfg.n_heads
           * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim + cfg.v_head_dim)
           * 2)
    res.update(dense_vs_paged=eq, shared_vs_dense=shared,
               gqa_bytes_per_token=gqa, layers=cfg.n_layers,
               params_b=cfg.param_count() / 1e9,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"[smoke] p11 (c) dense vs paged (no sharing): tokens equal="
          f"{eq['all_equal']}; paged with prefix sharing vs dense: equal "
          f"share={shared['equal_share']:.3f} first divergence="
          f"{shared['first_divergence']} margins="
          f"{[round(m, 4) for m in shared['margins']]}; latent cache "
          f"{lat:.0f} B/token against {gqa} B/token for a GQA cache of the "
          f"same heads (k {cfg.qk_nope_head_dim + cfg.qk_rope_head_dim}, "
          f"v {cfg.v_head_dim}, {cfg.n_heads} heads): {gqa / lat:.1f}x | "
          f"{card}")
    assert eq["all_equal"], "minicpm3: dense != paged"
    assert all(abs(m) <= LOGIT_TOL for m in shared["margins"]), shared
    assert res["peak_mem_gib"] <= P11_MEM_GIB
    del params, model
    _free()
    return res


def _p11_train(card: str, name: str, layers: int, optimizer: str,
               tag: str = "p11", seq: int = 512) -> dict:
    """Phase 11 (d)/(e) and phase 12 (e)-(h): three TrainSession steps at
    full width, span 2, seq `seq`, batch 8, then step 1 again on the
    kernel path (bitwise) and with combine_impl='plain' (held as phase 5
    holds it); the combined gradient must be finite."""
    import math
    import torch
    from repro_torch import tree as T
    from repro_torch.core import combine as C
    from repro_torch.kernels import build
    full, cfg, model, _ = _p11_build(name, layers, "float32")
    span = 2
    fields = dict(arch=name, optimizer=optimizer, span=span,
                  backend="gspmd_tree", seq_len=seq)
    extra = (f", {cfg.frontend_tokens} patch positions" if cfg.frontend_tokens
             else f", {seq // 2} frames ({cfg.n_encoder_layers} of "
             f"{full.n_encoder_layers} encoder layers)"
             if cfg.is_encoder_decoder else "")
    print(f"[smoke] {tag} train {cfg.name}: full width d_model={cfg.d_model},"
          f" depth cut {full.n_layers} -> {layers}"
          + (f" ({cfg.first_dense_layers} dense + "
             f"{layers - cfg.first_dense_layers} MoE)" if cfg.n_experts
             else "")
          + f"; {cfg.param_count() / 1e9:.3f}B params in fp32, bf16 "
          f"compute, seq {seq}{extra}, batch 8, {optimizer} span {span}")
    timer = _CombineTimer()
    torch.cuda.reset_peak_memory_stats()
    s = _session(model, timer, **fields)
    leaves = T.leaves(s.state["params"])
    plan = C.fused_plan([x.expand((span,) + tuple(x.shape)) for x in leaves],
                        C.CombineConfig(
                            fusion_threshold_mb=s.config.fusion_threshold_mb))
    per_step = len(plan)                  # one tree level at span 2
    steps = []
    torch.cuda.synchronize()
    build.reset_launches()
    with _RouteLog(cfg) as log:
        for step in range(3):
            t0 = time.perf_counter()
            m = s.step(s.batch(step))
            torch.cuda.synchronize()
            steps.append({"step": step,
                          "ms": 1e3 * (time.perf_counter() - t0),
                          "combine_ms": timer.take_ms(),
                          "loss": float(m["loss"]), "aux": float(m["aux"])})
            if step == 0:
                p1 = [x.to("cpu", copy=True) for x in leaves]
        drops = _RouteLog.drops(log.take())
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    meta = s.runtime.combine_path, s.runtime.dopt.point
    del s, leaves
    _free()
    for st in steps:
        assert math.isfinite(st["loss"]) and math.isfinite(st["aux"]), st
    for k in ("block_dots", "block_combine"):
        assert launches[k] == 3 * per_step, (name, k, launches[k], per_step)
    p1 = [x.cuda() for x in p1]
    again, (g_kern, lv_kern) = _step_once(model, optimizer, span, arch=name,
                                          seq_len=seq)
    bitwise = all(torch.equal(x, y) for x, y in zip(p1, again))
    finite = all(bool(torch.isfinite(x).all()) for x in g_kern)
    del again
    _free()
    plain, (g_plain, lv_plain) = _step_once(model, optimizer, span,
                                            combine_impl="plain", arch=name,
                                            seq_len=seq)
    err = max((x - y).abs().max().item() for x, y in zip(p1, plain))
    comb_err = max(_rel_err(x, y) for x, y in zip(g_kern, g_plain))
    stats_err = max(_rel_err(x, y) for x, y in zip(lv_kern, lv_plain))
    del plain, p1, g_kern, g_plain
    _free()
    ms = statistics.mean(st["ms"] for st in steps[1:])
    comb = statistics.mean(st["combine_ms"] for st in steps[1:])
    run = {"arch": name, "layers": layers, "full_layers": full.n_layers,
           "params_b": cfg.param_count() / 1e9, "optimizer": optimizer,
           "span": span, "point": meta[1], "combine_path": meta[0],
           "buckets": len(plan), "launches": launches, "steps": steps,
           "step_ms_steady": ms, "combine_ms_steady": comb,
           "combine_share": comb / ms, "peak_mem_gib": peak, "drops": drops,
           "bitwise_repeat": bitwise, "plain_max_abs_err": err,
           "combined_rel_err": comb_err, "stats_rel_err": stats_err,
           "grads_finite": finite, "seq": seq}
    print(f"[smoke] {tag} train {name} {optimizer} span={span} "
          f"point={meta[1]}"
          f" path={meta[0]} buckets={len(plan)} launches="
          f"{ {k: launches[k] for k in ('block_dots', 'block_combine')} } "
          f"losses={[round(st['loss'], 4) for st in steps]} aux="
          f"{[round(st['aux'], 4) for st in steps]} drop_fraction="
          f"{drops['drop_fraction']:.4f} ({drops['dropped']}/{drops['pairs']}"
          f" pairs)")
    print(f"[smoke] {tag} train {name}: step_ms="
          f"{[round(st['ms'], 1) for st in steps]} steady_ms={ms:.1f} "
          f"combine_ms={comb:.1f} combine_share={comb / ms:.3f} "
          f"peak_mem_gib={peak:.1f}; combined gradient finite={finite}; "
          f"step 1 again bitwise={bitwise}, kernel "
          f"vs plain combine rel_err={comb_err:.3e} stats rel_err="
          f"{stats_err:.3e} (tol {COMBINED_RTOL}) params max_abs_err="
          f"{err:.3e} (tol {TRAIN_PARAM_TOL}) | {card}")
    assert bitwise, f"{name}: step 1 is not bitwise repeatable"
    assert finite, f"{name}: non-finite combined gradient"
    assert comb_err <= COMBINED_RTOL and stats_err <= COMBINED_RTOL, run
    assert err <= TRAIN_PARAM_TOL, run
    assert peak <= P11_MEM_GIB, f"peak {peak:.1f} GiB"
    del model
    _free()
    return run


def families_phase(card: str) -> dict:
    """Phase 11: the MLA and MoE decoders (ROADMAP item 6, first half)."""
    t_phase = time.perf_counter()
    part_s, rec = {}, {}
    for part, fn in (("a", lambda: _p11_mixtral(card)),
                     ("b", lambda: _p11_moonshot(card)),
                     ("c", lambda: _p11_minicpm(card)),
                     ("d", lambda: _p11_train(card, "moonshot-v1-16b-a3b",
                                              P11_TRAIN_MOONSHOT,
                                              "momentum")),
                     ("e", lambda: _p11_train(card, "minicpm3-4b",
                                              P11_TRAIN_MINICPM, "adam"))):
        t0 = time.perf_counter()
        rec[part] = fn()
        part_s[part] = time.perf_counter() - t0
        _free()
    launches = {k: (rec["a"]["launches"][k]
                    + sum(rec["b"][f"spec{s}"]["launches"][k]
                          for s in (0, P11_SPEC_K)))
                for k in ("flash_attention", "paged_decode_attention")}
    launches.update({k: rec["d"]["launches"][k] + rec["e"]["launches"][k]
                     for k in ("block_dots", "block_combine")})
    rec["launches"] = launches
    rec["part_s"] = part_s
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[smoke] families launches={launches} parts "
          f"{ {k: round(v, 1) for k, v in part_s.items()} } s, phase "
          f"{rec['phase_s']:.1f}s | {card}")
    return rec


# ------------------------- phase 12: the recurrent and frontend families
P12_GEN = 32
P12_SERVE_LEN = 128          # rwkv's slots (prompts of 24-48, 32 new)
P12_HYMBA_LEN = 256          # hymba's slots: 16 pages of 16 a slot
P12_SERVE_LAYERS = 4         # rwkv6-7b's and hymba's served layers, of
                             # 32 each: depth cut for the time limit
P12_ROLL_LAYERS = 2          # hymba at 2 of 32 layers for the roll past
P12_ROLL_PROMPT = 1040       # its 1024-token window
P12_ROLL_GEN = 8
P12_LLAVA_LAYERS = 8         # of 60: 5.4 B params, 10.9 GB of bf16
P12_STEP_GEN = 16
# two paths of one function in fp32 compute differ by summation order
# only (rwkv's decode vs its chunked forward; hymba's paged-decode kernel
# vs its plain version); in bf16 a random-weight recurrent model carries
# every rounding forward through its state and layers (hymba at 32
# layers: the plain bf16 path ends ~4 from an fp32-compute run at logit
# scale ~4), so a bf16 path is held to the fp32 run relative to the
# plain bf16 path's own error there
P12_FP32_TOL = 1e-2
P12_BF16_FACTOR = 2.0
# (part, preset, layers, optimizer, seq): llava's batch adds its 576
# patch positions to the 512 tokens; seamless's seq 256 gives 128 frames
# and its layers cut both stacks. Depths cut to the time limit: hymba's
# 32 layers step in ~4.7 s, seamless's 24 + 24 in ~2.3 s (measured on
# one H100)
P12_TRAIN = (("e", "rwkv6-7b", 1, "adam", 512),
             ("f", "hymba-1.5b", 4, "momentum", 512),
             ("g", "llava-next-34b", 1, "momentum", 512),
             ("h", "seamless-m4t-large-v2", 3, "momentum", 256))
# the parts the whole run takes beside phase 6's runs (a) and (A), after
# phase 13's twins there (hymba's ~4 GiB and llava's train step's ~31
# beside the ranks' ~15); the rest run beside phase 10 (b)'s ranks
P12_EARLY = {"a": ("bc",), "A": ("g",)}


def _nodes_leaves(cache) -> list:
    from repro_torch.models.transformer import cache_nodes
    return [t for n in cache_nodes(cache) for t in n]


def _p12_paged_slots(model, params, n, cap):
    """An n-slot paged cache of capacity `cap` a slot, each slot on
    pages of its own."""
    import torch
    from repro_torch.engine.serving.slots import set_page_tables
    from repro_torch.models.attention import paged_capacity
    pps = paged_capacity(model.cfg, cap) // 16
    cache = model.init_cache(params, n, cap, paged=(16, n * pps + 1))
    set_page_tables(cache, torch.arange(
        1, n * pps + 1, dtype=torch.int32, device="cuda").reshape(n, pps))
    return cache


def _p12_step_slots(model, params, seqs, cap):
    """`model` steps the token sequences `seqs` through one paged cache of
    len(seqs) slots (a slot whose sequence has ended is fed its last
    token again: slots are independent); returns each sequence's logits
    [V] after its last token, and the cache."""
    import numpy as np
    import torch
    n, T_ = len(seqs), max(len(x) for x in seqs)
    toks = np.stack([np.concatenate([x, np.full(T_ - len(x), x[-1])])
                     for x in seqs]).astype(np.int32)
    toks = torch.tensor(toks, device="cuda")
    cache = _p12_paged_slots(model, params, n, cap)
    last = [None] * n
    for t in range(T_):
        lg, cache = model.decode_step(params, toks[:, t:t + 1], cache)
        for i, x in enumerate(seqs):
            if t == len(x) - 1:
                last[i] = lg[i, -1].float()
    return last, cache


class _HeldPaged:
    """While active, every `paged_decode_attention` call is also computed
    by its plain version on the same inputs; `errs` gets each call's
    max_abs difference."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as FA
        self._fa, self._orig, self.errs = FA, FA.paged_decode_attention, []

        def held(q, kp, vp, table, pos, *, rolling=False):
            out = self._orig(q, kp, vp, table, pos, rolling=rolling)
            ref = FA.paged_decode_attention_ref(q, kp, vp, table, pos,
                                                rolling=rolling)
            self.errs.append((out.float() - ref.float()).abs().max().item())
            return out
        FA.paged_decode_attention = held
        return self

    def __exit__(self, *exc):
        self._fa.paged_decode_attention = self._orig


def _p12_one_tick(model, plain, params, seqs, cap) -> dict:
    """`seqs` stepped through `model` on one paged cache, then one more
    tick (each slot's greedy token) of `model` and of `plain` from copies
    of that cache: the max_abs difference of the tick's logits, one
    tick's rounding with no recurrence to carry earlier ticks' forward,
    and their scale."""
    import torch
    from repro_torch.models.transformer import map_nodes
    last, cache = _p12_step_slots(model, params, seqs, cap)
    nxt = torch.stack([x.argmax() for x in last]).to(torch.int32)[:, None]
    twin = map_nodes(lambda n: type(n)(*(t.clone() for t in n)), cache)
    got = model.decode_step(params, nxt, cache)[0][:, -1].float()
    want = plain.decode_step(params, nxt, twin)[0][:, -1].float()
    torch.cuda.synchronize()
    out = {"max_abs_err": (got - want).abs().max().item(),
           "logit_scale": want.abs().max().item(),
           "first_tokens_equal": bool(torch.equal(got.argmax(-1),
                                                  want.argmax(-1)))}
    del cache, twin
    return out


def _p12_rwkv(card: str) -> dict:
    """(a) rwkv6-7b at P12_SERVE_LAYERS of its 32 layers: serving (dense
    fallback, speculation refused), the scan-prefill repair on the card,
    decode vs the chunked forward."""
    import warnings
    import numpy as np
    import torch
    from repro_torch.engine import EngineConfig, ServeEngine
    from repro_torch.engine.serving.engine import _make_scan_prefill
    from repro_torch.kernels import build
    full, cfg, model, _ = _p11_build("rwkv6-7b", P12_SERVE_LAYERS,
                                     "bfloat16")
    params, init_s = _p11_init(model)
    print(f"[smoke] p12 (a) {cfg.name}: full width d_model={cfg.d_model} "
          f"heads={cfg.d_model // cfg.rwkv_head_dim}x{cfg.rwkv_head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}, {cfg.n_layers} of "
          f"{full.n_layers} layers; {cfg.param_count() / 1e9:.2f}B params "
          f"in bf16, init "
          f"{init_s:.1f}s, {_mem()}")
    V = cfg.vocab_size
    rng = np.random.RandomState(SEED + 12)
    prompts = [rng.randint(0, V, n) for n in (24, 29, 41, 48)]
    ecfg = EngineConfig(max_slots=4, max_len=P12_SERVE_LEN, page_size=16,
                        speculation_k=P11_SPEC_K, param_dtype="bfloat16")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = ServeEngine(ecfg, model, params)
    msgs = [str(w.message) for w in caught]
    fell_back = any("no attention K/V to page" in m for m in msgs)
    spec_off = any("speculation disabled" in m for m in msgs)
    kv = eng.kv_stats()
    slot_bytes = kv["dense_fallback_bytes"] / ecfg.max_slots
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    build.reset_launches()
    hs, wall = _timed(lambda: _greedy(eng, prompts, [4], P12_GEN))
    launches = dict(build.LAUNCHES)
    res = _p11_serve_line("(a) serve rwkv", eng, hs, launches, card, "p12")
    print(f"[smoke] p12 (a) kv_layout asked paged -> {kv['kv_layout']} "
          f"(warned {fell_back}), speculation_k={P11_SPEC_K} -> "
          f"{eng.spec_k} (warned {spec_off}), spec_ticks="
          f"{eng.stats['spec_ticks']}, prefill_mode={eng.prefill_mode}; "
          f"recurrent state {kv['dense_fallback_leaves']} leaves, "
          f"{slot_bytes / 1e6:.2f} MB a slot | {card}")
    assert fell_back and spec_off and not eng.paged and eng.spec_k == 0
    assert eng.stats["spec_ticks"] == 0 and eng.prefill_mode == "scan"
    assert res["completed"] == 4 and all(len(h.tokens) == P12_GEN
                                         for h in hs)
    res.update(wall_s=wall, init_s=init_s, fallback_warned=fell_back,
               spec_disabled=spec_off, state_bytes_per_slot=slot_bytes,
               state_leaves=kv["dense_fallback_leaves"],
               layers=cfg.n_layers, params_b=cfg.param_count() / 1e9)
    del eng
    _free()

    # the repair: a group of unequal prompts (24 and 29, one bucket of
    # 32); the ended slot's leaves after the whole prefill against the
    # same prefill cut at its own length
    prefill = _make_scan_prefill(model, ecfg.max_len)
    toks = np.zeros((2, 32), np.int32)
    for i in range(2):
        toks[i, :len(prompts[i])] = prompts[i]
    toks = torch.tensor(toks, device="cuda")
    whole = prefill(params, toks, torch.tensor([24, 29], device="cuda"))[1]
    cut = prefill(params, toks[:, :24], torch.tensor([24, 24],
                                                     device="cuda"))[1]
    kept = all(torch.equal(x[:, 0], y[:, 0]) for x, y in zip(
        _nodes_leaves(whole), _nodes_leaves(cut)))
    moved = sum(int(not torch.equal(x[:, 1], y[:, 1])) for x, y in zip(
        _nodes_leaves(whole), _nodes_leaves(cut)))
    del whole, cut

    # decode over a 64-token prompt against the chunked forward (two
    # 32-row chunks), every position: in fp32 compute (the same bf16
    # weights) the two must agree to P12_FP32_TOL — the identity; in
    # bf16 each rounds its own way, and the recurrence carries every
    # earlier position's rounding forward, so each bf16 path is held to
    # the fp32 forward instead: the decode's error there at most
    # P12_BF16_FACTOR x the bf16 forward's own plus LOGIT_TOL / 5
    from repro_torch.models import build_model
    f32 = build_model(cfg, compute_dtype=torch.float32,
                      param_dtype=torch.bfloat16)
    p64 = torch.tensor(rng.randint(0, V, 64)[None].astype(np.int32),
                       device="cuda")

    def decode_all(m):
        cache = m.init_cache(params, 1, 65, per_slot=True)
        rows = []
        for t in range(64):
            lg, cache = m.decode_step(params, p64[:, t:t + 1], cache)
            rows.append(lg[0, -1].float())
        return torch.stack(rows)
    fwd16 = model.forward(params, p64)[0].float()
    fwd32 = f32.forward(params, p64)[0].float()
    dec16, dec32 = decode_all(model), decode_all(f32)
    err = lambda a, b: (a - b).abs().max().item()
    dvf = {"fp32_decode_vs_forward": err(dec32, fwd32),
           "bf16_decode_vs_forward": err(dec16, fwd16),
           "bf16_forward_vs_fp32": err(fwd16, fwd32),
           "bf16_decode_vs_fp32": err(dec16, fwd32),
           "logit_scale": fwd32.abs().max().item()}
    del fwd16, fwd32, dec16, dec32, f32
    print(f"[smoke] p12 (a) scan prefill of lengths [24, 29] in one "
          f"group: ended slot bitwise equal to the prefill cut at 24 = "
          f"{kept} (the other slot moved in {moved} leaves); decode vs "
          f"chunked forward over 64 tokens, max_abs_err: fp32 compute "
          f"{dvf['fp32_decode_vs_forward']:.2e} (tol {P12_FP32_TOL}); "
          f"bf16 {dvf['bf16_decode_vs_forward']:.4f}; against the fp32 "
          f"forward (|logit| <= {dvf['logit_scale']:.2f}): bf16 forward "
          f"{dvf['bf16_forward_vs_fp32']:.4f}, bf16 decode "
          f"{dvf['bf16_decode_vs_fp32']:.4f} | {card}")
    assert kept, "scan prefill: an ended slot's state moved"
    assert moved > 0
    assert dvf["fp32_decode_vs_forward"] <= P12_FP32_TOL, dvf
    assert dvf["bf16_decode_vs_fp32"] <= (
        P12_BF16_FACTOR * dvf["bf16_forward_vs_fp32"] + LOGIT_TOL / 5), dvf
    res.update(repair_bitwise=kept, repair_other_moved=moved,
               decode_vs_forward=dvf)
    assert res["peak_mem_gib"] <= P11_MEM_GIB
    del params, model
    _free()
    return res


def _p12_hymba(card: str) -> dict:
    """(b) hymba-1.5b at P12_SERVE_LAYERS of its 32 layers, paged
    serving; then the prompts stepped and one tick of the kernel and
    plain arms from a
    shared cache, every paged-decode call held, the tick's logits held
    in fp32 compute; (c) at
    P12_ROLL_LAYERS layers, one prompt past the 1024-token window, kernel
    vs plain in fp32 compute at every step."""
    import warnings
    import numpy as np
    import torch
    from repro_torch.engine import EngineConfig, ServeEngine
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    full, cfg, model, plain = _p11_build("hymba-1.5b", P12_SERVE_LAYERS,
                                         "bfloat16")
    params, init_s = _p11_init(model)
    G = cfg.n_heads // cfg.n_kv_heads
    print(f"[smoke] p12 (b) {cfg.name}: full width d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} (G={G}) head_dim="
          f"{cfg.resolved_head_dim} window={cfg.sliding_window} mamba "
          f"heads={cfg.ssm_heads} state={cfg.ssm_state}, "
          f"{cfg.n_layers} of {full.n_layers} layers; "
          f"{cfg.param_count() / 1e9:.2f}B params "
          f"in bf16, init {init_s:.1f}s, {_mem()}")
    V = cfg.vocab_size
    rng = np.random.RandomState(SEED + 13)
    # one scan-prefill group (bucket 64) of unequal prompts
    prompts = [rng.randint(0, V, n) for n in (48, 53, 58, 64)]
    ecfg = EngineConfig(max_slots=4, max_len=P12_HYMBA_LEN, page_size=16,
                        param_dtype="bfloat16")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = ServeEngine(ecfg, model, params)
    warned = any("stay dense per-slot" in str(w.message) for w in caught)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    build.reset_launches()
    hs, wall = _timed(lambda: _greedy(eng, prompts, [4], P12_GEN))
    launches = dict(build.LAUNCHES)
    res = _p11_serve_line("(b) serve hymba", eng, hs, launches, card, "p12")
    kv = eng.kv_stats()
    tokens = [h.tokens for h in hs]
    del eng
    _free()
    # the holds on the serve path: the prompts stepped through the kernel
    # arm, then one tick of each arm from that same cache, every layer.
    # In bf16 every paged-decode call is held against its plain version
    # on the same inputs; the tick's logits are recorded, not held: one
    # ulp of difference in each layer's attention grows through the
    # random-weight layers to O(1) logits (1.84 at all 32). The logits are held in fp32
    # compute, where the two arms are the same function.
    with _HeldPaged() as held:
        tick = _p12_one_tick(model, plain, params, prompts, P12_HYMBA_LEN)
    tick32 = _p12_one_tick(
        build_model(cfg, compute_dtype=torch.float32,
                    param_dtype=torch.bfloat16),
        build_model(cfg, compute_dtype=torch.float32,
                    param_dtype=torch.bfloat16, attn_impl="plain"),
        params, prompts, P12_HYMBA_LEN)
    calls = {"n": len(held.errs), "max_abs_err": max(held.errs),
             "tol": KERNEL_TOL["bfloat16"]}
    print(f"[smoke] p12 (b) paged KV {kv['kv_page_bytes'] // 16} B a token "
          f"({kv['kv_page_bytes']} B a page), mamba state "
          f"{kv['dense_fallback_leaves']} leaves = "
          f"{kv['dense_fallback_bytes'] / ecfg.max_slots / 1e6:.2f} MB a "
          f"slot (warned {warned}); the prompts then one tick "
          f"from the same cache, all {cfg.n_layers} layers: each of "
          f"{calls['n']} paged-decode calls vs its plain version "
          f"max_abs_err={calls['max_abs_err']:.2e} (tol {calls['tol']}); "
          f"the tick's logits kernel vs plain arm: fp32 compute "
          f"{tick32['max_abs_err']:.2e} (tol {P12_FP32_TOL}), bf16 "
          f"{tick['max_abs_err']:.4f} (|logit| <= "
          f"{tick['logit_scale']:.2f}; tokens equal "
          f"{tick['first_tokens_equal']}) | {card}")
    assert warned and kv["dense_fallback_leaves"] == 3
    assert res["completed"] == 4
    assert res["launches"]["paged_decode_attention"] > 0, \
        "paged decode never launched on hymba"
    assert calls["max_abs_err"] <= calls["tol"], calls
    assert tick32["max_abs_err"] <= P12_FP32_TOL, tick32
    res.update(init_s=init_s, wall_s=wall, tokens=tokens,
               one_tick={"calls": calls, "fp32": tick32, "bf16": tick}, G=G,
               layers=cfg.n_layers, params_b=cfg.param_count() / 1e9,
               kv_bytes_per_token=kv["kv_page_bytes"] // 16,
               state_bytes_per_slot=(kv["dense_fallback_bytes"]
                                     / ecfg.max_slots))
    del params, model, plain
    _free()

    # (c) the rolling window, in fp32 compute (the paged kernel's fp32
    # path): one slot stepped through a 1,100-token prompt and 8 greedy
    # tokens (the kernel arm's) over a paged cache of 1024 rows, both
    # arms' logits held at every step
    full, cfg, _, _ = _p11_build("hymba-1.5b", P12_ROLL_LAYERS, "bfloat16")
    k32 = build_model(cfg, compute_dtype=torch.float32,
                      param_dtype=torch.bfloat16)
    p32 = build_model(cfg, compute_dtype=torch.float32,
                      param_dtype=torch.bfloat16, attn_impl="plain")
    params, _ = _p11_init(k32)
    prompt = rng.randint(0, V, P12_ROLL_PROMPT)
    cap = cfg.sliding_window
    caches = {"kernel": _p12_paged_slots(k32, params, 1, cap),
              "plain": _p12_paged_slots(p32, params, 1, cap)}
    build.reset_launches()
    errs, toks, nxt = [], [], None
    t0 = time.perf_counter()
    for i in range(P12_ROLL_PROMPT + P12_ROLL_GEN):
        tok = prompt[i] if i < P12_ROLL_PROMPT else nxt
        if i >= P12_ROLL_PROMPT:
            toks.append(int(tok))
        lgs = {}
        for tag, m in (("kernel", k32), ("plain", p32)):
            lg, caches[tag] = m.decode_step(params, torch.tensor(
                [[int(tok)]], dtype=torch.int32, device="cuda"), caches[tag])
            lgs[tag] = lg[0, -1].float()
        errs.append((lgs["kernel"] - lgs["plain"]).abs().max().item())
        nxt = int(lgs["kernel"].argmax())
    roll_s = time.perf_counter() - t0
    roll_launches = dict(build.LAUNCHES)
    past = errs[cap:]
    print(f"[smoke] p12 (c) hymba at {P12_ROLL_LAYERS} layers, fp32 "
          f"compute, one slot through a {P12_ROLL_PROMPT}-token prompt and "
          f"{P12_ROLL_GEN} tokens over {cap} rolling rows: kernel vs plain "
          f"logits max_abs_err={max(errs):.2e} over all {len(errs)} steps, "
          f"{max(past):.2e} over the {len(past)} steps past the window "
          f"(tol {P12_FP32_TOL}); paged decode launches "
          f"{roll_launches['paged_decode_attention']}; {roll_s:.1f}s "
          f"| {card}")
    assert max(errs) <= P12_FP32_TOL, max(errs)
    assert roll_launches["paged_decode_attention"] == \
        P12_ROLL_LAYERS * len(errs)
    res["roll"] = {"layers": P12_ROLL_LAYERS, "prompt": P12_ROLL_PROMPT,
                   "gen_tokens": toks, "max_abs_err": max(errs),
                   "max_abs_err_past_window": max(past),
                   "tol": P12_FP32_TOL, "launches": roll_launches,
                   "wall_s": roll_s}
    del params, k32, p32, caches
    _free()
    return res


def _p12_stepped(card: str) -> dict:
    """(d) `ServeSession.generate`'s stepped loop: llava-next-34b at
    P12_LLAVA_LAYERS layers with 576 patch embeddings (not fed to the
    decode cache, as in the reference), seamless-m4t-large-v2 at its full
    24 + 24 layers from 64 frames. Each: the stepped logits at the
    prompt's last token against the teacher-forced forward's."""
    import numpy as np
    import torch
    from repro_torch.engine import EngineConfig, ServeSession
    from repro_torch.kernels import build
    out = {}
    for name, layers, frames, plen in (
            ("llava-next-34b", P12_LLAVA_LAYERS, 576, 32),
            ("seamless-m4t-large-v2", 24, 64, 16)):
        full, cfg, model, plain = _p11_build(name, layers, "bfloat16")
        params, init_s = _p11_init(model)
        rng = np.random.RandomState(SEED + 14)
        prompts = rng.randint(0, cfg.vocab_size, (2, plen)).astype(np.int32)
        fe = (0.02 * rng.standard_normal((2, frames, cfg.frontend_dim))
              ).astype(np.float32)
        sess = ServeSession(EngineConfig(max_len=plen + P12_STEP_GEN + 1),
                            model, params)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        build.reset_launches()
        got, wall = _timed(lambda: sess.generate(prompts, P12_STEP_GEN,
                                                 frontend_embeds=fe))
        launches = dict(build.LAUNCHES)
        got = got.cpu().numpy()
        fe_t = torch.tensor(fe, device="cuda")
        tk = torch.tensor(prompts, device="cuda")
        # the stepped logits at the last prompt token
        if cfg.is_encoder_decoder:
            cache = model.init_cache(params, 2, plen + 1,
                                     frontend_embeds=fe_t)
            want = plain.forward(params, tk, fe_t)[:, -1].float()
        else:
            cache = model.init_cache(params, 2, plen + 1)
            want = plain.forward(params, tk)[:, -1].float()
        for t in range(plen):
            lg, cache = model.decode_step(params, tk[:, t:t + 1], cache)
        first = _first_tokens(lg[:, -1].float(), want)
        rec = {"layers": cfg.n_layers, "full_layers": full.n_layers,
               "params_b": cfg.param_count() / 1e9, "init_s": init_s,
               "wall_s": wall, "tokens": got[:, plen:].tolist(),
               "first_step": first, "launches": launches,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        line = (f"[smoke] p12 (d) {cfg.name} stepped: {cfg.n_layers} of "
                f"{full.n_layers} layers"
                + (f" + {cfg.n_encoder_layers} encoder layers"
                   if cfg.is_encoder_decoder else "")
                + f", {cfg.param_count() / 1e9:.2f}B params bf16, 2 x "
                f"{plen} tokens + {frames} frames -> {P12_STEP_GEN} new in "
                f"{wall:.2f}s; last prompt position stepped vs forward "
                f"max_abs_err={first['max_abs_logit_diff']:.4f} (tol "
                f"{LOGIT_TOL}), first tokens equal={first['equal']}; "
                f"launches={launches}")
        if not cfg.is_encoder_decoder:
            bare = sess.generate(prompts, P12_STEP_GEN).cpu().numpy()
            rec["frames_dropped"] = bool((bare == got).all())
            line += (f"; tokens without the patches equal="
                     f"{rec['frames_dropped']} (the reference drops them)")
            assert rec["frames_dropped"]
        print(line + f" | {card}")
        assert got.shape == (2, plen + P12_STEP_GEN)
        assert (got[:, :plen] == prompts).all()
        assert first["max_abs_logit_diff"] <= LOGIT_TOL, first
        assert not first["unexplained"], first
        out[name] = rec
        del params, model, plain, sess, cache
        _free()
    return out


def recurrent_parts(card: str, names) -> dict:
    """Phase 12's parts `names` ("a", "bc", "d" and P12_TRAIN's), in
    order: {part: its record}, with each part's seconds under "part_s"."""
    fns = {"a": lambda: _p12_rwkv(card), "bc": lambda: _p12_hymba(card),
           "d": lambda: _p12_stepped(card)}
    fns.update({p: (lambda n=n, l=l, o=o, q=q: _p11_train(
        card, n, l, o, tag="p12", seq=q)) for p, n, l, o, q in P12_TRAIN})
    rec, part_s = {}, {}
    for part in names:
        t0 = time.perf_counter()
        rec[part] = fns[part]()
        part_s[part] = time.perf_counter() - t0
        _free()
    rec["part_s"] = part_s
    return rec


def recurrent_phase(card: str, done=None) -> dict:
    """Phase 12: the recurrent and frontend families (ROADMAP item 6,
    second half). `done`: records of parts already run
    (`recurrent_parts`, e.g. beside phase 6's ranks); the rest run
    here."""
    t_phase = time.perf_counter()
    every = ["a", "bc", "d"] + [p for p, *_ in P12_TRAIN]
    rec = dict(done or {})
    part_s = dict(rec.pop("part_s", {}))
    late = recurrent_parts(card, [p for p in every if p not in rec])
    part_s.update(late.pop("part_s"))
    rec.update(late)
    runs = ([rec["a"]["launches"], rec["bc"]["launches"]]
            + [r["launches"] for r in rec["d"].values()]
            + [rec[p]["launches"] for p, *_ in P12_TRAIN])
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}
    rec["launches"] = launches
    assert launches["flash_attention"] == 0, launches
    rec["part_s"] = part_s
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[smoke] recurrent launches={launches} parts "
          f"{ {k: round(v, 1) for k, v in part_s.items()} } s (parts "
          f"{sorted(set(every) - set(late))} ran earlier), phase "
          f"{rec['phase_s']:.1f}s | {card}")
    return rec


# ------------------------------------------------------ phase 13: model axis
# qwen3-32b (hf Qwen/Qwen3-32B, the reference's own model-axis example,
# src/repro/launch/train.py:3-4) at full width, TP_LAYERS of its 64
# layers (2.04 B params, 7.61 GiB fp32): (c)'s and (e)'s model, momentum,
# bf16 compute, seq TP_SEQ, global batch TP_BATCH, TP_STEPS steps, random
# weights from SEED. (c) drives its tensor-parallel path and RVH's
# model-axis dots beside FSDP and holds the kernel arm against the plain
# one there (a launch of four ranks training it alone on a (2, 2) grid
# drove no path (c) does not, and took ~60 s of the time limit)
TP_LAYERS = 1
TP_SEQ = 256
TP_BATCH = 8
# one step a run (for the script's time limit); a run's bitwise repeat,
# step 1 again from the session's initial state in the warm processes, is
# timed as its steady step
TP_STEPS = 1
# step 1 against the twin (one process, the two lanes stacked on the card,
# the same init and batch), leaf by leaf, within TP_TWIN_FACTOR times the
# twin's own bf16-vs-fp32 difference of that leaf, plus TP_TWIN_FLOOR (an
# fp32 ulp at a 1-scale param). The twin rounds each bf16 product once
# where the fp32 twin rounds none; a rank rounds each row-parallel
# layer's bf16 partial product, then the fp32 all-reduce's sum back to
# bf16: up to ~3 roundings where the twin has one
TP_TWIN_FACTOR = 4.0
TP_TWIN_FLOOR = 1.2e-7
# (b) head padding in serving: minitron-4b (arXiv:2407.14679; its preset
# sets pad_heads) at full width, PAD_LAYERS of its 32 layers, padded for
# the production mesh's model axis (16): 24 q / 8 kv heads -> 32 / 16, G
# 3 -> 2; weights converted from the unpadded model (exact); 4 prompts of
# PAD_PROMPTS tokens, PAD_GEN new each
PAD_LAYERS = 8
PAD_PROMPTS = (48, 64, 80, 96)
PAD_GEN = 32
# the padded engine's logits against the unpadded one's in fp32 compute:
# the same sums with zero heads added, in another order
PAD_FP32_TOL = 1e-2


# (c) both axes at once: the model above on a (data, model) grid of
# GRID_SHAPE gloo ranks in qwen3-32b's own preset regime (fsdp,
# scatter_grads, gspmd_tree below span == dp, ZeRO-1) at the widths one
# card allows: span GRID_SPAN, no accumulation (it sums microbatch
# gradients, so step 1 would not be the twin's function; held on the
# CPU), momentum
GRID_SHAPE = (4, 2)
GRID_SPAN = 2


def _tp_config(**fields):
    """The twins' EngineConfig (one process, qwen3-32b at TP_LAYERS);
    `fields` set the rest."""
    from repro_torch.engine import EngineConfig
    return EngineConfig(**{**dict(
        arch="qwen3-32b", seq_len=TP_SEQ, global_batch=TP_BATCH,
        optimizer="momentum", fusion_threshold_mb=64, steps=TP_STEPS,
        log_every=1), **fields})


def _tp_model(dtype):
    """qwen3-32b at TP_LAYERS layers, fp32 params, `dtype` compute."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    import torch
    cfg = dataclasses.replace(get_config("qwen3-32b"), n_layers=TP_LAYERS)
    return build_model(cfg, compute_dtype=dtype, param_dtype=torch.float32,
                       attn_chunk=TP_SEQ)


def _twin(card: str, path: Path, config, model_of, tag: str) -> dict:
    """A grid run's one-process twin, in this process before the ranks
    start: step 1 of `config` (the grid's data lanes stacked on the card)
    on `model_of(compute dtype)`, in bf16 and in fp32 compute. Saves the
    bf16 step's params and each leaf's |bf16 - fp32| maximum to `path`
    for the ranks."""
    import torch
    from repro_torch import tree as T
    from repro_torch.engine import TrainSession
    got, out = {}, {}
    t0 = time.perf_counter()
    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        torch.cuda.reset_peak_memory_stats()
        s = TrainSession.from_config(
            config, model=model_of(dt), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(SEED),
            callbacks=[])
        m, dt_s = _timed_s(lambda: s.step(s.batch(0)))
        p1 = T.leaves(s.state["params"])
        if name == "fp32":
            out["diff"] = [(a - b.to(a.device)).abs().max().item()
                           for a, b in zip(p1, got["bf16"])]
        else:
            got[name] = [x.to("cpu", copy=True) for x in p1]
        out[f"{name}_ms"] = 1e3 * dt_s
        out[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out[f"{name}_loss"] = m["loss"]
        del s, p1
        _free()
    t1 = time.perf_counter()
    torch.save({"bf16": got["bf16"], **out}, path)
    del got
    out["save_s"] = time.perf_counter() - t1
    out["twin_s"] = time.perf_counter() - t0
    print(f"[smoke] p13 {tag} twin: one process, {config.span} lanes "
          f"stacked: "
          f"step 1 bf16 {out['bf16_ms']:.1f} ms (peak "
          f"{out['bf16_peak_gib']:.2f} GiB), fp32 {out['fp32_ms']:.1f} ms "
          f"(peak {out['fp32_peak_gib']:.2f}); bf16 vs fp32 params max "
          f"{max(out['diff']):.3e}; {out['twin_s']:.1f} s (save "
          f"{out['save_s']:.1f}) | {card}")
    torch.cuda.reset_peak_memory_stats()
    return out


# the twins of phase 13's runs, by run: (c)'s (the Adasum tree, two lanes
# stacked at span GRID_SPAN, nothing sharded), (d1)'s and (e1)'s, (e2)'s
# (their combiners). Each takes ~40-49 GiB of the card for 13-17 s; the
# whole run computes them beside phase 6's ranks (~15 GiB), and the files
# wait under build/ranks until phase 13's ranks read them
P13_TWINS = ("c", "d1", "e1", "e2")


def _twin_path(tag: str) -> Path:
    return ROOT / "build" / "ranks" / f"{tag}_twin.pt"


def p13_twins(card: str, tags) -> dict:
    """The twins of `tags` (P13_TWINS), each saved to `_twin_path(tag)`
    for the ranks; returns {tag: the twin's record}. On a failure the
    files are removed."""
    out = {}
    _twin_path(tags[0]).parent.mkdir(parents=True, exist_ok=True)
    try:
        for tag in tags:
            if tag == "c":
                cfg, model_of = _tp_config(span=GRID_SPAN,
                                           backend="gspmd_tree"), _tp_model
            elif tag == "d1":
                cfg = _fam_config("mixtral-8x22b")
                model_of = lambda dt: _fam_model(
                    "mixtral-8x22b", MIXTRAL_LAYERS, dt, cfg.param_dtype)
            else:
                cfg = {t: c for t, _, _, c, _ in _comb_runs()}[tag]
                model_of = _tp_model
            out[tag] = _twin(card, _twin_path(tag), cfg, model_of,
                             f"({tag})")
            _free()
    except BaseException:
        for tag in tags:
            _twin_path(tag).unlink(missing_ok=True)
        raise
    return out


def _tp_vs_twin(plan, params, twin, key: str, tol) -> dict:
    """This rank's params against the same part of the twin's step 1
    (`twin[key]`; the plan's cut of each leaf), leaf by leaf: the worst
    ratio of |difference| to the leaf's tolerance `tol(i)`, over the
    ranks."""
    import torch.distributed as dist
    from repro_torch import tree as T
    worst = (0.0, None, 0.0, 0.0)
    for i, x in enumerate(T.leaves(params)):
        # the cut's span of the (memory-mapped) leaf, from its first
        # element to its last, goes to the card in one contiguous read and
        # is cut there (a strided read of the mapped file took 10-20 s a
        # run on eight ranks; the whole leaf, ~9 s)
        full = twin[key][i].contiguous()
        want = plan.take(i, full, "params")
        if want.is_contiguous():
            want = want.to(x.device)
        elif (want.untyped_storage().data_ptr()
              == full.untyped_storage().data_ptr()):
            lo = want.storage_offset() - full.storage_offset()
            hi = lo + 1 + sum((n - 1) * st for n, st in
                              zip(want.shape, want.stride()))
            want = full.view(-1)[lo:hi].to(x.device).as_strided(
                want.shape, want.stride())
        else:
            want = plan.take(i, full.to(x.device), "params")
        err = (x.detach() - want).abs().max().item()
        del want
        ratio = err / tol(i)
        if ratio >= worst[0]:
            worst = (ratio, i, err, tol(i))
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, worst)
    ratio, i, err, t = max(seen, key=lambda w: w[0])
    return {"worst_ratio": ratio, "leaf": i, "max_abs_err": err, "tol": t}


def _grid_config(**fields):
    """Phase 13 (c)'s EngineConfig: the qwen3-32b preset at (c)'s
    widths; `fields` set the rest."""
    from repro_torch.engine import EngineConfig
    return EngineConfig.preset("qwen3-32b", **{**dict(
        data_mesh=GRID_SHAPE[0], model_mesh=GRID_SHAPE[1],
        span=GRID_SPAN, accum_steps=1, optimizer="momentum",
        seq_len=TP_SEQ, global_batch=TP_BATCH, fusion_threshold_mb=64,
        steps=TP_STEPS, log_every=1), **fields})


# (d) the model axis on the MoE family, in (c)'s rank processes after (c)
# frees its memory (fresh processes pay 12-20 s on a first step): each
# preset's own regime (`_PRESETS`) at full width, momentum, bf16 compute,
# seq TP_SEQ, batch TP_BATCH, TP_STEPS steps, weights from SEED, without
# accumulation (held on the CPU, as in (c)). (d1) mixtral-8x22b
# (arXiv:2401.04088) at MIXTRAL_LAYERS of its 56 layers (2.907 B params,
# 2.416 B of them the expert stacks): span 2, fsdp, scatter_grads,
# gspmd_tree, bf16 params and state, attn_chunk 256, pad_heads; on a
# (data, model) grid of MIXTRAL_GRID: FSDP gathers a layer's model shard
# whole, and at model 2 that is 1.21 B expert elements a rank, which with
# its gradient beside the held params, state and lane gradient of eight
# ranks would pass RANK_MEM_GIB; model 4 halves it. Step 1 is held to a
# one-process twin (the two data lanes stacked) by the twin rule. (d2)
# moonshot-v1-16b-a3b (hf moonshotai/Moonlight-16B-A3B) at MOONSHOT_LAYERS
# of 48 (the dense first layer and one MoE layer, 1.284 B params, fp32)
# on (c)'s grid at (c)'s span: the reference's rule puts the model axis
# of "expert"-partition stacks on the layer axis of `blocks`, which one
# MoE layer cannot split, so every model rank runs all 64 experts (cut
# over the data axis) beside its shard of the shared expert
MIXTRAL_LAYERS = 1
MIXTRAL_GRID = (2, 4)
MOONSHOT_LAYERS = 2
# steps of each run (moonshot's one for the script's time limit); then
# step 1 again from the session's initial state, bitwise, timed as the
# steady step
FAM_STEPS = {"d1": 1, "d2": 1}


def _fam_model(arch: str, layers: int, dtype, param_dtype: str):
    """A preset at full width, `layers` deep (a MoE config's dense
    prefix kept), `dtype` compute."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    return build_model(cfg, compute_dtype=dtype,
                       param_dtype=getattr(torch, param_dtype),
                       attn_chunk=TP_SEQ)


def _fam_config(arch: str, **fields):
    """Phase 13 (d)'s EngineConfig: the arch's preset at (c)'s widths,
    momentum, no accumulation; `fields` set the rest."""
    from repro_torch.engine import EngineConfig
    return EngineConfig.preset(arch, **{**dict(
        accum_steps=1, optimizer="momentum", seq_len=TP_SEQ,
        global_batch=TP_BATCH, fusion_threshold_mb=64, steps=TP_STEPS,
        log_every=1), **fields})


def _fam_runs():
    """(tag, arch, layers, EngineConfig on the grid) of phase 13 (d)."""
    return (("d1", "mixtral-8x22b", MIXTRAL_LAYERS,
             _fam_config("mixtral-8x22b", data_mesh=MIXTRAL_GRID[0],
                         model_mesh=MIXTRAL_GRID[1])),
            ("d2", "moonshot-v1-16b-a3b", MOONSHOT_LAYERS,
             _fam_config("moonshot-v1-16b-a3b", data_mesh=GRID_SHAPE[0],
                         model_mesh=GRID_SHAPE[1], span=GRID_SPAN)))


# (e) every combiner on shards, in (c)'s rank processes after (d) frees
# its memory: (c)'s model and widths (bf16 compute, seq TP_SEQ, batch
# TP_BATCH, weights from SEED), one step and its repeat from the
# session's initial state each, through `TrainSession.from_config` of
# qwen3-32b's preset. (e1) the paper's sum baseline and (e2) AdaScale in
# (c)'s regime (momentum, fsdp + scatter_grads, span GRID_SPAN on
# GRID_SHAPE), step 1 held to a one-process twin with the same combiner
# (the two lanes stacked) by the twin rule; (e3) adasum-linear with adam at
# the post point at GRID_SPAN of GRID_SHAPE's four data ranks (its state
# ZeRO-1 on the lane groups' parts); (e4) the Adasum tree whole-model
# (per_layer=False) with fsdp + scatter_grads on a data axis of eight at
# span COMB_TREE_SPAN (the shards' and the whole leaves' buckets in
# lockstep, both Adasum kernels on them), its combined tree on rank 0
# held against the plain arm's combine of the same lane tree
# (COMBINED_BF16_RTOL: the lane gradients are bf16, and the batch of 8
# rows cannot take an accumulation that would keep them fp32 on eight
# data ranks). (e3) and (e4) keep bf16
# params, and (e3) bf16 adam state, as mixtral's preset does: in fp32,
# (e3)'s two adam moments of a lane group's part and (e4)'s FSDP gathers
# of whole leaves (no model axis) would take eight ranks past
# RANK_MEM_GIB
COMB_TREE_GRID = (8, 1)
COMB_TREE_SPAN = 4
# the runs that take step 1 again from the session's initial state
# (bitwise): (e1) and (e2), held to their twins, skip it for the time
# limit (~15 s each); the repeat's determinism is held in the same
# processes by (d1), (d2), (e3) and (e4)
COMB_REPEAT = ("e3", "e4")


def _comb_runs():
    """(tag, EngineConfig, bf16 params, twin, plain arm) of phase 13 (e);
    the twin is the one-process config step 1 is held to."""
    return (
        ("e1", _grid_config(combine="sum"), False,
         _tp_config(span=GRID_SPAN, backend="gspmd_tree", combine="sum"),
         False),
        ("e2", _grid_config(combine="adascale"), False,
         _tp_config(span=GRID_SPAN, backend="gspmd_tree",
                    combine="adascale"), False),
        ("e3", _grid_config(backend="linear", optimizer="adam",
                            param_dtype="bfloat16",
                            opt_state_dtype="bfloat16"),
         True, None, False),
        ("e4", _grid_config(data_mesh=COMB_TREE_GRID[0],
                            model_mesh=COMB_TREE_GRID[1],
                            span=COMB_TREE_SPAN, per_layer=False,
                            param_dtype="bfloat16"),
         True, None, True))


def _comb_model(bf16_params: bool):
    import torch
    return _fam_model("qwen3-32b", TP_LAYERS, torch.bfloat16,
                      "bfloat16" if bf16_params else "float32")


class _DropLog:
    """The MoE dispatches of this rank's forward passes (not the
    recomputes inside the backward): wraps `moe.top_k` and keeps, per
    call, this rank's pairs per expert and its token count. `take(plan)`
    sums them over the lane group (whose ranks split one microbatch's
    rows) and counts the pairs past each expert's capacity."""

    def __init__(self, cfg):
        self.cfg, self.calls = cfg, []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._orig = moe.top_k

        def top_k(probs, k):
            vals, idx = self._orig(probs, k)
            if torch._C._current_graph_task_id() < 0:
                with torch.no_grad():
                    n = torch.zeros(probs.shape[-1], dtype=torch.float32,
                                    device=probs.device)
                    n.scatter_add_(0, idx.reshape(-1),
                                   torch.ones(idx.numel(), device=idx.device))
                self.calls.append((n, idx.shape[0] * idx.shape[1]))
            return vals, idx
        moe.top_k = top_k
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.top_k = self._orig

    def take(self, plan) -> dict:
        """{'calls', 'pairs', 'dropped'} of the calls since the last
        take, over the whole microbatches (collective on the lane
        group)."""
        import torch
        from repro_torch.models import moe
        calls, self.calls = self.calls, []
        if not calls:
            return {"calls": 0, "pairs": 0, "dropped": 0}
        counts = torch.stack([n for n, _ in calls])
        g = 1
        if plan.lane_comm is not None:
            g = plan.lane_comm.world
            counts = plan.lane_comm.group_sum(counts, g)
        K = self.cfg.n_experts_per_tok
        cap = torch.tensor([moe.capacity(self.cfg, t * g) for _, t in calls],
                           device=counts.device, dtype=torch.float32)
        dropped = (counts - cap[:, None]).clamp(min=0).sum().item()
        return {"calls": len(calls), "pairs": sum(t * g * K for _, t in calls),
                "dropped": int(dropped)}


def _grid_run(comm, config, model, twin_path, rank: int, tag: str,
              steps: int = TP_STEPS, repeat: bool = False,
              plain: bool = False, warm=None) -> dict:
    """One grid run on this rank (its own process, on cuda:0 over gloo):
    the session built leaf by leaf, `steps` steps timed by call kind,
    step 1 held against the twin at `twin_path` (if any) and, with
    `repeat`, taken again from the session's initial state (bitwise,
    timed as the others); with `plain`, the plain arm's combiner on
    step 1's lane tree (every rank's, kept in host memory), rank 0's
    combined tree (and CombineStats, where the combiner makes them) held
    against the kernel arm's; returns the rank's record. `warm`: a
    `_warm_up` thread, joined once the session is up. Closes the session
    and frees its memory."""
    import torch
    from repro_torch import tree as T
    from repro_torch.engine import TrainSession, build_runtime
    from repro_torch.kernels import build
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    timer = _CombineTimer(keep=rank == 0, keep_input=True) \
        if plain else None
    with _timing_combiners(timer):
        s = TrainSession.from_config(
            config, model=model, device="cuda:0",
            generator=torch.Generator(device="cuda:0").manual_seed(SEED),
            callbacks=[], comm=comm)
    if warm is not None:
        _join(warm)
    rt, plan = s.runtime, s.runtime.plan
    mc, dc, tp = rt.model_comm, plan.comm, rt.tp
    inner = s.state["opt"]["inner"]
    params = T.leaves(s.state["params"])

    def plan_gib(which, trees):
        """GiB of `trees` in the plan's shapes of `which`, each leaf at
        its own element size."""
        return sum(math.prod(sh) * x.element_size() for t in trees
                   for sh, x in zip(plan.local_shapes(which),
                                    T.leaves(t))) / 2 ** 30
    rec = {"rank": rank, "init_s": time.perf_counter() - t0,
           "init_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "mesh": [rt.dp_total, rt.model_size], "path": rt.combine_path,
           "span": rt.span, "point": rt.dopt.point,
           "regime": {k: getattr(s.config, k) for k in (
               "fsdp", "scatter_grads", "backend", "pad_heads",
               "param_dtype", "combine", "per_layer", "optimizer",
               "opt_state_dtype")},
           "leaves": len(plan.dims),
           "data_sharded": sum(d is not None for d in plan.dims),
           "model_sharded": sum(d is not None for d in plan.mdims),
           "held_gib": {"params": _gib_of(s.state["params"]),
                        "state": _gib_of(inner)},
           "plan_gib": {"params": plan_gib("params", [params]),
                        "state": plan_gib("state", inner.values()),
                        "grads": plan_gib("grads", [params])}}
    del params, inner        # the repeat's state is a copy: free the first
    free, total = torch.cuda.mem_get_info()
    print(f"[rank {rank}] {tag} session up in {rec['init_s']:.1f}s: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
          f"peak {rec['init_peak_gib']:.2f}; the card "
          f"{(total - free) / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB in "
          f"use", flush=True)
    # the leaves no axis cuts here: whole on the data axis (not an FSDP
    # piece), and of those, whole on the model axis too
    data_whole = [d is None for d in plan.dims]
    both_whole = [d is None and m is None
                  for d, m in zip(plan.dims, plan.mdims)]
    twin = torch.load(twin_path, mmap=True) if twin_path else None
    # the initial state, kept in host memory (on the card it would pass
    # RANK_MEM_GIB beside (e)'s steps), and a card copy of it
    move = lambda tree, dev: T.map(lambda x: x.to(dev, copy=True)
                                   if isinstance(x, torch.Tensor) else x,
                                   tree)
    start = move(s.state, "cpu") if repeat else None
    drops = _DropLog(model.cfg) if model.cfg.n_experts else None
    torch.cuda.reset_peak_memory_stats()
    if mc is not None:      # a data axis alone has no model group
        mc.take_ms()
    comm.take_ms()
    build.reset_launches()

    def timed_step(step):
        """Step `step` timed by call kind: (its record, the checksums of
        the params after it)."""
        comm.timing = True
        if tp is not None:
            tp.bytes.clear()
        staged0 = comm.total_staged_bytes()
        m, dt = _timed_s(lambda: s.step(s.batch(step)))
        comm.timing = False
        got = {"ms": 1e3 * dt, "loss": m["loss"],
               "model_comm": mc.take_ms() if mc is not None else {},
               "rest_comm": comm.take_ms(),
               "tp_bytes": dict(tp.bytes) if tp is not None else {},
               "staged_bytes": comm.total_staged_bytes() - staged0,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "drops": drops.take(plan) if drops else None}
        print(f"[rank {rank}] {tag} step {step} {1e3 * dt:.0f} ms, peak "
              f"{got['peak_gib']:.2f} GiB", flush=True)
        return got, _checksums(s.state["params"])

    runs, bitwise = [], []
    with drops or contextlib.nullcontext():
        for step in range(steps):
            got, sums = timed_step(step)
            runs.append(got)
            bitwise.append(
                _all_equal([c for c, w in zip(sums, data_whole) if w],
                           group=dc.group)
                and (mc is None or _all_equal(
                    [c for c, w in zip(sums, both_whole) if w],
                    group=mc.group)))
            if step == 0:
                sums1 = sums
                if twin is not None:
                    rec["twin"] = _tp_vs_twin(
                        plan, s.state["params"], twin, "bf16",
                        lambda i: TP_TWIN_FACTOR * twin["diff"][i]
                        + TP_TWIN_FLOOR)
        rec.update(launches=dict(build.LAUNCHES), steps=runs,
                   bitwise=bitwise,
                   peak_gib=max(x["peak_gib"] for x in runs),
                   steps_s=time.perf_counter() - t0 - rec["init_s"])
        del twin
        if repeat:
            t1 = time.perf_counter()
            s.state = None         # its memory back before the copy lands
            _free()
            rec["left_gib"] = torch.cuda.memory_allocated() / 2 ** 30
            free, total = torch.cuda.mem_get_info()
            print(f"[rank {rank}] {tag} before the repeat: "
                  f"{rec['left_gib']:.2f} GiB allocated; the card "
                  f"{(total - free) / 2 ** 30:.2f} GiB in use", flush=True)
            s.state = move(start, "cuda:0")
            rec["repeat_step"], sums = timed_step(0)
            rec["repeat_bitwise"] = sums == sums1
            rec["repeat_s"] = time.perf_counter() - t1
    if plain:
        t1 = time.perf_counter()
        s.state = None
        _free()
        prt = build_runtime(model, s.config.run_policy(), lr=s.config.lr,
                            comm=comm, combine_impl="plain",
                            model_size=rt.model_size)
        out = prt.dopt.combiner(move(timer.kept_input, "cuda:0"))
        out, stats = out if isinstance(out, tuple) else (out, None)
        if rank == 0:          # on the card, a leaf at a time
            rec["combined_rel_err"] = max(
                _rel_err(x.to("cuda:0"), y)
                for x, y in zip(timer.kept[0], T.leaves(out)))
            if stats is not None and timer.kept[1] is not None:
                rec["stats_rel_err"] = _rel_err(
                    timer.kept[1].to("cuda:0"), stats["levels"])
        del prt, out, stats, timer
        rec["plain_s"] = time.perf_counter() - t1
    s.close()
    del s
    _free()
    return rec


def grid_worker(spec: dict) -> int:
    """One rank of phase 13 (c), (d) and (e) (its own process, on cuda:0
    over gloo): (c) with its plain arm, then (d1), (d2) and (e1)-(e4) on
    the same process group (`_grid_run` each, the twins' files named in
    `spec` by run); writes a JSON record."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.parallel.comm import Comm
    rank = int(os.environ["RANK"])
    warm = _warm_up()     # while the ranks meet and build (c)'s session
    comm = Comm.init("gloo", torch.device("cuda:0"))
    rec = _grid_run(comm, _grid_config(), _tp_model(torch.bfloat16),
                    spec["c"], rank, "(c)", plain=True, warm=warm)
    rec["d"] = {}
    for tag, arch, layers, config in _fam_runs():
        model = _fam_model(arch, layers, torch.bfloat16, config.param_dtype)
        rec["d"][tag] = _grid_run(comm, config, model, spec.get(tag), rank,
                                  f"({tag})", FAM_STEPS[tag], repeat=True)
    rec["e"] = {}
    for tag, config, bf16, _, plain in _comb_runs():
        rec["e"][tag] = _grid_run(comm, config, _comb_model(bf16),
                                  spec.get(tag), rank, f"({tag})",
                                  repeat=tag in COMB_REPEAT, plain=plain)
    comm.close()
    Path(spec["out"]).write_text(json.dumps(rec, default=str))
    return 0


def _grid_report(card: str, recs: list, wall: float) -> dict:
    """Phase 13 (c) from its ranks' records: printed and checked."""
    r0 = recs[0]
    for r in recs:
        print(f"[smoke] p13 (c) rank {r['rank']}: holds params "
              f"{r['held_gib']['params']:.3f} GiB (plan "
              f"{r['plan_gib']['params']:.3f}), momentum "
              f"{r['held_gib']['state']:.3f} (plan "
              f"{r['plan_gib']['state']:.3f}); its lane gradient's plan "
              f"{r['plan_gib']['grads']:.3f}; init peak "
              f"{r['init_peak_gib']:.2f}, step peak {r['peak_gib']:.2f} "
              f"GiB | {card}")
    peaks = [r["peak_gib"] for r in recs]
    inits = [r["init_peak_gib"] for r in recs]
    print(f"[smoke] p13 (c) qwen3-32b preset at full width, {TP_LAYERS} of "
          f"64 layers, grid (data, model) = {tuple(r0['mesh'])}, "
          f"{len(recs)} gloo ranks on cuda:0: {r0['regime']}, span "
          f"{r0['span']}, path={r0['path']}, momentum ({r0['point']} "
          f"point, ZeRO-1), bf16 compute, seq {TP_SEQ}, batch {TP_BATCH}; "
          f"of {r0['leaves']} leaves {r0['data_sharded']} cut on the data "
          f"axis, {r0['model_sharded']} on the model axis; init peaks sum "
          f"{sum(inits):.2f} GiB (max {max(inits):.2f}), step peaks sum "
          f"{sum(peaks):.2f} (max {max(peaks):.2f}); rank 0's seconds: "
          f"init {r0['init_s']:.1f}, steps {r0['steps_s']:.1f} | {card}")
    steps = []
    for i in range(TP_STEPS):
        rows = [r["steps"][i] for r in recs]
        s0 = rows[0]
        mcm, rest = s0["model_comm"], s0["rest_comm"]
        step = {
            "ms": max(x["ms"] for x in rows), "loss": s0["loss"],
            "fsdp_all_gather_ms": rest.get("all_gather", 0.0),
            "reduce_scatter_ms": rest.get("reduce_scatter", 0.0),
            "rvh_exchange_ms": rest.get("exchange", 0.0),
            "tp_allreduce_ms": mcm.get("allreduce", 0.0),
            "tp_allreduce_bytes": s0["tp_bytes"].get("allreduce", 0),
            "tp_all_gather_ms": mcm.get("all_gather", 0.0),
            "dots_sum_ms": rest.get("dots_sum", 0.0),
            "model_dots_sum_ms": mcm.get("dots_sum", 0.0),
            "lane_allreduce_ms": rest.get("allreduce", 0.0),
            "kernels_ms": rest.get("kernels", 0.0),
            "staging_ms": rest.get("stage", 0.0) + mcm.get("stage", 0.0),
            "staged_gb": s0["staged_bytes"] / 1e9}
        steps.append(step)
        print(f"[smoke] p13 (c) step {i}: {step['ms']:.1f} ms (slowest "
              f"rank), loss {step['loss']:.4f}; rank 0: FSDP all-gather "
              f"{step['fsdp_all_gather_ms']:.1f} ms, reduce-scatter "
              f"{step['reduce_scatter_ms']:.1f}, RVH exchange "
              f"{step['rvh_exchange_ms']:.1f}, model all-reduce "
              f"{step['tp_allreduce_ms']:.1f} ms / "
              f"{step['tp_allreduce_bytes'] / 1e6:.1f} MB, model all-gather "
              f"{step['tp_all_gather_ms']:.1f}, dot sums "
              f"{step['dots_sum_ms']:.1f} + model "
              f"{step['model_dots_sum_ms']:.1f}, lane all-reduce "
              f"{step['lane_allreduce_ms']:.1f}, kernels "
              f"{step['kernels_ms']:.1f}, staging {step['staging_ms']:.1f} "
              f"ms; staged {step['staged_gb']:.2f} GB | {card}")
    launches = r0["launches"]
    twin = r0["twin"]
    bitwise = all(all(r["bitwise"]) for r in recs)
    stats = r0.get("stats_rel_err")
    print(f"[smoke] p13 (c) launches on rank 0: block_dots="
          f"{launches.get('block_dots', 0)} block_combine="
          f"{launches.get('block_combine', 0)}; the leaves left whole "
          f"bitwise across the ranks holding them={bitwise}; step 1 vs "
          f"its twin: worst leaf {twin['leaf']} {twin['max_abs_err']:.3e} "
          f"against {twin['tol']:.3e} (ratio {twin['worst_ratio']:.2f}); "
          f"kernel arm vs plain arm on step 1's lane tree (rank 0): "
          f"combined rel_err {r0['combined_rel_err']:.3e}"
          + ("" if stats is None else f", stats {stats:.3e}")
          + f" (tol {COMBINED_RTOL}); plain arm {r0['plain_s']:.1f} s; "
          f"wall {wall:.1f} s | {card}")
    assert all(r["mesh"] == list(GRID_SHAPE) for r in recs)
    assert r0["path"] == "hier-rvh" and r0["span"] == GRID_SPAN
    assert r0["regime"]["fsdp"] and r0["regime"]["scatter_grads"]
    for r in recs:
        for k in ("params", "state"):
            assert abs(r["held_gib"][k] - r["plan_gib"][k]) < 1e-9, r
    assert all(math.isfinite(x["loss"]) for x in steps)
    for k in ("block_dots", "block_combine"):
        assert launches.get(k, 0) > 0, f"{k} never launched in phase 13 (c)"
    assert bitwise
    assert twin["worst_ratio"] <= 1.0, twin
    assert r0["combined_rel_err"] <= COMBINED_RTOL, r0["combined_rel_err"]
    assert stats is None or stats <= COMBINED_RTOL, stats
    assert sum(peaks) <= RANK_MEM_GIB and sum(inits) <= RANK_MEM_GIB, \
        (peaks, inits)
    # the kernels at RVH's round-0 half of a rank's part of the embedding:
    # its model shard (151,936 / 2 rows) cut to the lane group's half of
    # d_model, halved across the two RVH ranks
    cases = _adasum_case("grid_embed_half", 151_936 * 5120 // 8, 8192,
                         flat=True)
    for c in cases:
        print(f"[smoke] p13 (c) kernel {c['kernel']:14s} {c['case']} err "
              f"{c['max_abs_err']:.2e} (tol {c['tol']:.0e}) ms "
              f"{c['ms']:.4f} plain {c['plain_ms']:.4f} library "
              f"{c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
              f"({c['bound_by']}) {'ok' if c['ok'] else 'FAIL'} | {card}")
    assert all(c["ok"] for c in cases), cases
    return {"steps": steps, "launches": launches, "twin": twin,
            "bitwise": bitwise, "held_gib": [r["held_gib"] for r in recs],
            "plan_gib": r0["plan_gib"], "peak_gib": peaks,
            "init_peak_gib": inits, "cases": cases,
            "combined_rel_err": r0["combined_rel_err"],
            "stats_rel_err": stats,
            "rank0_s": {k: r0[k] for k in ("init_s", "steps_s", "plain_s")},
            "wall_s": wall}


def _fam_report(card: str, recs: list, twin: dict) -> dict:
    """Phase 13 (d) from its ranks' records (`rec["d"]`): printed and
    checked."""
    out = {}
    for tag, arch, layers, config in _fam_runs():
        rows = [r["d"][tag] for r in recs]
        r0 = rows[0]
        peaks = [r["peak_gib"] for r in rows]
        inits = [r["init_peak_gib"] for r in rows]
        for r in rows:
            print(f"[smoke] p13 ({tag}) rank {r['rank']}: holds params "
                  f"{r['held_gib']['params']:.3f} GiB (plan "
                  f"{r['plan_gib']['params']:.3f}), momentum "
                  f"{r['held_gib']['state']:.3f} (plan "
                  f"{r['plan_gib']['state']:.3f}); its lane gradient's "
                  f"plan {r['plan_gib']['grads']:.3f}; init peak "
                  f"{r['init_peak_gib']:.2f}, step peak {r['peak_gib']:.2f} "
                  f"GiB | {card}")
        print(f"[smoke] p13 ({tag}) {arch} preset at full width, {layers} of "
              f"{_full_layers(arch)} layers, grid (data, model) = "
              f"{tuple(r0['mesh'])}, {len(rows)} gloo ranks on cuda:0: "
              f"{r0['regime']}, span {r0['span']}, path={r0['path']}, "
              f"momentum ({r0['point']} point), bf16 compute, seq {TP_SEQ}, "
              f"batch {TP_BATCH}; of {r0['leaves']} leaves "
              f"{r0['data_sharded']} cut on the data axis, "
              f"{r0['model_sharded']} on the model axis; init peaks sum "
              f"{sum(inits):.2f} GiB (max {max(inits):.2f}), step peaks sum "
              f"{sum(peaks):.2f} (max {max(peaks):.2f}); rank 0's seconds: "
              f"init {r0['init_s']:.1f}, steps {r0['steps_s']:.1f}, repeat "
              f"{r0['repeat_s']:.1f} | {card}")
        steps = []
        runs = [(f"step {i}", [r["steps"][i] for r in rows])
                for i in range(FAM_STEPS[tag])]
        runs.append(("repeat (steady)", [r["repeat_step"] for r in rows]))
        for name, got in runs:
            s0 = got[0]
            mcm, rest, tb = s0["model_comm"], s0["rest_comm"], s0["tp_bytes"]
            step = {
                "name": name, "ms": max(x["ms"] for x in got),
                "loss": s0["loss"],
                "fsdp_all_gather_ms": rest.get("all_gather", 0.0),
                "reduce_scatter_ms": rest.get("reduce_scatter", 0.0),
                "rvh_exchange_ms": rest.get("exchange", 0.0),
                "tp_allreduce_ms": mcm.get("allreduce", 0.0),
                "tp_allreduce_bytes": tb.get("allreduce", 0)
                + tb.get("moe_allreduce", 0),
                "moe_allreduce_ms": mcm.get("moe_allreduce", 0.0),
                "moe_allreduce_bytes": tb.get("moe_allreduce", 0),
                "tp_all_gather_ms": mcm.get("all_gather", 0.0),
                "dots_sum_ms": rest.get("dots_sum", 0.0),
                "model_dots_sum_ms": mcm.get("dots_sum", 0.0),
                "lane_allreduce_ms": rest.get("allreduce", 0.0),
                "kernels_ms": rest.get("kernels", 0.0),
                "staging_ms": rest.get("stage", 0.0) + mcm.get("stage", 0.0),
                "staged_gb": s0["staged_bytes"] / 1e9, "drops": s0["drops"]}
            steps.append(step)
            d = step["drops"]
            print(f"[smoke] p13 ({tag}) {name}: {step['ms']:.1f} ms "
                  f"(slowest rank), loss {step['loss']:.4f}; rank 0: FSDP "
                  f"all-gather {step['fsdp_all_gather_ms']:.1f} ms, "
                  f"reduce-scatter {step['reduce_scatter_ms']:.1f}, RVH "
                  f"exchange {step['rvh_exchange_ms']:.1f}, model all-reduce "
                  f"{step['tp_allreduce_ms']:.1f} ms / "
                  f"{step['tp_allreduce_bytes'] / 1e6:.1f} MB (the MoE's "
                  f"{step['moe_allreduce_ms']:.1f} ms / "
                  f"{step['moe_allreduce_bytes'] / 1e6:.1f} MB), model "
                  f"all-gather {step['tp_all_gather_ms']:.1f}, dot sums "
                  f"{step['dots_sum_ms']:.1f} + model "
                  f"{step['model_dots_sum_ms']:.1f}, lane all-reduce "
                  f"{step['lane_allreduce_ms']:.1f}, kernels "
                  f"{step['kernels_ms']:.1f}, staging "
                  f"{step['staging_ms']:.1f} ms; staged "
                  f"{step['staged_gb']:.2f} GB; dropped pairs "
                  f"{d['dropped']} of {d['pairs']} ({d['calls']} MoE "
                  f"dispatches) | {card}")
        launches = r0["launches"]
        bitwise = all(all(r["bitwise"]) for r in rows)
        repeat = all(r["repeat_bitwise"] for r in rows)
        tw = r0.get("twin")
        print(f"[smoke] p13 ({tag}) launches on rank 0: block_dots="
              f"{launches.get('block_dots', 0)} block_combine="
              f"{launches.get('block_combine', 0)}; the leaves left whole "
              f"bitwise across the ranks holding them (the router among "
              f"them)={bitwise}, step 1 again bitwise={repeat}"
              + (f"; step 1 vs its twin: worst leaf {tw['leaf']} "
                 f"{tw['max_abs_err']:.3e} against {tw['tol']:.3e} (ratio "
                 f"{tw['worst_ratio']:.2f}), twin loss {twin['bf16_loss']:.4f}"
                 if tw else "") + f" | {card}")
        assert all(r["mesh"] == [config.data_mesh, config.model_mesh]
                   for r in rows), [r["mesh"] for r in rows]
        assert r0["regime"]["fsdp"] and r0["regime"]["scatter_grads"]
        for r in rows:
            for k in ("params", "state"):
                assert abs(r["held_gib"][k] - r["plan_gib"][k]) < 1e-9, r
        assert all(math.isfinite(x["loss"]) for x in steps)
        for k in ("block_dots", "block_combine"):
            assert launches.get(k, 0) > 0, \
                f"{k} never launched in phase 13 ({tag})"
        assert bitwise and repeat
        assert all(x["moe_allreduce_bytes"] > 0 for x in steps)
        if tag == "d1":
            assert tw["worst_ratio"] <= 1.0, tw
        assert sum(peaks) <= RANK_MEM_GIB and sum(inits) <= RANK_MEM_GIB, \
            (peaks, inits)
        out[tag] = {
            "arch": arch, "layers": layers, "steps": steps,
            "launches": launches, "twin": tw, "bitwise": bitwise,
            "repeat_bitwise": repeat,
            "held_gib": [r["held_gib"] for r in rows],
            "plan_gib": r0["plan_gib"], "peak_gib": peaks,
            "init_peak_gib": inits, "regime": r0["regime"],
            "mesh": r0["mesh"], "span": r0["span"], "path": r0["path"],
            "rank0_s": {k: r0[k] for k in ("init_s", "steps_s",
                                           "repeat_s")}}
    # the kernels at RVH's round-0 half of a rank's part of one of
    # mixtral's expert stacks (bf16, as its lane gradient): its model
    # shard (8 x 6144 x 16384 / 4) halved across the two RVH ranks
    n = 8 * 6144 * 16384 // MIXTRAL_GRID[1] // 2
    cases = _adasum_case("mixtral_expert_half", n, 8192, dtype="bfloat16",
                         flat=True, device=True)
    for c in cases:
        print(f"[smoke] p13 (d1) kernel {c['kernel']:14s} {c['case']} err "
              f"{c['max_abs_err']:.2e} (tol {c['tol']:.0e}) ms "
              f"{c['ms']:.4f} [device {c['device_ms']:.4f}] plain "
              f"{c['plain_ms']:.4f} library {c['library_ms']:.4f} [device "
              f"{c['library_device_ms']:.4f}] bound {c['bound_ms']:.4f} "
              f"({c['bound_by']}) {'ok' if c['ok'] else 'FAIL'} | {card}")
    assert all(c["ok"] for c in cases), cases
    out["cases"] = cases
    return out


def _comb_report(card: str, recs: list, twins: dict) -> dict:
    """Phase 13 (e) from its ranks' records (`rec["e"]`): printed and
    checked."""
    out = {}
    for tag, config, _, _, plain in _comb_runs():
        rows = [r["e"][tag] for r in recs]
        r0 = rows[0]
        again = tag in COMB_REPEAT
        peaks = [r["peak_gib"] for r in rows]
        inits = [r["init_peak_gib"] for r in rows]
        for r in rows:
            print(f"[smoke] p13 ({tag}) rank {r['rank']}: holds params "
                  f"{r['held_gib']['params']:.3f} GiB (plan "
                  f"{r['plan_gib']['params']:.3f}), state "
                  f"{r['held_gib']['state']:.3f} (plan "
                  f"{r['plan_gib']['state']:.3f}); its lane gradient's plan "
                  f"{r['plan_gib']['grads']:.3f}; init peak "
                  f"{r['init_peak_gib']:.2f}, step peak {r['peak_gib']:.2f} "
                  f"GiB | {card}")
        reg = r0["regime"]
        print(f"[smoke] p13 ({tag}) qwen3-32b preset at full width, "
              f"{TP_LAYERS} of 64 layers, grid (data, model) = "
              f"{tuple(r0['mesh'])}, {len(rows)} gloo ranks on cuda:0: "
              f"combine={reg['combine']} backend={reg['backend']} "
              f"per_layer={reg['per_layer']}, {reg['optimizer']} "
              f"({r0['point']} point), fsdp={reg['fsdp']} scatter_grads="
              f"{reg['scatter_grads']}, params {reg['param_dtype']}, state "
              f"{reg['opt_state_dtype']}, span {r0['span']}, path="
              f"{r0['path']}, bf16 compute, seq {TP_SEQ}, batch "
              f"{TP_BATCH}; of {r0['leaves']} leaves {r0['data_sharded']} "
              f"cut on the data axis, {r0['model_sharded']} on the model "
              f"axis; init peaks sum {sum(inits):.2f} GiB (max "
              f"{max(inits):.2f}), step peaks sum {sum(peaks):.2f} (max "
              f"{max(peaks):.2f}); rank 0's seconds: init "
              f"{r0['init_s']:.1f}, step {r0['steps_s']:.1f}"
              + (f", repeat {r0['repeat_s']:.1f}" if again else "")
              + (f", plain arm {r0['plain_s']:.1f}" if plain else "")
              + f" | {card}")
        steps = []
        runs = [("step 0", [r["steps"][0] for r in rows])]
        if again:
            runs.append(("repeat (steady)", [r["repeat_step"] for r in rows]))
        for name, got in runs:
            s0 = got[0]
            mcm, rest = s0["model_comm"], s0["rest_comm"]
            step = {
                "name": name, "ms": max(x["ms"] for x in got),
                "loss": s0["loss"],
                "fsdp_all_gather_ms": rest.get("all_gather", 0.0),
                "reduce_scatter_ms": rest.get("reduce_scatter", 0.0),
                "exchange_ms": rest.get("exchange", 0.0),
                "allreduce_ms": rest.get("allreduce", 0.0),
                "tp_allreduce_ms": mcm.get("allreduce", 0.0),
                "tp_allreduce_bytes": s0["tp_bytes"].get("allreduce", 0),
                "dots_sum_ms": rest.get("dots_sum", 0.0),
                "model_dots_sum_ms": mcm.get("dots_sum", 0.0),
                "kernels_ms": rest.get("kernels", 0.0),
                "staging_ms": rest.get("stage", 0.0) + mcm.get("stage", 0.0),
                "staged_gb": s0["staged_bytes"] / 1e9}
            steps.append(step)
            print(f"[smoke] p13 ({tag}) {name}: {step['ms']:.1f} ms "
                  f"(slowest rank), loss {step['loss']:.4f}; rank 0: FSDP "
                  f"all-gather {step['fsdp_all_gather_ms']:.1f} ms, "
                  f"reduce-scatter {step['reduce_scatter_ms']:.1f}, the "
                  f"combiner's exchange {step['exchange_ms']:.1f} and "
                  f"all-reduce (with the lane groups') "
                  f"{step['allreduce_ms']:.1f}, model all-reduce "
                  f"{step['tp_allreduce_ms']:.1f} ms / "
                  f"{step['tp_allreduce_bytes'] / 1e6:.1f} MB, dot and "
                  f"moment sums {step['dots_sum_ms']:.1f} + model "
                  f"{step['model_dots_sum_ms']:.1f}, kernels "
                  f"{step['kernels_ms']:.1f}, staging "
                  f"{step['staging_ms']:.1f} ms; staged "
                  f"{step['staged_gb']:.2f} GB | {card}")
        launches = {k: r0["launches"].get(k, 0)
                    for k in ("block_dots", "block_combine")}
        bitwise = all(all(r["bitwise"]) for r in rows)
        repeat = all(r["repeat_bitwise"] for r in rows) if again else None
        tw = r0.get("twin")
        print(f"[smoke] p13 ({tag}) launches on rank 0: {launches}; the "
              f"leaves left whole bitwise across the ranks holding them="
              f"{bitwise}, step 1 again bitwise="
              f"{repeat if again else 'not run (COMB_REPEAT)'}"
              + (f"; step 1 vs its twin: worst leaf {tw['leaf']} "
                 f"{tw['max_abs_err']:.3e} against {tw['tol']:.3e} (ratio "
                 f"{tw['worst_ratio']:.2f}), twin loss "
                 f"{twins[tag]['bf16_loss']:.4f}" if tw else "")
              + (f"; kernel arm vs plain arm on step 1's lane tree: "
                 f"combined rel_err {r0['combined_rel_err']:.3e} (tol "
                 f"{COMBINED_BF16_RTOL:.3e}, bf16)" if plain else "")
              + f" | {card}")
        assert all(r["mesh"] == [config.data_mesh, config.model_mesh]
                   for r in rows), [r["mesh"] for r in rows]
        assert reg["fsdp"] and reg["scatter_grads"], reg
        assert r0["span"] < config.data_mesh, r0["span"]
        for r in rows:
            for k in ("params", "state"):
                assert abs(r["held_gib"][k] - r["plan_gib"][k]) < 1e-9, r
        assert all(math.isfinite(x["loss"]) for x in steps)
        assert bitwise and repeat is not False, (tag, bitwise, repeat)
        if tag in twins:
            assert tw["worst_ratio"] <= 1.0, (tag, tw)
        if plain:
            assert all(n > 0 for n in launches.values()), \
                f"an Adasum kernel never launched in phase 13 ({tag})"
            assert r0["combined_rel_err"] <= COMBINED_BF16_RTOL, r0
        assert sum(peaks) <= RANK_MEM_GIB and sum(inits) <= RANK_MEM_GIB, \
            (tag, peaks, inits)
        out[tag] = {
            "steps": steps, "launches": launches, "twin": tw,
            "bitwise": bitwise, "repeat_bitwise": repeat,
            "held_gib": [r["held_gib"] for r in rows],
            "plan_gib": r0["plan_gib"], "peak_gib": peaks,
            "init_peak_gib": inits, "regime": reg, "mesh": r0["mesh"],
            "span": r0["span"], "path": r0["path"], "point": r0["point"],
            "combined_rel_err": r0.get("combined_rel_err"),
            "rank0_s": {k: r0[k] for k in ("init_s", "steps_s", "repeat_s",
                                           "plain_s") if k in r0}}
    return out


def _full_layers(arch: str) -> int:
    from repro_torch.configs import get_config
    return get_config(arch).n_layers


def _pad_serve(card: str) -> dict:
    """Phase 13 (b): head padding in serving (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch.bridge import pad_params
    from repro_torch.configs import get_config, pad_heads_for_tp
    from repro_torch.engine import EngineConfig, ServeEngine
    from repro_torch.engine.serving.engine import resolve_serve_parts
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    mesh = make_production_mesh()
    full = get_config("minitron-4b")
    ecfg = EngineConfig(arch="minitron-4b", pad_heads=True, max_slots=4,
                        max_len=128, page_size=16, param_dtype="bfloat16")
    # the engine's own path pads for the mesh's model axis
    got = resolve_serve_parts(ecfg, mesh=mesh, params={}, device="cuda")[0]
    assert got.cfg == pad_heads_for_tp(full, mesh.axis_size("model"))
    cfg = dataclasses.replace(full, n_layers=PAD_LAYERS)
    pcfg = pad_heads_for_tp(cfg, mesh.axis_size("model"))
    print(f"[smoke] p13 (b) minitron-4b (arXiv:2407.14679) at full width, "
          f"{PAD_LAYERS} of {full.n_layers} layers: heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} (G {cfg.n_heads // cfg.n_kv_heads}) padded for "
          f"the production mesh's model axis {mesh.axis_size('model')} to "
          f"{pcfg.n_heads}/{pcfg.n_kv_heads} (G "
          f"{pcfg.n_heads // pcfg.n_kv_heads}); {cfg.param_count() / 1e9:.2f}"
          f" -> {pcfg.param_count() / 1e9:.2f} B params in bf16 | {card}")
    bf = torch.bfloat16
    model = build_model(cfg, compute_dtype=bf, param_dtype=bf)
    pmodel = build_model(pcfg, compute_dtype=bf, param_dtype=bf)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    pparams = pad_params(params, cfg, pcfg)
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in PAD_PROMPTS]
    warm = ServeEngine(ecfg, model, params)
    _greedy(warm, prompts[:1], [1], 2)
    del warm

    def engine(padded):
        if padded:
            return ServeEngine.from_config(ecfg, model=pmodel,
                                           params=pparams, device="cuda",
                                           mesh=mesh)
        return ServeEngine(ecfg, model, params)

    runs = {}
    for tag in ("unpadded", "padded"):
        eng = engine(tag == "padded")
        torch.cuda.synchronize()
        build.reset_launches()
        handles = _greedy(eng, prompts, [len(prompts)], PAD_GEN)
        torch.cuda.synchronize()
        tp = eng.throughput()
        runs[tag] = {"tokens": [h.tokens for h in handles],
                     "launches": dict(build.LAUNCHES),
                     "prefill_ms": tp["prefill_ms_mean"],
                     "tick_ms": tp["decode_tick_ms_mean"],
                     "completed": tp["completed"]}
        assert tp["completed"] == len(prompts) and eng.leaked_pages() == 0
        del eng
        print(f"[smoke] p13 (b) {tag}: prefill {runs[tag]['prefill_ms']:.2f}"
              f" ms, tick {runs[tag]['tick_ms']:.2f} ms, launches "
              f"{runs[tag]['launches']} | {card}")
    a, b = runs["unpadded"]["tokens"], runs["padded"]["tokens"]
    agree = _agreement(a, b)
    margins = _divergence_margins(model, params, prompts, a, b,
                                  ecfg.serve_max_len())
    # every attention call of the padded engine against its plain version
    errs = {"flash_attention": [], "paged_decode_attention": []}
    fk, dk = FA.flash_attention, FA.paged_decode_attention

    def flash(q, k, v, **kw):
        out = fk(q, k, v, **kw)
        ref = FA.flash_attention_ref(q, k, v, **kw)
        errs["flash_attention"].append(
            (out.float() - ref.float()).abs().max().item())
        return out

    def decode(q, kp, vp, table, pos, **kw):
        out = dk(q, kp, vp, table, pos, **kw)
        ref = FA.paged_decode_attention_ref(q, kp, vp, table, pos, **kw)
        errs["paged_decode_attention"].append(
            (out.float() - ref.float()).abs().max().item())
        return out

    FA.flash_attention, FA.paged_decode_attention = flash, decode
    try:
        eng = engine(True)
        _greedy(eng, prompts, [len(prompts)], PAD_GEN)
        del eng
    finally:
        FA.flash_attention, FA.paged_decode_attention = fk, dk
    # the logits in fp32 compute (plain attention), padded vs unpadded
    toks = torch.tensor(prompts[-1][None], device="cuda")
    f32 = torch.float32
    la = build_model(cfg, compute_dtype=f32, param_dtype=bf,
                     attn_impl="plain").forward(params, toks)
    lb = build_model(pcfg, compute_dtype=f32, param_dtype=bf,
                     attn_impl="plain").forward(pparams, toks)
    fp32_err = (la - lb).abs().max().item()
    del la, lb
    print(f"[smoke] p13 (b) tokens padded vs unpadded: equal share "
          f"{agree['equal_share']:.3f}, first divergences "
          f"{agree['first_divergence']}, margins "
          f"{[round(m, 4) for m in margins]} (tol {LOGIT_TOL}); fp32 "
          f"logits max abs {fp32_err:.2e} (tol {PAD_FP32_TOL}); "
          f"{len(errs['flash_attention'])} flash and "
          f"{len(errs['paged_decode_attention'])} paged-decode calls at "
          f"the padded shapes vs their plain versions: max "
          f"{max(errs['flash_attention']):.2e} / "
          f"{max(errs['paged_decode_attention']):.2e} (tol "
          f"{KERNEL_TOL['bfloat16']}) | {card}")
    assert all(abs(m) <= LOGIT_TOL for m in margins), margins
    assert fp32_err <= PAD_FP32_TOL, fp32_err
    for k, v in errs.items():
        assert v and max(v) <= KERNEL_TOL["bfloat16"], (k, max(v))
    del params, pparams, model, pmodel
    _free()
    # the kernels at the padded shapes and at RVH's half of the TP shard
    # of qwen3-32b's embedding (tensor-parallel over 2, data world 2), timed
    cases = [
        _flash_case("minitron_pad_prefill", 4, 128, 128, H=pcfg.n_heads,
                    KV=pcfg.n_kv_heads, Dh=pcfg.resolved_head_dim),
        _decode_case("minitron_pad_tick", 4, 8, [79, 95, 111, 127],
                     H=pcfg.n_heads, KV=pcfg.n_kv_heads,
                     Dh=pcfg.resolved_head_dim)]
    cases += _adasum_case("tp_embed_half_w2", 151_936 * 5120 // 4, 8192,
                          flat=True)
    for c in cases:
        print(f"[smoke] p13 kernel {c['kernel']:22s} {c['case']:20s} err "
              f"{c['max_abs_err']:.2e} (tol {c['tol']:.0e}) ms "
              f"{c['ms']:.4f} plain {c['plain_ms']:.4f} library "
              f"{c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
              f"({c['bound_by']})"
              + (f" device {c['device_ms']:.4f} library_device "
                 f"{c['library_device_ms']:.4f}" if "device_ms" in c else "")
              + f" {'ok' if c['ok'] else 'FAIL'} | {card}")
    bad = [f"{c['kernel']}/{c['case']}" for c in cases if not c["ok"]]
    assert not bad, f"kernel != plain beyond tolerance: {bad}"
    return {"runs": runs, "agreement": agree, "margins": margins,
            "fp32_err": fp32_err, "call_errs": {k: max(v) for k, v in
                                                errs.items()},
            "calls": {k: len(v) for k, v in errs.items()},
            "cases": cases, "launches": runs["padded"]["launches"]}


def model_axis_phase(card: str, twins=None) -> dict:
    """Phase 13: the model axis (see the module docstring). `twins`: the
    records of P13_TWINS already computed and saved (`p13_twins`); the
    rest are computed here first."""
    import torch
    t0 = time.perf_counter()
    _free()
    free, total = torch.cuda.mem_get_info()
    print(f"[smoke] p13: before the phase this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; the "
          f"card {(total - free) / 2**30:.2f} of {total / 2**30:.2f} GiB in "
          f"use | {card}")
    twins = dict(twins or {})
    try:
        todo = [t for t in P13_TWINS if t not in twins]
        if todo:
            twins.update(p13_twins(card, todo))
        t1 = time.perf_counter()
        recs = _spawn_ranks(GRID_SHAPE[0] * GRID_SHAPE[1], "grid_w8",
                            {t: str(_twin_path(t)) for t in P13_TWINS},
                            flag="--grid-worker")
    finally:
        for t in P13_TWINS:
            _twin_path(t).unlink(missing_ok=True)
    grid = _grid_report(card, recs, time.perf_counter() - t1)
    fam = _fam_report(card, recs, twins["d1"])
    comb = _comb_report(card, recs, {t: twins[t] for t in ("e1", "e2")})
    grid["twin_s"] = {t: twins[t]["twin_s"] for t in P13_TWINS}
    t2 = time.perf_counter()
    serve = _pad_serve(card)
    serve["wall_s"] = time.perf_counter() - t2
    # the main path's launches of phase 13: (c)'s and (e4)'s rank 0 (the
    # Adasum kernels) and (b)'s padded run (attention)
    launches = {k: grid["launches"].get(k, 0) + comb["e4"]["launches"][k]
                for k in ("block_dots", "block_combine")}
    launches.update({k: serve["launches"].get(k, 0)
                     for k in ("flash_attention", "paged_decode_attention")})
    walls = {t: round(sum(comb[t]["rank0_s"].values()), 1)
             for t in ("e1", "e2", "e3", "e4")}
    print(f"[smoke] model axis launches={launches}; (c) launches="
          f"{grid['launches']}; (d) launches "
          f"{ {t: fam[t]['launches'] for t in ('d1', 'd2')} }; "
          f"phase13e_launches "
          f"{ {t: comb[t]['launches'] for t in ('e1', 'e2', 'e3', 'e4')} }"
          f"; twins {len(todo)} here, {len(P13_TWINS) - len(todo)} before "
          f"(s: { {t: round(x, 1) for t, x in grid['twin_s'].items()} }); "
          f"(c), (d) and (e) {grid['wall_s']:.1f} s ((e)'s runs on rank 0 "
          f"{walls}), (b) {serve['wall_s']:.1f} s; phase "
          f"{time.perf_counter() - t0:.1f} s | {card}")
    return {"grid": grid, "families": fam, "serve": serve,
            "combiners": comb, "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace an admission tick and five decode ticks "
                    "after the serve phase, and a fourth step of each "
                    "train run, with torch.profiler")
    ap.add_argument("--serve-ab", metavar="DIR",
                    help="instead of the phases: the serve phase on DIR's "
                    "checkout and this one, in turns DIR, this, this, DIR")
    ap.add_argument("--scan-ab", metavar="DIR",
                    help="instead of the phases: phase 8 (e)'s scan "
                    "prefill on DIR's checkout and this one, in turns DIR, "
                    "this, this, DIR")
    ap.add_argument("--serve-only", metavar="SRC", help=argparse.SUPPRESS)
    ap.add_argument("--scan-only", metavar="SRC", help=argparse.SUPPRESS)
    ap.add_argument("--rank-worker", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--combiners-worker", metavar="SPEC",
                    help=argparse.SUPPRESS)
    ap.add_argument("--elastic-worker", metavar="SPEC",
                    help=argparse.SUPPRESS)
    ap.add_argument("--grid-worker", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--model-axis-only", action="store_true",
                    help="build the kernels and run phase 13 alone; prints "
                    "no result line")
    ap.add_argument("--subsystems-only", action="store_true",
                    help="build the kernels and run phase 10 alone; prints "
                    "no result line")
    ap.add_argument("--families-only", action="store_true",
                    help="build the kernels and run phase 11 alone; prints "
                    "no result line")
    ap.add_argument("--recurrent-only", action="store_true",
                    help="build the kernels and run phase 12 alone; prints "
                    "no result line")
    ap.add_argument("--ranks-only", action="store_true",
                    help="build the kernels and run phase 6 alone; prints "
                    "no result line")
    ap.add_argument("--witness", action="store_true",
                    help="phase 6 also holds (A)'s step 1 in fp32 compute "
                    "against one process (~1 min more)")
    ap.add_argument("--combiners-only", action="store_true",
                    help="build the kernels and run phase 9 alone (with "
                    "--profile: and trace one overlapped and one serial "
                    "delayed round); prints no result line")
    args = ap.parse_args(argv)
    if args.rank_worker:                # one rank of phase 6
        return rank_worker(json.loads(args.rank_worker))
    if args.combiners_worker:           # one rank of phase 9 (c)
        return combiners_worker(json.loads(args.combiners_worker))
    if args.elastic_worker:             # one rank of phase 10 (b)
        return elastic_worker(json.loads(args.elastic_worker))
    if args.grid_worker:                # one rank of phase 13 (c)-(e)
        return grid_worker(json.loads(args.grid_worker))

    card = _smi()
    print(card)
    # before CUDA starts: lets empty_cache return the card memory the
    # phases leave fragmented, which the rank processes of phase 6 need
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    one = args.serve_only or args.scan_only
    src = Path(one) if one else ROOT / "src"
    sys.path.insert(0, str(src))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2
    if args.serve_ab or args.scan_ab:
        return run_ab(Path(args.serve_ab or args.scan_ab),
                      "serve" if args.serve_ab else "scan")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}")
    if args.serve_only:                 # one run of --serve-ab
        print(f"[smoke] built kernels in {build.build_all():.1f}s")
        print("SERVE " + json.dumps(serve_phase(card)[0]["metrics"]))
        return 0
    if args.scan_only:                  # one run of --scan-ab
        print("SCAN " + json.dumps(scan_phase(card)))
        return 0
    record = {"card": card}
    try:
        warm = _warm_up()         # while nvcc builds
        secs = build.build_all()
        _join(warm)
        print(f"[smoke] built kernels {build.sources()} in {secs:.1f}s")
        record["build_s"] = secs
        if args.combiners_only:
            record["combiners"] = combiners_phase(card, args.profile)
            return 0
        if args.ranks_only:
            t0 = time.perf_counter()
            record["ranks"] = ranks_phase(card, args.witness)
            print(f"[smoke] phase 6 wall {time.perf_counter() - t0:.1f} s "
                  f"| {card}")
            return 0
        if args.subsystems_only:
            record["subsystems"] = subsystems_phase(card)
            return 0
        if args.families_only:
            record["families"] = families_phase(card)
            return 0
        if args.recurrent_only:
            record["recurrent"] = recurrent_phase(card)
            return 0
        if args.model_axis_only:
            t0 = time.perf_counter()
            record["model_axis"] = model_axis_phase(card)
            print(f"[smoke] phase 13 wall {time.perf_counter() - t0:.1f} s "
                  f"| {card}")
            return 0
        walls = record["phase_wall_s"] = {"2": secs}
        t_mark = [time.perf_counter()]

        def mark(phase: str):
            now = time.perf_counter()
            walls[phase] = now - t_mark[0]
            t_mark[0] = now

        # the ranks first: their four processes share the card, and need
        # the memory the later phases would leave beside them. Beside
        # their launches (~15 GiB) this process computes phase 13's twins
        # and runs phase 11 and two parts of phase 12
        record["ranks"] = ranks_phase(card, args.witness, beside={
            "a": lambda: (p13_twins(card, ("c", "d1")),
                          recurrent_parts(card, P12_EARLY["a"])),
            "b": lambda: families_phase(card),
            "A": lambda: (p13_twins(card, ("e1", "e2")),
                          recurrent_parts(card, P12_EARLY["A"]))})
        got = record["ranks"].pop("beside")
        record["families"] = got["b"]
        twins = {**got["a"][0], **got["A"][0]}
        p12_done = {**got["a"][1], **got["A"][1], "part_s": {
            **got["a"][1]["part_s"], **got["A"][1]["part_s"]}}
        mark("6")
        cases = record["kernel_cases"] = kernel_phase()
        mark("3")
        record["serve"], parts = serve_phase(card, args.profile)
        mark("4")
        record["serve_ext"] = ext_phase(card, *parts)
        del parts
        _free()
        mark("8")
        record["train"] = train_phase(card, args.profile)
        mark("5")
        # the model axis before phase 7, which leaves a session behind
        _free()
        record["model_axis"] = model_axis_phase(card, twins)
        _free()
        mark("13")

        def ckpt():
            out = ckpt_phase(card, record["ranks"])
            # phase 7's last session stays reachable from the SIGTERM
            # handler its checkpoint manager installed (as the
            # reference's does): 12 GiB of params and state on the card
            # until the handler goes
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            _free()
            return out

        # phase 7 in this process while phase 9 (c)'s ranks run
        record["combiners"] = combiners_phase(
            card, args.profile, record["train"]["runs"][
                "{}_span{}".format(*TRAIN_RUNS[0])]["params_sums_step1"],
            beside=ckpt)
        record["ckpt"] = record["combiners"].pop("beside")
        _free()
        mark("9")
        # phase 12 in this process while phase 10 (b)'s ranks run
        record["subsystems"] = subsystems_phase(
            card, beside=lambda: recurrent_phase(card, p12_done))
        record["recurrent"] = record["subsystems"].pop("beside")
        _free()
        mark("10")
        print(f"[smoke] phase wall s "
              f"{ {k: round(v, 1) for k, v in walls.items()} } (6 with "
              f"11 and phase 13's twins beside its ranks, 9 with 7, 10 "
              f"with 12), phases 2-13 {sum(walls.values()):.1f} s | {card}")
    except Exception:                   # any phase failing fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        for t in P13_TWINS:          # left behind only by a failed run
            _twin_path(t).unlink(missing_ok=True)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(
            json.dumps(record, indent=1, default=str))

    # launches: each kernel's count from the main-path run that drives it
    # (serve for attention, the momentum/span-4 train run for Adasum)
    launches = dict(record["serve"]["launches"])
    first = record["train"]["runs"][
        "{}_span{}".format(*TRAIN_RUNS[0])]["launches"]
    launches.update({k: first[k] for k in ("block_dots", "block_combine")})
    # and beside them, their launches on rank 0 of each of phase 6's runs
    # and their times on RVH's 1-D round-0 half
    rvh_launches = {t: record["ranks"]["runs"][f"{o}_w{w}"]["launches"][0]
                    for t, o, w, _, _ in RANK_RUNS}
    rvh_ms = {c["kernel"]: c["ms"] for c in cases
              if c["case"] == "rvh_half_w4"}
    # and their launches inside phase 7: the resumed step (prefetch on) and
    # serving the checkpoint
    ck = record["ckpt"]
    ck_launches = dict(ck["serve"]["launches"])
    ck_launches.update({k: ck["resume"]["prefetch_on"]["launches"][k]
                        for k in ("block_dots", "block_combine")})
    # and the attention kernels' launches inside phase 8, the Adasum
    # kernels' inside phase 9
    ext_launches = record["serve_ext"]["launches"]
    p9_launches = record["combiners"]["launches"]
    p10_launches = record["subsystems"]["launches"]
    p11_launches = record["families"]["launches"]
    p12_launches = record["recurrent"]["launches"]
    p13 = record["model_axis"]
    p13_cases = {c["kernel"]: c for c in p13["serve"]["cases"]}
    p13c_cases = {c["kernel"]: c for c in p13["grid"]["cases"]}
    p13d_cases = {c["kernel"]: c for c in p13["families"]["cases"]}
    main_cases = {"serve_extend", "serve_tick", "embed_fp32"}
    sources = {
        "flash_attention": ("csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:41"),
        "paged_decode_attention": ("csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:131"),
        "block_dots": ("csrc/adasum.cu",
                       "src/repro/kernels/adasum_dots.py:49"),
        "block_combine": ("csrc/adasum.cu",
                          "src/repro/kernels/adasum_combine.py:21"),
    }
    rows = []
    for c in cases:
        if c["case"] not in main_cases:
            continue
        src, replaces = sources[c["kernel"]]
        rows.append({
            "name": c["kernel"], "route": "cuda",
            "source": "src/repro_torch/kernels/" + src,
            "replaces": replaces,
            "launches": launches.get(c["kernel"], 0),
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "device_ms": c.get("device_ms"),
            "library_device_ms": c.get("library_device_ms"),
            "phase7_launches": ck_launches[c["kernel"]],
            "phase10_launches": p10_launches[c["kernel"]],
            "phase11_launches": p11_launches[c["kernel"]],
            "phase12_launches": p12_launches[c["kernel"]],
            "phase13_launches": p13["launches"][c["kernel"]],
            "phase13_case": {k: p13_cases[c["kernel"]][k] for k in (
                "case", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}})
        if c["kernel"] in ("flash_attention", "paged_decode_attention"):
            rows[-1]["phase8_launches"] = ext_launches[c["kernel"]]
        if c["kernel"] in rvh_ms:
            rows[-1].update(rvh_launches={
                t: n[c["kernel"]] for t, n in rvh_launches.items()},
                rvh_half_ms=rvh_ms[c["kernel"]],
                phase9_launches=p9_launches[c["kernel"]],
                phase13c_launches=p13["grid"]["launches"][c["kernel"]],
                phase13c_case={k: p13c_cases[c["kernel"]][k] for k in (
                    "case", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")},
                phase13d_launches={
                    t: p13["families"][t]["launches"][c["kernel"]]
                    for t in ("d1", "d2")},
                phase13d_case={k: p13d_cases[c["kernel"]][k] for k in (
                    "case", "max_abs_err", "ms", "device_ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms",
                    "library_device_ms")},
                phase13e_launches={
                    t: p13["combiners"][t]["launches"][c["kernel"]]
                    for t in ("e1", "e2", "e3", "e4")})
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
