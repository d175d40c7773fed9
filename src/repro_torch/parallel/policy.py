"""The port's copy of `repro/parallel/policy.py` (RunPolicy only).

Per-architecture runtime policy: Adasum span, FSDP, optimizer, backend.

`span` = number of Adasum leaves (paper: one per node/pod-group). For
small/medium archs one lane per DP rank (paper-pure tree over all ranks,
RVH backend). For the huge archs the paper's hierarchical mode (§4.2.2 +
§4.3) applies: plain sum-reduce inside a lane group (GSPMD reduce-scatter,
overlapped with backward) and Adasum across `span` lane groups, with
optimizer state ZeRO-partitioned. Field names and defaults are the
reference's, so a policy means the same in both packages. Across ranks
`fsdp` shards the params and `scatter_grads` the lane gradients over the
data ranks, and the optimizer state is ZeRO-1 sharded by itself
(`repro_torch.parallel.zero`); on one device the sharding fields (fsdp,
scatter_grads, pad_heads) change nothing, as in the reference.
"""
from __future__ import annotations

import dataclasses

@dataclasses.dataclass(frozen=True)
class RunPolicy:
    span: int = 0               # 0 => one lane per DP rank
    fsdp: bool = False          # ZeRO-3 params over `data`
    scatter_grads: bool = False # ZeRO-2: lane grads over `data` (span < dp)
    backend: str = "rvh"        # combine backend when span==dp
    optimizer: str = "adam"
    param_dtype: str = "float32"
    local_steps: int = 1        # paper §5.2: local SGD steps per allreduce
    combine_delay: int = 0      # DaSGD-style delayed combine: the Adasum
                                # exchange for round i-1's deltas overlaps
                                # round i's compute (0 = synchronous)
    combine_op: str = "adasum"
    attn_chunk: int = 512
    accum_steps: int = 1        # microbatch gradient accumulation (§2.2):
                                # bounds saved-activation memory by 1/A
    accum_dtype: str = "float32"      # gradient-accumulator storage
    opt_state_dtype: str = "float32"  # Adam/LAMB m,v storage
    pad_heads: bool = False           # TP head alignment (exact; see
                                      # configs.base.pad_heads_for_tp)
    # combiner knobs, plumbed through to CombineConfig by the step builder
    # (previously silently dropped — paper §3.6 ablation was unreachable)
    combine_point: str = "auto"       # 'pre' | 'post' | 'auto'
    per_layer: bool = True            # per-layer Adasum granularity (§3.6)
    acc_dtype: str = "float32"        # dot accumulation dtype (§4.4.1)
    use_pallas: bool = False          # Pallas kernels for dots/combine
    compress: str = "none"            # 'int8' RVH wire compression
    fused_combine: bool = True        # bucketed single-pass gspmd_tree path
    fusion_threshold_mb: int = 64     # Horovod-style bucket budget (§4.4.3)
    combine_stats: bool = True        # surface CombineStats (grad-noise /
                                      # lane-orthogonality / gain metrics)
                                      # from the combiner's own dot products


