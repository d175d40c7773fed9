"""Deterministic, restart-safe data pipeline (the port's numpy copy of
`repro/data/pipeline.py`).

Every batch is a pure function of (seed, step, host_slice), drawn with
numpy exactly as the reference draws it, so both packages see bitwise
identical batches for the same config and step. The sources return
numpy arrays; the training session moves them to the device.

Sources:
  * SyntheticLM  — zipf-ish token stream with a planted bigram structure
    (so models actually have something learnable).
  * MemmapTokens — fixed token file (np.memmap), deterministic chunking.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    kind: str = "synthetic"      # synthetic | memmap
    path: Optional[str] = None
    host_start: int = 0          # this host's slice of the global batch
    host_rows: int = 0           # 0 => all rows


class SyntheticLM:
    """Learnable synthetic stream: per-document Markov chain whose
    transition table is derived from a fixed seed."""

    def __init__(self, cfg: DataConfig,
                 model_cfg: Optional[ModelConfig] = None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self._succ = rng.integers(0, v, size=(v, 4), dtype=np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = cfg.host_rows or cfg.global_batch
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) % (2 ** 63))
        B, T, v = rows, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, T), np.int32)
        toks[:, 0] = rng.integers(0, v, size=B)
        branch = rng.integers(0, 4, size=(B, T))
        noise = rng.random((B, T)) < 0.1
        rand = rng.integers(0, v, size=(B, T))
        for t in range(1, T):
            nxt = self._succ[toks[:, t - 1], branch[:, t]]
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        out["labels"][:, -1] = -100
        mc = self.model_cfg
        if mc is not None and mc.frontend != "none":
            ft = mc.frontend_tokens or max(T // 2, 1)
            if mc.is_encoder_decoder:
                ft = T // 2
            out["frontend_embeds"] = rng.standard_normal(
                (B, ft, mc.frontend_dim)).astype(np.float32) * 0.02
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class MemmapTokens:
    def __init__(self, cfg: DataConfig):
        if not cfg.path:
            raise ValueError("memmap source needs a path")
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = cfg.host_rows or cfg.global_batch
        T = cfg.seq_len
        n_chunks = len(self.data) // (T + 1)
        rng = np.random.default_rng((cfg.seed * 9_999_991 + step) % (2 ** 63))
        idx = rng.integers(0, n_chunks, size=rows)
        toks = np.stack([self.data[i * (T + 1): i * (T + 1) + T]
                         for i in idx]).astype(np.int32)
        labels = np.stack([self.data[i * (T + 1) + 1: i * (T + 1) + T + 1]
                           for i in idx]).astype(np.int32)
        return {"tokens": toks, "labels": labels}


def make_source(cfg: DataConfig, model_cfg: Optional[ModelConfig] = None):
    if cfg.kind == "synthetic":
        return SyntheticLM(cfg, model_cfg)
    if cfg.kind == "memmap":
        return MemmapTokens(cfg)
    raise KeyError(cfg.kind)
