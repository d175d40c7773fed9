"""Checkpoint fault injection: mutate checkpoint bytes on disk (a copy of
`repro/chaos/faults.py`; the port writes the same files).

Each helper damages the NEWEST complete step under a checkpoint root in
one specific way, returning the step it hit (None when there is nothing
to damage). They model the storage faults the integrity layer
(`repro_torch.checkpoint.manager`) must catch:

    bitflip_leaf    silent single-bit corruption -> crc32 mismatch
    tear_leaf       truncated (torn) write       -> np.load failure
    drop_leaf       lost leaf file               -> missing leaf
    drop_manifest   lost manifest.json           -> step invisible

`drop_manifest` is the one class restore cannot *diagnose* — without a
manifest the dir no longer matches `all_steps()` at all — so recovery is
silent fallback to the previous step rather than quarantine.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Optional


def _newest_step_dir(root) -> Optional[Path]:
    """The newest fully-renamed step dir still carrying a manifest."""
    best, best_step = None, -1
    for p in Path(root).iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "manifest.json").exists():
            s = int(m.group(1))
            if s > best_step:
                best, best_step = p, s
    return best


def _leaf_file(d: Path, index: int) -> Optional[Path]:
    leaves = sorted(d.glob("leaf-*.npy"))
    return leaves[index % len(leaves)] if leaves else None


def bitflip_leaf(root, index: int = 0) -> Optional[int]:
    """Flip one bit in a leaf payload (last byte — inside the array data,
    past the .npy header, so np.load still succeeds and only the crc32
    catches it)."""
    d = _newest_step_dir(root)
    if d is None:
        return None
    f = _leaf_file(d, index)
    if f is None:
        return None
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0x01
    f.write_bytes(bytes(raw))
    return int(d.name.split("_")[1])


def tear_leaf(root, index: int = 0) -> Optional[int]:
    """Truncate a leaf file to half its length — the torn-write case;
    np.load fails on the short payload."""
    d = _newest_step_dir(root)
    if d is None:
        return None
    f = _leaf_file(d, index)
    if f is None:
        return None
    raw = f.read_bytes()
    f.write_bytes(raw[:max(1, len(raw) // 2)])
    return int(d.name.split("_")[1])


def drop_leaf(root, index: int = 0) -> Optional[int]:
    """Delete a leaf file outright."""
    d = _newest_step_dir(root)
    if d is None:
        return None
    f = _leaf_file(d, index)
    if f is None:
        return None
    f.unlink()
    return int(d.name.split("_")[1])


def drop_manifest(root) -> Optional[int]:
    """Delete manifest.json — the step stops matching `all_steps()`, so
    restores silently resolve to the previous step."""
    d = _newest_step_dir(root)
    if d is None:
        return None
    (d / "manifest.json").unlink()
    return int(d.name.split("_")[1])


APPLIERS = {"ckpt_bitflip": bitflip_leaf, "ckpt_torn": tear_leaf,
            "ckpt_drop_leaf": drop_leaf,
            "ckpt_drop_manifest": lambda root, index=0: drop_manifest(root),
            "reload_corrupt": bitflip_leaf}


def apply_ckpt_fault(kind: str, root, index: int = 0) -> Optional[int]:
    """Dispatch a checkpoint fault class to its byte-level applier."""
    return APPLIERS[kind](root, index)
