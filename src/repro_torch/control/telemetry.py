"""Run fingerprinting for controller telemetry (a copy of
`repro/control/telemetry.py`).

`session.run_metadata()` carries the git SHA of the working tree and a
stable hash of the resolved EngineConfig, so a recorded number can
always be traced back to the exact code + config that produced it —
including across the mid-run config mutations the adaptive controller
performs.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
from typing import Any, Dict, Optional


def git_sha(root: Optional[str] = None, short: bool = True) -> str:
    """The working tree's HEAD SHA ('' when not a git checkout / git
    unavailable — telemetry must never fail a run)."""
    try:
        args = ["git", "rev-parse", "--short" if short else "--verify",
                "HEAD"]
        out = subprocess.run(
            args, cwd=root or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10)
        return out.stdout.strip() if out.returncode == 0 else ""
    except Exception:
        return ""


def config_hash(cfg: Any) -> str:
    """Stable 12-hex digest of an EngineConfig (or any to_dict-able /
    plain dict): canonical-JSON sha1. Two configs hash equal iff every
    field matches — the adaptive controller's batch/span/lr mutations
    produce a new hash each resize."""
    if hasattr(cfg, "to_dict"):
        d = cfg.to_dict()
    elif isinstance(cfg, dict):
        d = cfg
    else:
        d = dict(vars(cfg))
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def run_fingerprint(cfg: Any = None) -> Dict[str, str]:
    """{'git_sha': ..., 'config_hash': ...} (config_hash omitted when no
    config given) — the fields append_history stamps on every row."""
    fp = {"git_sha": git_sha()}
    if cfg is not None:
        fp["config_hash"] = config_hash(cfg)
    return fp
