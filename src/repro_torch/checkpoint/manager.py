"""Atomic checkpoints in the reference's on-disk format (the port of
`repro/checkpoint/manager.py`).

Layout (one directory per step), byte for byte the reference's, so a
checkpoint written by `repro` restores here and the reverse:

    <root>/step_00000120.tmp/        # written first
        manifest.json                # step, n_leaves, time, leaves[]
        leaf-00000.npy ...           # one file per leaf, in flatten order
    <root>/step_00000120/            # atomic rename on completion

Each manifest entry holds the leaf's `file`, `path` (`keystr` of its
tree path, e.g. "['opt']['inner']['m']['embed']['table']"), `shape`,
`dtype` and the `crc32` of its C-order bytes. Leaves are the FULL logical
arrays, so a restore may use another lane count (`reshard_lanes`), and
another (data, model) grid: a run across ranks gathers its data and
model shards to full leaves on rank 0 and each rank of a restore takes
its part by the plan's specs (`parallel.zero.RankPlan.gather_tree` /
`take`). A head-padded config keeps its padded shapes, as in the
reference.

Leaves, as the reference stores them:
  * Python ints (the port's `step` and `opt.step`) are 0-d int32 arrays
    and come back as ints;
  * bfloat16 tensors are the raw 2-byte payload: `'<V2'` in the .npy
    header, "bfloat16" in the manifest (what `np.save` writes for an
    ml_dtypes array). They are read back by viewing the bytes as 16-bit
    integers and then as `torch.bfloat16`; nothing here needs ml_dtypes.

Restore validates every leaf (present, loadable, shape and dtype as the
manifest says, crc32); a step that fails is quarantined to
`step_XXXXXXXX.bad` and, when no step was named, the previous one is
tried (`restore_fallbacks`, `quarantined`). Restored leaves are copied
into the live tensors of the tree they restore into, one leaf at a time,
so a full second state never sits on the card.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import signal
import sys
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T

PyTree = Any
BF16 = "bfloat16"
READERS = 4         # leaf files a restore reads and checks at a time


class CheckpointIntegrityError(ValueError):
    """A checkpoint step failed restore-time validation (missing, torn,
    or bit-flipped leaf files; missing/unreadable manifest). The manager
    quarantines the offending step before raising, so a retry against
    `latest_step()` lands on the previous (last-good) step."""

    def __init__(self, step: int, problems: List[str]):
        super().__init__(
            f"checkpoint step {step} failed integrity validation: "
            + "; ".join(problems))
        self.step = step
        self.problems = list(problems)


class HostLeaf:
    """One leaf as it goes to disk: a C-contiguous numpy array and the
    dtype name the manifest records (bfloat16 travels as uint16 bits)."""

    def __init__(self, arr: np.ndarray, dtype: str):
        self.arr = arr
        self.dtype = dtype

    @property
    def shape(self) -> tuple:
        return tuple(self.arr.shape)


def to_host(leaf) -> HostLeaf:
    """A leaf as its own host copy: a tensor (any device) is copied, an
    int becomes a 0-d int32 array, an array is copied (an ml_dtypes
    bfloat16 array then saves as the reference's bytes)."""
    if isinstance(leaf, HostLeaf):
        return leaf
    if isinstance(leaf, torch.Tensor):
        return host_leaf(leaf.detach().to("cpu", copy=True).contiguous())
    arr = np.array(leaf, dtype=np.int32 if isinstance(leaf, int) else None,
                   copy=True, order="C")
    return HostLeaf(arr, str(arr.dtype))


def host_leaf(t: torch.Tensor) -> HostLeaf:
    """A contiguous host tensor as a HostLeaf, sharing its memory."""
    if t.dtype == torch.bfloat16:
        return HostLeaf(t.view(torch.int16).numpy().view(np.uint16), BF16)
    return HostLeaf(t.numpy(), str(t.numpy().dtype))


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)) \
        & 0xFFFFFFFF


def _write_npy(path: Path, leaf: HostLeaf) -> None:
    """`np.save`'s bytes; a bfloat16 leaf gets the header ml_dtypes'
    arrays get (descr '<V2')."""
    if leaf.dtype != BF16:
        np.save(path, leaf.arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": leaf.shape})
        leaf.arr.tofile(f)


def _stored_dtype(arr: np.ndarray, want: str) -> str:
    """The dtype name of a loaded array: two raw bytes under a manifest
    that says bfloat16 are bfloat16."""
    if want == BF16 and arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return BF16
    return str(arr.dtype)


def to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded leaf as a CPU tensor of the dtype the manifest records."""
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _leaf_files(n: int) -> List[str]:
    return [f"leaf-{i:05d}.npy" for i in range(n)]


def _leaf_paths(tree: PyTree) -> List[str]:
    return [T.keystr(p) for p, _ in T.flatten_with_path(tree)[0]]


def _into(live, arr: np.ndarray, dtype: str):
    """Restore one leaf into the live one: a tensor in place (`copy_`:
    onto its device, in its dtype), an int counter from a 0-d array."""
    if isinstance(live, torch.Tensor):
        with torch.no_grad():
            live.copy_(to_tensor(arr, dtype))
        return live
    return int(arr)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = Path(root)
        self.keep = keep
        self.root.mkdir(parents=True, exist_ok=True)
        self._in_save = False
        self._pending_sigterm = False
        # resilience counters (surfaced in run_metadata())
        self.restore_fallbacks = 0
        self.quarantined: List[Dict[str, Any]] = []
        # seconds and bytes of the last write and the last restore's
        # phases (load_s: np.load, crc_s: checksums, copy_s: into the
        # live tensors); snapshot_s is the async manager's host copy
        self.timings: Dict[str, float] = {}

    # ------------------------------------------------------------- save
    def save(self, step: int, state: PyTree) -> Path:
        self._in_save = True
        try:
            name = f"step_{step:08d}"
            tmp = self.root / (name + ".tmp")
            final = self.root / name
            if final.exists():
                return final
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            t0 = time.perf_counter()
            nbytes = 0
            leaves = T.leaves(state)
            paths = _leaf_paths(state)
            meta = {"step": step, "n_leaves": len(leaves),
                    "time": time.time(), "leaves": []}
            for leaf, fname, lpath in zip(leaves, _leaf_files(len(leaves)),
                                          paths):
                h = to_host(leaf)
                _write_npy(tmp / fname, h)
                nbytes += h.arr.nbytes
                meta["leaves"].append({"file": fname, "path": lpath,
                                       "shape": list(h.shape),
                                       "dtype": h.dtype,
                                       "crc32": _crc(h.arr)})
            (tmp / "manifest.json").write_text(json.dumps(meta))
            os.rename(tmp, final)
            self.timings.update(write_s=time.perf_counter() - t0,
                                write_bytes=nbytes)
            self._gc()
            return final
        finally:
            self._in_save = False
            if self._pending_sigterm and sys.exc_info()[0] is None:
                # SIGTERM arrived mid-save and the save succeeded: the
                # step is durable, exit as a clean preemption
                self._pending_sigterm = False
                raise SystemExit(143)

    def _gc(self):
        # the base listing: the async subclass turns all_steps into a
        # writer barrier, and _gc runs ON the writer thread
        steps = CheckpointManager.all_steps(self)
        for s in steps[:-self.keep]:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)
        bad = sorted(p.name for p in self.root.iterdir()
                     if re.fullmatch(r"step_\d+\.bad", p.name))
        for name in bad[:-self.keep] if self.keep else bad:
            shutil.rmtree(self.root / name, ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for p in self.root.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------ integrity / quarantine
    def _load_step(self, step: int, keep=None
                   ) -> Tuple[Dict, Dict[str, np.ndarray]]:
        """Read and verify every leaf file the manifest names: present,
        loadable (torn writes fail here), shape and dtype as the manifest
        says, crc32 (absent in pre-integrity checkpoints — tolerated).
        Returns (manifest, {file: array}) holding the files that
        `keep(manifest)` names (all when keep is None); raises
        CheckpointIntegrityError listing EVERY problem found."""
        d = self.root / f"step_{step:08d}"
        mf = d / "manifest.json"
        if not mf.exists():
            raise CheckpointIntegrityError(
                step, [f"missing manifest.json under {d}"])
        try:
            meta = json.loads(mf.read_text())
        except (json.JSONDecodeError, OSError) as e:
            raise CheckpointIntegrityError(
                step, [f"unreadable manifest.json: {e}"])
        kept = None if keep is None else keep(meta)

        def read(entry):
            """One leaf file: (file, its array if kept and sound, the
            problem found or None, load s, crc s)."""
            fname = entry["file"]
            lpath = entry.get("path", "?")
            f = d / fname
            if not f.exists():
                return fname, None, f"missing leaf {fname} ({lpath})", 0, 0
            t0 = time.perf_counter()
            try:
                arr = np.load(f)
            except Exception as e:  # torn write: bad .npy header/payload
                return (fname, None, f"unreadable leaf {fname} ({lpath}): "
                        f"{type(e).__name__}", time.perf_counter() - t0, 0)
            load = time.perf_counter() - t0
            stored = _stored_dtype(arr, entry["dtype"])
            if (list(arr.shape) != list(entry["shape"])
                    or stored != entry["dtype"]):
                return (fname, None,
                        f"leaf {fname} ({lpath}): stored "
                        f"{stored}{list(arr.shape)} != manifest "
                        f"{entry['dtype']}{entry['shape']}", load, 0)
            crc = entry.get("crc32")
            t0 = time.perf_counter()
            ok = crc is None or _crc(arr) == crc
            crc_s = time.perf_counter() - t0
            if not ok:
                return (fname, None,
                        f"checksum mismatch in {fname} ({lpath})", load,
                        crc_s)
            return (fname, arr if kept is None or fname in kept else None,
                    None, load, crc_s)

        # READERS leaves at a time (np.load's reads and crc32 leave the
        # GIL); load_s and crc_s sum each leaf's own seconds
        entries = meta.get("leaves", [])
        with ThreadPoolExecutor(max_workers=READERS) as pool:
            got = list(pool.map(read, entries))
        problems, arrays = [], {}
        load_s = crc_s = 0.0
        for fname, arr, problem, load, crc in got:
            load_s += load
            crc_s += crc
            if problem is not None:
                problems.append(problem)
            elif arr is not None:
                arrays[fname] = arr
        self.timings.update(load_s=load_s, crc_s=crc_s)
        if problems:
            raise CheckpointIntegrityError(step, problems)
        return meta, arrays

    def validate_step(self, step: int) -> List[str]:
        """Integrity problems for `step` ([] = valid)."""
        try:
            self._load_step(step, keep=lambda meta: ())
        except CheckpointIntegrityError as e:
            return e.problems
        return []

    def quarantine(self, step: int, problems: List[str]) -> None:
        """Rename the step dir to `step_XXXXXXXX.bad` — a name
        `all_steps()` never matches — so later restores fall through to
        the previous step. The dir is kept for post-mortem inspection
        until _gc trims old .bad dirs."""
        d = self.root / f"step_{step:08d}"
        bad = self.root / f"step_{step:08d}.bad"
        if d.exists():
            if bad.exists():
                shutil.rmtree(bad, ignore_errors=True)
            os.rename(d, bad)
        self.quarantined.append({"step": step, "problems": list(problems)})
        print(f"[ckpt] quarantined step {step} -> {bad.name}: "
              + "; ".join(problems))

    def _resolve_verified(self, step: Optional[int], keep=None):
        """(step, manifest, arrays) for an explicitly requested `step`
        (quarantine + raise if invalid), or — when step is None — the
        NEWEST step that passes validation, quarantining invalid ones on
        the way down and counting each skip as a restore fallback."""
        if step is not None:
            try:
                meta, arrays = self._load_step(step, keep)
            except CheckpointIntegrityError as e:
                self.quarantine(step, e.problems)
                raise
            return step, meta, arrays
        steps = self.all_steps()
        if not steps:
            raise ValueError(f"no checkpoints under {self.root}")
        for s in reversed(steps):
            try:
                meta, arrays = self._load_step(s, keep)
            except CheckpointIntegrityError as e:
                self.quarantine(s, e.problems)
                self.restore_fallbacks += 1
                print(f"[ckpt] falling back past corrupt step {s} "
                      f"to last good")
                continue
            return s, meta, arrays
        raise ValueError(
            f"no valid checkpoints under {self.root}: every step failed "
            f"integrity validation (all quarantined)")

    def restore(self, like: PyTree, step: Optional[int] = None,
                rows: Optional[Dict[str, Tuple[int, int]]] = None) -> PyTree:
        """Restore into the structure — and the live tensors — of `like`:
        each tensor leaf is overwritten in place (its device and dtype
        kept), ints come back as ints. Shapes may differ on the lane axis
        (see reshard_lanes). `rows` maps a manifest path to (lane, span)
        for a leaf this process holds one lane of (a rank's own lane of
        [span, ...] optimizer state or pending carry): the stored [old
        span, ...] leaf is resharded to [span, ...] first, then the
        process takes row `lane` — so a span change folds or repeats the
        lanes as the full leaf does. A callable instead takes the stored
        array and its manifest dtype to the array this process holds (a
        rank's shard of the full leaf). Every leaf is validated first;
        with step=None a corrupt newest step is quarantined and the
        previous one restored."""
        step, meta, arrays = self._resolve_verified(step)
        leaves, treedef = T.flatten(like)
        files = _leaf_files(len(leaves))
        if meta.get("n_leaves", len(leaves)) != len(leaves):
            raise ValueError(
                f"checkpoint step {step} holds {meta['n_leaves']} leaves "
                f"but the restore template has {len(leaves)} — saved from "
                f"a different model/optimizer structure?")
        missing = [f for f in files if f not in arrays]
        if missing:
            raise ValueError(
                f"checkpoint step {step} is missing {len(missing)} leaf "
                f"file(s): {', '.join(missing[:5])}"
                + ("..." if len(missing) > 5 else ""))
        dtypes = {e["file"]: e["dtype"] for e in meta["leaves"]}
        rows = rows or {}
        t0 = time.perf_counter()
        out = []
        for leaf, fname, lpath in zip(leaves, files, _leaf_paths(like)):
            arr = arrays.pop(fname)
            want = tuple(np.shape(leaf))
            if lpath in rows:
                how = rows[lpath]
                arr = how(arr, dtypes[fname]) if callable(how) else \
                    lane_row(arr, *how, want, dtypes[fname])
            elif tuple(arr.shape) != want:
                arr = _reshard(arr, want, dtypes[fname])
            out.append(_into(leaf, arr, dtypes[fname]))
            del arr
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.timings["copy_s"] = time.perf_counter() - t0
        return T.unflatten(treedef, out)

    def restore_params(self, template: PyTree, step: Optional[int] = None,
                       device=None) -> PyTree:
        """Params-only restore from a full train-state checkpoint: the
        leaves under the "params" subtree, addressed by manifest *path*
        (not flatten position), in the structure of `template` (a params
        tree; its leaves need only a shape — meta tensors do). Returns
        new tensors on `device` (default: each template leaf's) in the
        dtype the checkpoint stored. Same integrity contract as
        `restore`."""
        paths = ["['params']" + T.keystr(p)
                 for p, _ in T.flatten_with_path(template)[0]]
        step, meta, arrays = self._resolve_verified(
            step, keep=lambda meta: {l["file"] for l in meta["leaves"]
                                     if l.get("path", "").startswith(
                                         "['params']")})
        by_path = {l["path"]: l for l in meta["leaves"] if "path" in l}
        if not by_path:
            raise ValueError(
                f"checkpoint step {step} predates path-indexed manifests; "
                f"re-save the checkpoint (or restore the full state and "
                f"take state['params'])")
        missing = [k for k in paths if k not in by_path]
        if missing:
            raise ValueError(
                f"checkpoint step {step} is missing {len(missing)} params "
                f"leaf/leaves: {', '.join(missing[:5])}"
                + ("..." if len(missing) > 5 else "")
                + "; was it saved from a compatible model?")
        flat, treedef = T.flatten(template)
        out = []
        for key, leaf in zip(paths, flat):
            entry = by_path[key]
            arr = arrays.pop(entry["file"])
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"model shape {tuple(leaf.shape)}")
            dev = device if device is not None else leaf.device
            out.append(to_tensor(arr, entry["dtype"]).to(dev))
            del arr
        return T.unflatten(treedef, out)

    # ------------------------------------------------- SIGTERM handling
    def install_preemption_handler(self, save_fn):
        """Preemption-safe: on SIGTERM finish/do one save, then exit."""
        def handler(signum, frame):
            if self._in_save:
                self._pending_sigterm = True
                return
            save_fn()
            raise SystemExit(143)
        signal.signal(signal.SIGTERM, handler)


class AsyncCheckpointManager(CheckpointManager):
    """Overlapped checkpointing: the device->host snapshot happens in the
    caller's thread (it must — the train step updates the state in
    place, so the next step changes the tensors), serialization + file
    I/O run on a background writer thread, so the step loop resumes
    after the snapshot instead of after the write.

    Barriers (the only places the loop may block on the writer):
      * a new `save` overlapping an in-flight one waits for the previous
        write first (at most one checkpoint in flight);
      * `restore` / `restore_params` / `all_steps` / `latest_step` /
        `validate_step` / `close` wait for pending writes, so readers
        never miss the checkpoint they just scheduled.
    Writer-thread exceptions surface at the next barrier, never silently.
    """

    def __init__(self, root: str, keep: int = 3):
        super().__init__(root, keep)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="repro-ckpt")
        self._future = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state: PyTree) -> Path:
        self.wait()
        final = self.root / f"step_{step:08d}"
        if final.exists():
            return final
        # a real host copy of every leaf, after the card has finished the
        # step that wrote it (`to_host` copies; a later in-place step
        # cannot change what is written)
        t0 = time.perf_counter()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        host_state = T.map(to_host, state)
        self.timings["snapshot_s"] = time.perf_counter() - t0
        self._future = self._pool.submit(
            CheckpointManager.save, self, step, host_state)
        return final

    def wait(self):
        """Barrier: block until the in-flight write (if any) completes,
        re-raising any writer-thread failure."""
        if threading.current_thread().name.startswith("repro-ckpt"):
            return   # reentrant barrier from the writer itself: vacuous
        fut, self._future = self._future, None
        if fut is not None:
            fut.result()

    @property
    def in_flight(self) -> bool:
        return self._future is not None and not self._future.done()

    # ---------------------------------------------------------- readers
    def all_steps(self):
        self.wait()
        return super().all_steps()

    def restore(self, like: PyTree, step=None, rows=None) -> PyTree:
        self.wait()
        return super().restore(like, step, rows)

    def restore_params(self, template, step=None, device=None) -> PyTree:
        self.wait()
        return super().restore_params(template, step, device)

    def validate_step(self, step: int) -> List[str]:
        self.wait()
        return super().validate_step(step)

    def close(self):
        self.wait()
        self._pool.shutdown(wait=True)

    # --------------------------------------------------------- preemption
    def install_preemption_handler(self, save_fn):
        """SIGTERM: drain the in-flight background write, then one final
        save + exit. (The base class's `_in_save` deferral would span the
        entire background write here and drop the signal — `_in_save` is
        set by the WRITER thread, not the caller.)"""
        def handler(signum, frame):
            self.wait()
            save_fn()      # session.save_sync: snapshot + barrier
            raise SystemExit(143)
        signal.signal(signal.SIGTERM, handler)


def _reshard(arr: np.ndarray, want: tuple, dtype: str) -> np.ndarray:
    """`reshard_lanes` in the manifest's dtype: bfloat16 leaves (raw
    16-bit payloads here) are folded as values, in fp32, then rounded
    back to bfloat16 bits."""
    if tuple(arr.shape) == tuple(want) or dtype != BF16:
        return reshard_lanes(arr, want)
    vals = to_tensor(arr, BF16).float().numpy()
    out = torch.from_numpy(np.ascontiguousarray(reshard_lanes(vals, want)))
    return host_leaf(out.to(torch.bfloat16)).arr


def lane_row(arr: np.ndarray, lane: int, span: int, want: tuple,
             dtype: str) -> np.ndarray:
    """Row `lane` of a stored [old span, *want] lane leaf resharded to
    `span` lanes."""
    return _reshard(arr, (span,) + tuple(want), dtype)[lane]


def reshard_lanes(arr: np.ndarray, want: tuple) -> np.ndarray:
    """Elastic lane-axis resharding: fold (mean) or repeat the leading
    lane axis of per-lane optimizer state when the Adasum span changes."""
    if len(arr.shape) == len(want) and arr.shape[1:] == tuple(want[1:]):
        old, new = arr.shape[0], want[0]
        if old == new:
            return arr
        if old % new == 0:       # shrink: average lane groups
            return arr.reshape(new, old // new, *arr.shape[1:]).mean(axis=1)
        if new % old == 0:       # grow: replicate lanes
            return np.repeat(arr, new // old, axis=0)
    raise ValueError(f"cannot reshard {arr.shape} -> {want}")
