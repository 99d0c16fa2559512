"""Fault-tolerant checkpointing in the reference's on-disk layout — port of
``repro/checkpoint/manager.py``.

Layout:  <dir>/step_<N>/
            meta.json        step, wall time, the keys, caller's extras
            <key>.npy        one file per leaf, the path's keys joined
                             with '::' (a list index as '#i')
         <dir>/step_<N>.tmp/ an in-flight write (never resumed from)

The commit protocol, retention and async save are the reference's: write
to step_N.tmp, fsync meta.json, rename to step_N; resume takes the largest
step with a meta.json.  bf16 and f16 leaves are stored as float32 and cast
back on restore.  Either package reads what the other wrote, given trees
of the same keys: the port writes the pattern's layers stacked, as the
reference keeps them (``train.step.TrainState.to_tree``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util

SEP = "::"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> List[Tuple[str, object]]:
    return [(tree_util.key_of(path, SEP), leaf)
            for path, leaf in tree_util.flatten(tree)]


def _cast_like(arr: np.ndarray, like):
    """A loaded array as the type of the leaf it restores."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=like.device, dtype=like.dtype)
    if isinstance(like, np.generic):
        return like.dtype.type(arr)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    if isinstance(like, bool):
        return bool(arr)
    if isinstance(like, int):
        return int(arr)
    if isinstance(like, float):
        return float(arr)
    return arr


def _unflatten_like(like, values: dict, path: tuple = ()):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, values, path + (k,))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, values, path + (i,))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return values[tree_util.key_of(path, SEP)]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra_meta: Optional[dict] = None,
             block: bool = False) -> None:
        """Snapshot ``tree`` at ``step``.  Leaves are copied to the host
        here (a consistent cut); the files are written on a background
        thread unless async_save is off or ``block`` is set."""
        leaves = [(k, _to_numpy(v)) for k, v in _flatten(tree)]
        meta = {"step": int(step), "time": time.time(),
                "keys": [k for k, _ in leaves]}
        if extra_meta:
            meta.update(extra_meta)
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, leaves, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, leaves, meta)

    def _write(self, step: int, leaves, meta) -> None:
        final = os.path.join(self.directory, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for key, arr in leaves:
            np.save(os.path.join(tmp, key.replace("/", "_") + ".npy"), arr)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic commit
        self._retain()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "meta.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metadata(self, step: int) -> dict:
        with open(os.path.join(self.directory, f"step_{step}",
                               "meta.json")) as f:
            return json.load(f)

    def restore(self, step: int, like_tree):
        """A tree of ``like_tree``'s structure read from ``step``: each leaf
        cast to the type, dtype and device of the leaf it replaces."""
        d = os.path.join(self.directory, f"step_{step}")
        values = {}
        for key, leaf in _flatten(like_tree):
            arr = np.load(os.path.join(d, key.replace("/", "_") + ".npy"))
            values[key] = _cast_like(arr, leaf)
        return _unflatten_like(like_tree, values)

    def restore_latest(self, like_tree):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like_tree)
