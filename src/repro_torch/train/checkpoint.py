"""Atomic, async-capable checkpointing, counterpart of
``repro.train.checkpoint`` — with the same on-disk format, so a
checkpoint written by either package restores in the other:

* ``step_<n>/`` holds one ``.npy`` file per leaf and ``manifest.json``
  (``step``, ``extra``, ``time``, and per leaf its file, shape and
  dtype), keyed by the reference's pytree path strings
  (``['params']['embed']['table']``) in sorted-key order;
* bfloat16 leaves are stored as their raw ``uint16`` bits with the
  logical dtype in the manifest;
* a checkpoint is written to ``step_<n>.tmp`` and renamed into place
  when complete; the newest ``keep`` are kept.

``save_async`` copies the tree to host memory synchronously and writes
it on a background thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.common.bridge import from_jax_tree


def _flatten(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path string, leaf) pairs in the reference's flatten order (dict
    keys sorted) and ``jax.tree_util.keystr`` spelling."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}[{k!r}]"))
        return out
    return [(prefix, tree)]


def _key_to_fname(key: str) -> str:
    return key.replace("/", "_").replace("'", "").replace("[", "(").replace(
        "]", ")") + ".npy"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- write ----------------------------------------------------------
    def save(self, step: int, tree, extra: dict | None = None):
        self.wait()
        self._write(step, self._snapshot(tree), extra or {})

    def save_async(self, step: int, tree, extra: dict | None = None):
        self.wait()
        snap = self._snapshot(tree)           # sync device -> host copy
        self._thread = threading.Thread(
            target=self._write, args=(step, snap, extra or {}), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _snapshot(self, tree):
        return [(k, _to_numpy(v), str(v.dtype).removeprefix("torch."))
                for k, v in _flatten(tree)]

    def _write(self, step: int, snap, extra: dict):
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "time": time.time(),
                    "leaves": {}}
        for key, arr, dtype_name in snap:
            fname = _key_to_fname(key)
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {"file": fname,
                                       "shape": list(arr.shape),
                                       "dtype": dtype_name}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                 # atomicity boundary
        self._prune()

    def _prune(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- read -----------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like_tree):
        """Restore into the structure of ``like_tree`` (a nested dict of
        tensors): each leaf comes back with the dtype and on the device
        of its counterpart there.  Returns (tree, extra, step)."""
        path = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = {}
        for key, like in _flatten(like_tree):
            entry = manifest["leaves"].get(key)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = np.load(os.path.join(path, entry["file"]))
            if entry["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = from_jax_tree(arr, device="cpu")
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {tuple(t.shape)} vs "
                    f"model {tuple(like.shape)}")
            leaves[key] = t.to(device=like.device, dtype=like.dtype)

        def build(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: build(tree[k], f"{prefix}[{k!r}]")
                        for k in tree}
            return leaves[prefix]
        return build(like_tree), manifest["extra"], manifest["step"]
