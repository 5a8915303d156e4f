"""Step-atomic, resumable checkpointing.

The counterpart of the JAX package's ``train/checkpoint.py``, with its
layout and commit protocol (one directory per step; a checkpoint without
COMMIT is ignored, so a crash mid-save can never corrupt restart):

    <dir>/step_000120/
        arrays/<flat-param-name>.npy     (host copies)
        manifest.json                    (tree structure, shapes, dtypes,
                                          sha1 of each array's first MiB)
        data_state.json                  (data-pipeline cursor)
        COMMIT

The state is copied to the host before ``save`` returns, and written on a
background thread (async checkpointing overlaps training).  numpy has no
bfloat16, and the port needs no package that adds one: a bf16 tensor is
stored as its ``uint16`` bit pattern, its dtype named in the manifest, and
restored bit for bit.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from ..device import resolve_device


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    out[prefix.rstrip("/")] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor's host copy as numpy, and its dtype's name."""
    t = t.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _head_sha1(arr: np.ndarray) -> str:
    return hashlib.sha1(
        np.ascontiguousarray(arr).tobytes()[:1 << 20]).hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state: dict, data_state: dict | None = None,
             blocking: bool = False) -> None:
        # snapshot to host BEFORE handing to the writer thread
        flat = {name: _to_host(t) for name, t in _flatten(state).items()}
        if self._thread is not None:
            self._thread.join()

        def _write():
            path = os.path.join(self.directory, f"step_{step:09d}")
            tmp = path + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
            manifest = {"step": step, "arrays": {}}
            for name, (arr, dtype) in flat.items():
                fn = name.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, "arrays", fn), arr)
                manifest["arrays"][name] = {
                    "file": fn, "shape": list(arr.shape), "dtype": dtype,
                    "sha1": _head_sha1(arr),
                }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if data_state is not None:
                with open(os.path.join(tmp, "data_state.json"), "w") as f:
                    json.dump(data_state, f)
            with open(os.path.join(tmp, "COMMIT"), "w") as f:
                f.write("ok")
            shutil.rmtree(path, ignore_errors=True)
            os.replace(tmp, path)
            self._gc()

        if self.async_save and not blocking:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------
    def committed_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if (name.startswith("step_")
                    and os.path.exists(os.path.join(full, "COMMIT"))):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def restore(self, step: int, device=None):
        """The state saved at ``step`` as torch tensors on ``device`` (None:
        the card), and the data state (or None)."""
        device = resolve_device(device)
        path = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        for name, info in manifest["arrays"].items():
            arr = np.load(os.path.join(path, "arrays", info["file"]))
            if _head_sha1(arr) != info["sha1"]:
                raise IOError(f"checkpoint corruption in {name}")
            if info["dtype"] == "bfloat16":
                # the bit pattern, as uint16 (or as the raw 2-byte void a
                # writer with a numpy bfloat16 leaves)
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            flat[name] = t.to(device)
        data_state = None
        ds_path = os.path.join(path, "data_state.json")
        if os.path.exists(ds_path):
            with open(ds_path) as f:
                data_state = json.load(f)
        return _unflatten(flat), data_state

    def restore_latest(self, device=None):
        steps = self.committed_steps()
        if not steps:
            return None, None, -1
        tree, ds = self.restore(steps[-1], device)
        return tree, ds, steps[-1]

    def _gc(self) -> None:
        steps = self.committed_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
