"""Crash-safe checkpoints of the train state (the counterpart of the JAX
package's orbax ``training/checkpoint.py``, in a plain torch format).

Layout: one directory per step, ``<dir>/<step>/``, holding

- ``tensors.bin``: every tensor of the state, raw bytes back to back;
- ``manifest.json``: each tensor's name (its path in the state: dict
  keys, list indices and dataclass fields joined by ``/``), dtype, shape
  and byte range, the state's plain values (ints, floats, None) by name,
  and caller metadata (the launcher's data position);
- ``_CHECKPOINT_METADATA``: the commit marker, written last.

A save writes the first two under a temporary name, fsyncs them, renames
the directory to its step and fsyncs the parent, then writes and fsyncs
the marker.  A directory without its marker, or whose manifest or tensor
bytes are short, is a torn save: ``restore`` moves it to
``<dir>/corrupt/<step>`` and falls back to the newest step that restores
(the JAX ``_quarantine`` contract, logged as "restored checkpoint step
N").  An explicit ``step=`` that is torn fails hard; when every retained
step fails with its marker intact, the failure is systemic (a changed
config, an unreadable disk): it raises and quarantines nothing.

``restore`` checks every name, dtype, shape and byte range against the
template before it writes anything (the train state's ``model_state``,
BatchNorm's running statistics, as strictly as its params: a checkpoint
without them is refused, never half-restored), then copies each tensor into the
template's own tensor (so it lands on the trainer's device and the
model's parameters stay bound); plain values come back from the
manifest.  Saves are synchronous: copying a CUDA tensor to the host
waits for the device, so the bytes written are those of the finished
step.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from tensorflow_train_distributed_torch.runtime import faults

logger = logging.getLogger(__name__)

COMMIT_MARKER = "_CHECKPOINT_METADATA"
QUARANTINE_DIR = "corrupt"
MANIFEST = "manifest.json"
TENSORS = "tensors.bin"
FORMAT = 1

# Stored dtype name -> (torch dtype, numpy dtype the bytes are read as).
_DTYPES = {
    "float64": (torch.float64, np.float64),
    "float32": (torch.float32, np.float32),
    "bfloat16": (torch.bfloat16, np.int16),
    "float16": (torch.float16, np.float16),
    "int64": (torch.int64, np.int64),
    "int32": (torch.int32, np.int32),
    "int16": (torch.int16, np.int16),
    "int8": (torch.int8, np.int8),
    "uint8": (torch.uint8, np.uint8),
    "bool": (torch.bool, np.bool_),
}
_TORCH_NAMES = {t: name for name, (t, _) in _DTYPES.items()}


def _is_leaf_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def _children(node):
    """(key, child) pairs of a container node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def flatten(tree, prefix: str = "") -> tuple:
    """``(arrays, values)``: ``{name: tensor or ndarray}`` and ``{name:
    plain value}`` of a nested state."""
    arrays, values = {}, {}

    def rec(node, path):
        if _is_leaf_array(node):
            arrays[path] = node
            return
        kids = _children(node)
        if kids is None:
            if not (node is None or isinstance(node, (bool, int, float,
                                                      str))):
                raise TypeError(f"{path}: cannot checkpoint a "
                                f"{type(node).__name__}")
            values[path] = node
            return
        for k, v in kids:
            rec(v, f"{path}/{k}" if path else k)

    rec(tree, prefix)
    return arrays, values


def _host_bytes(x) -> tuple:
    """(dtype name, shape, C-contiguous host ndarray of the bytes)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        name = _TORCH_NAMES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, list(x.shape), t.numpy()
    a = np.require(np.asarray(x), requirements="C")
    name = a.dtype.name
    if name not in _DTYPES:
        raise TypeError(f"cannot checkpoint a {name} array")
    return name, list(a.shape), a


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_synced(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


class CheckpointManager:
    """Keep-N synchronous checkpointing of a nested state (a
    ``TrainState``, or any tree of dicts, lists, dataclasses, tensors,
    arrays and plain values)."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        # Temporary directories of a writer that died before its rename
        # were never a checkpoint.
        for name in os.listdir(self.directory):
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
        self.last_save: Optional[dict] = None
        self.last_restore: Optional[dict] = None
        self.restored_meta: Optional[dict] = None

    # -- bookkeeping -----------------------------------------------------

    def all_steps(self) -> list:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _quarantine(self, step: int) -> str:
        """Move a bad step directory to ``<dir>/corrupt/<step>``, keeping
        the evidence."""
        qroot = os.path.join(self.directory, QUARANTINE_DIR)
        os.makedirs(qroot, exist_ok=True)
        dst = os.path.join(qroot, str(step))
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = os.path.join(qroot, f"{step}.{n}")
        shutil.move(self._step_dir(step), dst)
        return dst

    # -- save ------------------------------------------------------------

    def save(self, step: int, state: Any, *,
             meta: Optional[dict] = None) -> bool:
        """Write ``state`` as step ``step``; False when that step exists."""
        if step in self.all_steps():
            return False
        t0 = time.perf_counter()
        arrays, values = flatten(state)
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        entries, offset = {}, 0
        with open(os.path.join(tmp, TENSORS), "wb") as f:
            for name, x in arrays.items():
                dtype, shape, host = _host_bytes(x)
                nbytes = host.nbytes
                f.write(host.data if host.ndim else host.tobytes())
                entries[name] = {"dtype": dtype, "shape": shape,
                                 "offset": offset, "nbytes": nbytes}
                offset += nbytes
            f.flush()
            os.fsync(f.fileno())
        manifest = {"format": FORMAT, "step": int(step), "tensors": entries,
                    "values": values, "meta": meta or {}}
        _write_synced(os.path.join(tmp, MANIFEST),
                      json.dumps(manifest).encode())
        _fsync_dir(tmp)
        final = self._step_dir(step)
        os.rename(tmp, final)
        _fsync_dir(self.directory)
        _write_synced(os.path.join(final, COMMIT_MARKER), json.dumps(
            {"step": int(step), "bytes": offset,
             "time": time.time()}).encode())
        _fsync_dir(final)
        self.last_save = {"step": int(step), "bytes": offset,
                          "seconds": time.perf_counter() - t0}
        logger.info("checkpoint saved at step %d (%d bytes, %.3f s)", step,
                    offset, self.last_save["seconds"])
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        if faults.ARMED:
            faults.on_checkpoint_save(step, final)
        return True

    # -- restore ---------------------------------------------------------

    def _read(self, step: int) -> tuple:
        """(manifest, tensor bytes) of a committed step, validated: a
        missing marker, an unreadable manifest or short tensor bytes
        raise."""
        d = self._step_dir(step)
        if not os.path.exists(os.path.join(d, COMMIT_MARKER)):
            raise ValueError(
                f"checkpoint step {step} has no {COMMIT_MARKER} commit "
                "marker (torn save)")
        with open(os.path.join(d, MANIFEST), "rb") as f:
            manifest = json.loads(f.read())
        if manifest.get("format") != FORMAT:
            raise ValueError(f"checkpoint step {step}: format "
                             f"{manifest.get('format')!r}, expected "
                             f"{FORMAT}")
        blob = np.fromfile(os.path.join(d, TENSORS), dtype=np.uint8)
        for name, e in manifest["tensors"].items():
            if e["offset"] + e["nbytes"] > blob.size:
                raise ValueError(
                    f"checkpoint step {step}: tensor {name} is short "
                    f"({blob.size} bytes on disk, needs "
                    f"{e['offset'] + e['nbytes']})")
        return manifest, blob

    @staticmethod
    def _tensor(manifest, blob, name) -> torch.Tensor:
        e = manifest["tensors"][name]
        tdt, ndt = _DTYPES[e["dtype"]]
        raw = blob[e["offset"]:e["offset"] + e["nbytes"]].view(ndt)
        t = torch.from_numpy(raw.reshape(e["shape"]))
        return t.view(tdt) if tdt == torch.bfloat16 else t

    def _restore_into(self, step: int, template: Any):
        manifest, blob = self._read(step)
        arrays, values = flatten(template)
        saved, saved_values = manifest["tensors"], manifest["values"]
        missing = sorted(set(arrays) - set(saved))
        extra = sorted(set(saved) - set(arrays))
        lacking = [n for n in missing if n.startswith("model_state/")]
        if lacking:
            raise ValueError(
                f"checkpoint step {step} has no model state for "
                f"{len(lacking)} buffers the model keeps (e.g. "
                f"{lacking[0]}: BatchNorm running statistics); refusing a "
                f"restore that would leave them at their initial values")
        if missing or extra or set(values) != set(saved_values):
            raise ValueError(
                f"checkpoint step {step} does not match the state: "
                f"missing tensors {missing[:5]}, unexpected {extra[:5]}, "
                f"values {sorted(set(values) ^ set(saved_values))[:5]}")
        for name, x in arrays.items():
            e = saved[name]
            dtype = (_TORCH_NAMES[x.dtype] if isinstance(x, torch.Tensor)
                     else np.asarray(x).dtype.name)
            if list(x.shape) != e["shape"] or dtype != e["dtype"]:
                raise ValueError(
                    f"checkpoint step {step}: {name} is {e['dtype']} "
                    f"{e['shape']}, the state's {dtype} {list(x.shape)}")
        restored = {}
        with torch.no_grad():
            for name, x in arrays.items():
                src = self._tensor(manifest, blob, name)
                if isinstance(x, torch.Tensor):
                    x.copy_(src)
                    restored[name] = x
                else:
                    restored[name] = np.array(src.numpy()).reshape(x.shape)
        self.restored_meta = manifest["meta"]
        return _rebuild(template, {**restored, **saved_values})

    def restore(self, template: Any, step: Optional[int] = None):
        """Restore into ``template`` (a state of the same structure, e.g.
        a fresh ``Trainer.create_state()``); None when no step exists.
        See the module docstring for the fallback and quarantine rules."""
        t0 = time.perf_counter()
        if step is not None:
            out = self._restore_into(step, template)
            self._restored(step, t0)
            return out
        deferred = []        # (step, error): marker-intact failures
        while True:
            skip = {s for s, _ in deferred}
            steps = [s for s in self.all_steps() if s not in skip]
            if not steps:
                if deferred:
                    bad_step, err = deferred[0]
                    logger.error(
                        "no retained checkpoint restores, and step %d "
                        "failed with an INTACT commit marker (%s: %s) — "
                        "refusing to quarantine or fall back to fresh "
                        "init: this looks systemic (changed model "
                        "config, unreadable mount), not per-step "
                        "corruption", bad_step, type(err).__name__, err)
                    raise err
                return None
            step = max(steps)
            if not os.path.exists(os.path.join(self._step_dir(step),
                                               COMMIT_MARKER)):
                dst = self._quarantine(step)
                logger.error(
                    "checkpoint step %d has no %s commit marker (torn "
                    "save); quarantined to %s and falling back to the "
                    "previous retained step", step, COMMIT_MARKER, dst)
                continue
            try:
                out = self._restore_into(step, template)
            except Exception as e:      # noqa: BLE001 — any torn read
                deferred.append((step, e))
                logger.error(
                    "checkpoint step %d failed to restore (%s: %s); "
                    "trying the previous retained step", step,
                    type(e).__name__, e)
                continue
            for bad_step, err in deferred:
                dst = self._quarantine(bad_step)
                logger.error(
                    "checkpoint step %d failed to restore (%s: %s) while "
                    "step %d restored cleanly — per-step corruption; "
                    "quarantined to %s", bad_step, type(err).__name__, err,
                    step, dst)
            self._restored(step, t0)
            return out

    def _restored(self, step: int, t0: float) -> None:
        d = self._step_dir(step)
        self.last_restore = {
            "step": step, "seconds": time.perf_counter() - t0,
            "bytes": os.path.getsize(os.path.join(d, TENSORS))}
        logger.info("restored checkpoint step %d", step)

    def restore_params(self, step: Optional[int] = None
                       ) -> Optional[dict]:
        """The ``params`` subtree as host tensors ``{name: tensor}``,
        with no template (for tools that need only the weights); None
        when no checkpoint exists."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        manifest, blob = self._read(step)
        return {name[len("params/"):]: self._tensor(manifest, blob,
                                                    name).clone()
                for name in manifest["tensors"]
                if name.startswith("params/")}


def _rebuild(template, leaves: dict, path: str = ""):
    """``template`` with each leaf replaced by ``leaves[path]``."""
    if _is_leaf_array(template) or _children(template) is None:
        return leaves[path]

    def key(k):
        return f"{path}/{k}" if path else str(k)

    if isinstance(template, dict):
        return type(template)((k, _rebuild(v, leaves, key(k)))
                              for k, v in template.items())
    if isinstance(template, (list, tuple)):
        items = [_rebuild(v, leaves, key(i))
                 for i, v in enumerate(template)]
        if hasattr(template, "_fields"):
            return type(template)(*items)
        return type(template)(items)
    return dataclasses.replace(template, **{
        f.name: _rebuild(getattr(template, f.name), leaves, key(f.name))
        for f in dataclasses.fields(template) if f.init})
