"""Checkpoints with a best-accuracy pointer and full resume (``edrl_tpu/train/checkpoint.py``).

The JAX package writes its whole ``TrainState`` with orbax; here a
checkpoint is a directory holding one ``torch.save`` file of the model's
``state_dict`` (BatchNorm buffers included), Adam's state, the warmup
scheduler's state and ``step``.  The API is the JAX package's: ``save``,
``save_best`` (and ``best.json``), ``save_latest`` (and ``latest.json``),
``restore``, ``best_info``, ``latest_info`` and ``wait``.

Each save writes a new directory beside its target (``.<name>.v-*``) and
then points ``<name>``, a symbolic link, at it with one ``os.replace``.  A
crash at any moment leaves ``<name>`` pointing at the old checkpoint or at
the new one, never at half of one and never at nothing, as orbax's atomic
rename guarantees; the next save of that name removes what a crash left.
The info files are replaced in one rename too.  Saves run on one
background thread: ``save`` copies the state to the host (the next train
step may then change it on the card) and the thread writes the copy while
training goes on.  At most one write is in flight; ``wait`` drains it,
``save_best`` and ``restore`` wait for it.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import torch

from edrl_tpu_torch.train.trainer import TrainState

_FILE = "state.pt"


def _to_host(obj):
    """A copy of a (nested) state dict with every tensor on the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _snapshot(state: TrainState) -> dict:
    """The host copy of ``state`` that a checkpoint holds."""
    return _to_host({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "step": state.step,
    })


def _write(path: str, snap: dict) -> None:
    """``snap`` into a new directory beside ``path``, then the link ``path``
    moved to it in one rename; the directories it replaced are removed."""
    parent, name = os.path.split(path)
    target = tempfile.mkdtemp(prefix=f".{name}.v-", dir=parent)
    link = target + ".link"
    try:
        torch.save(snap, os.path.join(target, _FILE))
        os.symlink(os.path.basename(target), link)
        os.replace(link, path)
    except BaseException:
        if os.path.lexists(link):
            os.unlink(link)
        shutil.rmtree(target, ignore_errors=True)
        raise
    _remove_stale(parent, name)


def _remove_stale(parent: str, name: str) -> None:
    """Every ``.<name>.v-*`` entry but the one ``<name>`` points at: the
    replaced checkpoint, and whatever a crashed save left."""
    link = os.path.join(parent, name)
    live = os.readlink(link) if os.path.islink(link) else None
    for entry in os.listdir(parent):
        if not entry.startswith(f".{name}.v-") or entry == live:
            continue
        p = os.path.join(parent, entry)
        if os.path.islink(p):
            os.unlink(p)
        else:
            shutil.rmtree(p, ignore_errors=True)


def _write_json(path: str, obj: dict) -> None:
    """``obj`` as JSON at ``path``, replaced in one rename."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, state: TrainState, name: str = "latest") -> str:
        path = self._path(name)
        # One write in flight at most: it bounds host memory at one extra
        # copy of the state, and a write never races another to one path.
        self.wait()
        self._pending = self._pool.submit(_write, path, _snapshot(state))
        return path

    def save_best(self, state: TrainState, epoch: int, accuracy: float) -> str:
        path = self.save(state, "best")
        # best.json only after its directory is in place: resume trusts its
        # accuracy as the watermark to beat.
        self.wait()
        _write_json(self._path("best.json"), {"epoch": epoch, "accuracy": accuracy})
        return path

    def save_latest(self, state: TrainState, epoch: int) -> str:
        """The rolling preemption checkpoint, and an advisory epoch tag.
        Resume derives the completed epochs from the restored ``step``."""
        path = self.save(state, "latest")
        _write_json(self._path("latest.json"), {"epoch": epoch})
        return path

    def latest_info(self) -> Optional[dict]:
        meta = self._path("latest.json")
        if not os.path.exists(meta) or not os.path.isdir(self._path("latest")):
            return None
        with open(meta) as f:
            return json.load(f)

    def best_info(self) -> Optional[dict]:
        meta = self._path("best.json")
        if not os.path.exists(meta):
            return None
        with open(meta) as f:
            return json.load(f)

    def wait(self) -> None:
        """Block until the write in flight, if any, is in place (and raise
        what it raised)."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def restore_model(self, model: torch.nn.Module, name: str = "latest") -> torch.nn.Module:
        """Load the weights of checkpoint ``name`` into ``model`` (from
        ``trainer.make_model`` with the same config) in place, and return it:
        what serving and evaluation need.  The file is mapped, not read, so
        the optimizer's moments stay on the disk."""
        self.wait()
        snap = torch.load(os.path.join(self._path(name), _FILE), map_location="cpu", weights_only=True, mmap=True)
        model.load_state_dict(snap["model"])
        return model

    def restore(self, state: TrainState, name: str = "latest") -> TrainState:
        """Load checkpoint ``name`` into ``state`` (from ``init_state`` with
        the same config) in place, and return it."""
        self.wait()
        # Loaded on the host: the model and the optimizer move each tensor to
        # its parameter's device, and Adam's step counts stay on the host.
        snap = torch.load(os.path.join(self._path(name), _FILE), map_location="cpu", weights_only=True)
        state.model.load_state_dict(snap["model"])
        state.optimizer.load_state_dict(snap["optimizer"])
        state.scheduler.load_state_dict(snap["scheduler"])
        state.step = int(snap["step"])
        return state
