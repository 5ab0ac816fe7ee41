"""Checkpointing with async save.

Port of `repro.train.checkpoint`, with its layout:
``<dir>/step_<N>/manifest.json`` plus ``arrays.npz``, keyed by the
state's tree paths, written to a temporary directory and renamed, the
last `keep` kept.  The train loop pays for the copy to the host; the
write runs on a background thread, and `wait()` joins it.

The state is the port's training state, ``{"params": ParamTree, "opt":
{"m": {...}, "v": {...}, "step": tensor}}``, keyed by its paths with a
`ParamTree`'s dotted names split at the dots: ``params/stack/0/attn/wq``,
``opt/m/stack/0/attn/wq``, ``opt/step``.  `restore(like)` checks every
leaf's shape and writes the stored values into `like`'s tensors, cast to
their dtypes, so the parameters stay the leaves autograd and the
optimizer hold.

With the leaves sharded over the mesh (`models.sharding`, along a dim
over one axis or several) a checkpoint holds the whole tensors, as the
JAX package's global arrays: every rank calls `whole_state` (the sharded
leaves of the parameters and both moments gathered from every rank) and
one rank saves it; each rank restores its block at the same mesh and
layout with ``restore(like, cut=shard_cut(cfg, pctx))``.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.parallel import ParallelContext
from repro_torch.models.sharding import gather_leaf, local_slice


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = (tree.named_parameters() if isinstance(tree, nn.Module)
             else tree.items())
    out = {}
    for name, value in items:
        key = str(name).replace(".", "/")
        out.update(_flatten(value, f"{prefix}/{key}" if prefix else key))
    return out


def _leaf_name(key: str) -> Optional[str]:
    """The parameter a state key holds or shadows ("params/stack/0/moe/
    w_gate", "opt/m/stack/0/moe/w_gate" -> "stack.0.moe.w_gate")."""
    parts = key.split("/")
    if parts[0] == "params":
        return ".".join(parts[1:])
    if parts[:2] in (["opt", "m"], ["opt", "v"]):
        return ".".join(parts[2:])
    return None


def whole_state(state, cfg: ModelConfig, pctx: ParallelContext
                ) -> Dict[str, torch.Tensor]:
    """The state's leaves by key, each sharded leaf of the parameters and
    the moments whole (`models.sharding.gather_leaf`).  Every rank of
    ``pctx.mesh`` calls it, in one order."""
    out = {}
    for key, t in _flatten(state).items():
        name = _leaf_name(key)
        out[key] = t if name is None else gather_leaf(name, t, cfg, pctx)
    return out


def shard_cut(cfg: ModelConfig, pctx: ParallelContext
              ) -> Callable[[str, Tuple[int, ...]], tuple]:
    """`restore`'s `cut`: this rank's block of a whole stored leaf
    (`models.sharding.local_slice`, mamba's in_proj as the rank's x and z
    columns)."""
    def cut(key: str, shape: Tuple[int, ...]) -> tuple:
        name = _leaf_name(key)
        if name is None:
            return tuple(slice(None) for _ in shape)
        return local_slice(name, shape, cfg, pctx)
    return cut


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of `t` (bfloat16 widened to float32, which numpy
    lacks); a copy even of a CPU tensor, which the loop writes on."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---------------- save -------------------------------------------------
    def save(self, step: int, state, extra: Optional[Dict] = None,
             blocking: bool = False):
        self.wait()
        host = {k: _host(v) for k, v in _flatten(state).items()}

        def _write():
            d = self.dir / f"step_{step:08d}"
            tmp = self.dir / f".tmp_step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **host)
            manifest = {
                "step": int(step),
                "keys": sorted(host),
                "shapes": {k: list(v.shape) for k, v in host.items()},
                "extra": extra or {},
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if d.exists():
                shutil.rmtree(d)
            tmp.rename(d)
            self._gc()

        def _background():
            try:
                _write()
            except Exception as e:   # re-raised by wait()
                self._error = e

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_background, daemon=True)
            self._thread.start()

    def wait(self):
        """Join the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------- restore ----------------------------------------------
    def steps(self) -> List[int]:
        return sorted(
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if (p / "manifest.json").exists()
        )

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like, step: Optional[int] = None,
                cut: Optional[Callable] = None):
        """Write checkpoint `step` (the latest by default) into the
        tensors of `like`, a state of the saved structure; returns (like,
        step).  `cut(key, shape)`, where given, picks the block of each
        stored array that `like` holds (`shard_cut`)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        flat = _flatten(like)
        with np.load(d / "arrays.npz") as data:
            arrays = {}
            for k, leaf in flat.items():
                if k not in data.files:
                    raise KeyError(f"checkpoint step {step} has no leaf {k}")
                arr = data[k]
                if cut is not None:
                    arr = np.asarray(arr[cut(k, arr.shape)])
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"checkpoint leaf {k}: shape {arr.shape} != "
                        f"{tuple(leaf.shape)}")
                arrays[k] = arr
        with torch.no_grad():
            for k, leaf in flat.items():
                leaf.copy_(torch.from_numpy(arrays[k]))
        return like, step
