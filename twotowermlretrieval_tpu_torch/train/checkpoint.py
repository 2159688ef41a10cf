"""Checkpoint / resume for params + optimizer state + data-order position.

The port of the JAX package's ``train/checkpoint.py``: every save writes
the whole :class:`TrainState` (trainable and frozen params, Adam moments
and count, step, the dropout generator's state) into
``step_XXXXXXXX/state.pt`` (``torch.save`` of CPU tensors), written to a
temporary directory and renamed into place, plus the data-iterator
position in ``step_XXXXXXXX.position.json``, written atomically, beside
it. The newest ``max_to_keep`` steps are kept. Restore copies the values
into a template state built with the same config, so they land on the
template's device bit for bit.

With a mesh, rank 0 writes, with a barrier of every rank before and
after the rename (no rank saves a state the others have not reached, nor
goes on before the step is in place), and every rank restores. On a model
axis the leaves the mesh's rules split (params and Adam moments) are
first gathered over the model group, so the file holds the whole state in
the one-process format; a restoring rank cuts its own shard from it. The
file holds no mesh shape: a checkpoint restores into any mesh, or one
process, with the same params, moments and data position (the position
counts global batches), bit for bit. The JAX package's Orbax directories are a different format and
are not read (ROADMAP, "Not queued": Orbax checkpoint interchange).
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from twotowermlretrieval_tpu_torch.parallel.distributed import gather_params, shard_slice
from twotowermlretrieval_tpu_torch.train.train_step import TrainState
from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves

STATE_FILE = "state.pt"


def _flat(tree) -> Dict[str, torch.Tensor]:
    return {name: leaf.detach().cpu() for name, leaf in named_leaves(tree)}


def _load_into(tree, flat: Dict[str, torch.Tensor], what: str, cut=None) -> None:
    """Copy the saved leaves into ``tree``'s; ``cut(path, full)``: this
    rank's shard of a saved full leaf."""
    leaves = named_leaves(tree)
    if sorted(flat) != sorted(name for name, _ in leaves):
        raise ValueError(f"checkpoint {what} does not match the state's structure")
    with torch.no_grad():
        for name, leaf in leaves:
            src = flat[name] if cut is None else cut(name, flat[name])
            if src.shape != leaf.shape or src.dtype != leaf.dtype:
                raise ValueError(f"checkpoint {what}/{name}: {src.shape} {src.dtype} "
                                 f"!= {leaf.shape} {leaf.dtype}")
            leaf.copy_(src)


class CheckpointManager:
    def __init__(self, directory: str | Path, max_to_keep: int = 3, mesh=None, rules=None):
        """``mesh``: the run's mesh (``parallel/mesh.py``); ``None`` for one
        process. ``rules``: which leaves the mesh's model axis splits
        (``parallel/distributed.py:rules_for``); ``None``: none."""
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        self.rules = rules

    def save(self, state: TrainState, data_position: Optional[Dict[str, Any]] = None) -> Path:
        step = int(state.step)
        path = self.directory / f"step_{step:08d}"
        if self.mesh is None:
            self._write(state, step, path, data_position)
            return path
        dist.barrier()
        trees = self._whole(state)  # a collective on a model axis
        if self.mesh.is_lead:
            self._write(state, step, path, data_position, trees)
        dist.barrier()
        return path

    def _whole(self, state: TrainState) -> Dict[str, Any]:
        """The state's trees with every split leaf gathered whole."""
        trees = {"trainable": state.trainable, "frozen": state.frozen,
                 "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}
        if self.rules is None:
            return trees
        return {k: gather_params(t, self.rules, self.mesh.model_group) for k, t in trees.items()}

    def _write(self, state: TrainState, step: int, path: Path,
               data_position: Optional[Dict[str, Any]], trees=None) -> None:
        trees = trees or self._whole(state)
        payload = {
            "trainable": _flat(trees["trainable"]),
            "frozen": _flat(trees["frozen"]),
            "opt_state": {
                "count": state.opt_state["count"].detach().cpu(),
                "mu": _flat(trees["mu"]),
                "nu": _flat(trees["nu"]),
            },
            "step": step,
            "generator": state.generator.get_state(),
        }
        tmp = self.directory / f".tmp_step_{step:08d}.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(payload, tmp / STATE_FILE)
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
        # atomic position write: a crash mid-write must not leave a torn
        # JSON that resumes from epoch 0 with mid-training params
        pos_file = self._position_file(step)
        tmp_pos = pos_file.with_suffix(f".tmp.{os.getpid()}")
        tmp_pos.write_text(json.dumps(data_position or {}))
        os.replace(tmp_pos, pos_file)
        self._gc()

    def restore(self, template: TrainState, step: Optional[int] = None
                ) -> Tuple[TrainState, Dict[str, Any]]:
        """Copy a saved state into ``template`` (built by create_train_state
        with the same config and, on a model axis, cut to this rank's
        shards; it is updated in place and returned)."""
        path = self._step_path(step)
        payload = torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)
        cut = None
        if self.rules is not None:
            def cut(name, full):
                return shard_slice(name, full, self.rules, self.mesh.model_index,
                                   self.mesh.model)
        _load_into(template.trainable, payload["trainable"], "trainable", cut)
        _load_into(template.frozen, payload["frozen"], "frozen", cut)
        _load_into(template.opt_state["mu"], payload["opt_state"]["mu"], "mu", cut)
        _load_into(template.opt_state["nu"], payload["opt_state"]["nu"], "nu", cut)
        template.opt_state["count"].copy_(payload["opt_state"]["count"])
        template.step = int(payload["step"])
        template.generator.set_state(payload["generator"])
        pos_file = self._position_file(template.step)
        position: Dict[str, Any] = {}
        if pos_file.exists():
            try:
                position = json.loads(pos_file.read_text())
            except json.JSONDecodeError:
                print(f"WARNING: corrupt data-position file {pos_file}; "
                      "resuming from the epoch start", flush=True)
        return template, position

    def all_steps(self):
        return sorted(
            int(p.name.split("_")[1]) for p in self.directory.glob("step_*") if p.is_dir()
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_path(self, step: Optional[int]) -> Path:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return self.directory / f"step_{step:08d}"

    def _position_file(self, step: int) -> Path:
        return self.directory / f"step_{step:08d}.position.json"

    def _gc(self) -> None:
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self.directory / f"step_{old:08d}", ignore_errors=True)
            self._position_file(old).unlink(missing_ok=True)
