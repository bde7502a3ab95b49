"""Checkpoint / resume — the port of flexflow_tpu/runtime/checkpoint.py,
its ``.npz`` + ``manifest.json`` backend (the reference's own when
orbax is absent).

The full training state round-trips: params, optimizer slots, mutable
op state, the rng counter and the step.  The keys are the reference's
keypaths (``params/<op>/<w>``, ``opt_state/step``,
``opt_state/m/<op>/<w>``, ``state/<op>/<var>``; dict keys in sorted
order, as ``jax.tree_util`` flattens them), and the manifest lists them
per tree with ``step`` and ``rng_counter``, so either package reads the
other's snapshots of SGD and Adam training.

The contracts are the reference's:

* atomic publish: a snapshot lands in ``step_N.tmp`` and is swapped in
  by ``os.replace``; a re-save moves the old ``step_N`` aside to
  ``step_N.old`` first (the rename pair), and a manager recovers a
  complete ``.old`` left by a kill between the two renames and
  reclaims every other stray;
* completeness: a snapshot counts only when its manifest parses and the
  npz holds exactly the keys it promises; ``restore()`` falls back to
  the newest complete step (with a warning naming the truncated ones);
  a restore validates keys and shapes before it writes anything, so a
  failed one leaves the model untouched;
* retention: the newest ``max_to_keep`` steps stay;
* async save: ``save`` copies every tensor to the host first (the next
  training step updates them in place) and writes in a background
  thread; ``wait()``, the next save and ``restore`` join it;
* in memory: ``snapshot_in_memory`` and ``restore_in_memory``.

Over ranks, every rank takes part in ``save`` (each weight and
optimizer slot is gathered to its whole value, a collective) and rank
0 writes once; ``restore`` reads the whole values on every rank and
keeps each rank's block of them (its live layout, ``local_slices``), so
a snapshot written under one strategy resumes under another, or on one
process.  A ZeRO-1 job's slots are gathered whole from the shards and
cut back to them (``CompiledModel.gather_slots``, ``slot_slices``), so
its snapshot resumes with or without ZeRO, in either package.  An
int8 error-feedback residual (``"<op>/<w>/ef_residual"`` state) is
saved as the sum of the ranks' residuals, the error the summed
gradient lost, the reference's residual; a restore hands each rank an
equal share of it, so the resumed sum carries the same error, though
not each rank's own.  The restore writes into the live tensors in place, so a
captured training step stays valid.

The pipelined, placed and staged lowerings save and restore as the
reference's manager saves their pytrees (it saves whatever the
lowering holds): the placed and staged ones keep the flat lowering's
name-keyed trees (reference placement_lowering.py:364-377,
staged_pipeline_lowering.py:247-263), so their snapshots are the flat
layout's; the pipelined one keeps each block weight, and its slots,
stacked under the first block's op name with a leading [L] axis
(reference pipeline_lowering.py:306-331; the port holds block b's
weights under block b's names, ``interop.blocks_to_stacked``), so its
snapshot is stacked the same way.  A rank holds its stage's or
segment's weights: the save gathers every weight and slot from the
ranks that hold it (``gather_weights``) and the op state from every
rank; a restore keeps what this rank holds.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
_TREES = ("params", "opt_state", "state")


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keypath, leaf) pairs of a nest of dicts, keys in sorted order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix or "_root", tree)]


def _kind(model) -> str:
    """"flat", "pipelined" or "segmented" (placed or staged)."""
    from flexflow_tpu_torch.compiler.pipeline_lowering import (
        PipelinedCompiledModel,
    )
    from flexflow_tpu_torch.compiler.placement_lowering import SegmentedModel

    c = model.compiled
    if c is None:
        raise RuntimeError("compile() before a checkpoint save or restore")
    if isinstance(c, PipelinedCompiledModel):
        return "pipelined"
    if isinstance(c, SegmentedModel):
        return "segmented"
    return "flat"


def _block_names(c) -> List[List[str]]:
    return [[n.op.name for n in blk] for blk in c._blocks]


def _stacked(c, tree: Dict[str, Dict[str, np.ndarray]]):
    """Whole weights by op -> the reference's pipelined layout."""
    names = _block_names(c)
    in_block = {op for blk in names for op in blk}
    out = {op: ws for op, ws in tree.items() if op not in in_block}
    for i, op0 in enumerate(names[0]):
        if op0 in tree:
            out[op0] = {w: np.stack([tree[blk[i]][w] for blk in names])
                        for w in tree[op0]}
    return out


def _unstacked(c, arrays: Dict[str, Dict[str, np.ndarray]]):
    """A pipelined snapshot's trees by keypath with each stacked entry
    ``<op0>/<w>`` (or ``<slot>/<op0>/<w>``) split into its blocks'
    ``<op_b>/<w>``."""
    names = _block_names(c)
    first = {op0: i for i, op0 in enumerate(names[0])}
    out = {}
    for tree, leaves in arrays.items():
        got = {}
        for key, val in leaves.items():
            parts = key.split("/")
            at = len(parts) - 2  # the op name's place in the keypath
            i = first.get(parts[at]) if tree != "state" and at >= 0 else None
            if i is None:
                got[key] = val
                continue
            for b, blk in enumerate(names):
                got["/".join(parts[:at] + [blk[i], parts[-1]])] = val[b]
        out[tree] = got
    return out


def _job_state(model) -> Dict[str, torch.Tensor]:
    """The whole job's op state on every rank: each segment holds its
    own ops' (a collective)."""
    import torch.distributed as dist

    from flexflow_tpu_torch.runtime import distributed

    mine = {k: t.detach().cpu() for k, t in (model.state or {}).items()}
    if distributed.world_size() == 1:
        return mine
    parts = [None] * distributed.world_size()
    dist.all_gather_object(parts, mine)
    out: Dict[str, torch.Tensor] = {}
    for part in parts:
        for k, t in part.items():
            out.setdefault(k, t)
    return out


def _whole_trees(model) -> Dict[str, Dict[str, np.ndarray]]:
    """Host copies of the whole params, optimizer state and model state
    by keypath, in the reference's layout for the lowering: every
    weight and slot gathered from the ranks that hold it (a collective:
    every rank calls it)."""
    from flexflow_tpu_torch.parallel.mesh import all_reduce_sum

    c = model.compiled
    kind = _kind(model)
    trees: Dict[str, Any] = {"params": c.gather_weights(model.params)}
    opt = {}
    for k, v in (model.opt_state or {}).items():
        if not isinstance(v, dict):
            opt[k] = v
        elif kind == "flat":
            opt[k] = c.gather_slots(v)
        else:  # whole slots, laid out as their weights
            opt[k] = c.gather_weights(v)
    trees["opt_state"] = opt
    if kind == "segmented":
        trees["state"] = _job_state(model)
    else:
        ef = c.ef_residual_axes()
        trees["state"] = {k: (all_reduce_sum(t, ef[k], c.mesh) if k in ef
                              else t)
                          for k, t in (model.state or {}).items()}

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        return np.array(tree.detach().cpu().numpy(), copy=True)

    trees = host(trees)
    if kind == "pipelined":
        trees["params"] = _stacked(c, trees["params"])
        trees["opt_state"] = {k: (_stacked(c, v) if isinstance(v, dict)
                                  else v)
                              for k, v in trees["opt_state"].items()}
    return {name: dict(_flatten(tree)) for name, tree in trees.items()}


def _targets(model) -> Dict[str, Dict[str, Tuple[torch.Tensor, tuple]]]:
    """Per tree and keypath: (the live tensor, the whole value's shape,
    the slices of the whole value that are this rank's, () for all, or
    a function that picks them).  A placed or staged model's keypaths
    are its own segment's (the segment's flat lowering places them); a
    pipelined model's are per block op (``_unstacked`` the snapshot)."""
    c = model.compiled
    if _kind(model) == "segmented":
        c = c.segments[c.mine].comp if c.mine is not None else None
        if c is None:
            return {name: {} for name in _TREES}
    out: Dict[str, Dict[str, Tuple]] = {}
    whole = {(n.op.name, ws.name): ws.shape for n in c._topo
             for ws in n.op._weight_specs}

    def blocks(tree, slots=False):
        got = {}
        for op, ws in tree.items():
            for w, t in ws.items():
                shape = tuple(whole[(op, w)])
                got[f"{op}/{w}"] = (t, shape, c.slot_slices(op, w, shape)
                                    if slots else c.weight_placement(
                                        op, w).local_slices(shape, c.mesh))
        return got

    out["params"] = blocks(model.params)
    opt = {}
    for k, v in (model.opt_state or {}).items():
        if isinstance(v, dict):
            opt.update({f"{k}/{p}": x
                        for p, x in blocks(v, slots=True).items()})
        else:
            opt[k] = (v, tuple(v.shape), ())
    out["opt_state"] = opt
    # an error-feedback residual is saved summed over its ranks: each
    # rank resumes from an equal share of it
    ef = c.ef_residual_axes()
    out["state"] = {k: (t, tuple(t.shape),
                        (lambda v, n=c.mesh.size(ef[k]): v / n)
                        if k in ef else ())
                    for k, t in (model.state or {}).items()}
    return out


def _saved_layout(model, arrays):
    """A snapshot's trees keyed as ``_targets`` keys the model."""
    return _unstacked(model.compiled, arrays) if _kind(
        model) == "pipelined" else arrays


def _place(targets, arrays: Dict[str, Dict[str, np.ndarray]],
           strict: bool) -> Tuple[List, List[str], List[str]]:
    """The (live tensor, host block) pairs to copy, with the keypaths
    that found no (shape-compatible) saved value and the saved ones
    that found no home.  ``strict``: raise on either instead."""
    pairs, fresh, used = [], [], set()
    for name, leaves in targets.items():
        saved = arrays.get(name, {})
        for key, (t, shape, sl) in leaves.items():
            val = saved.get(key)
            if val is None:
                if strict:
                    raise KeyError(f"checkpoint missing tensor "
                                   f"{name}/{key!r}")
                fresh.append(f"{name}/{key}")
                continue
            if tuple(val.shape) != shape:
                if strict:
                    raise ValueError(
                        f"shape mismatch for {name}/{key}: checkpoint "
                        f"{tuple(val.shape)} vs model {shape}")
                fresh.append(f"{name}/{key}")
                continue
            used.add(f"{name}/{key}")
            if callable(sl):
                val = sl(val)
            elif sl:
                val = val[sl]
            pairs.append((t, np.asarray(val)))
    dropped = sorted(f"{n}/{k}" for n, vs in arrays.items() for k in vs
                     if f"{n}/{k}" not in used)
    return pairs, fresh, dropped


@torch.no_grad()
def _copy_in(pairs) -> None:
    for t, v in pairs:
        t.copy_(torch.from_numpy(np.array(v, copy=True)).to(t.dtype))


def snapshot_in_memory(model) -> Dict[str, Any]:
    """Host copy of a compiled model's whole training state (a
    collective over ranks): ``{"trees": {tree: {keypath: array}},
    "rng_counter": n}``."""
    return {"trees": _whole_trees(model),
            "rng_counter": int(getattr(model, "_rng_counter", 0))}


def restore_in_memory(model, snap: Dict[str, Any]) -> Dict[str, list]:
    """Place a ``snapshot_in_memory`` capture onto the model's current
    tensors, each rank its blocks: values land on every keypath that
    matches in name and whole shape, the rest keep their values.
    Returns ``{"fresh": [...], "dropped": [...]}`` keypaths (live
    tensors no saved value reached, saved values with no home)."""
    pairs, fresh, dropped = _place(_targets(model),
                                   _saved_layout(model, snap["trees"]),
                                   strict=False)
    _copy_in(pairs)
    # the model state GROWS during training (a cache op's entries land
    # after its first step): carry such entries across too, except the
    # error-feedback residuals, which belong to the comm plan, and any
    # key the template holds (a shape mismatch: the fresh init wins)
    saved = snap["trees"].get("state", {})
    carried = [k for k in dropped if k.startswith("state/")
               and k[6:] not in model.state
               and not k.endswith("/ef_residual")]
    for k in carried:
        model.state[k[6:]] = torch.from_numpy(
            np.array(saved[k[6:]], copy=True)).to(model.compiled.device)
    dropped = [k for k in dropped if k not in carried]
    model._rng_counter = int(snap.get("rng_counter", 0))
    return {"fresh": fresh, "dropped": dropped}


class CheckpointManager:
    """Save/restore the full training state with retention.

    >>> mgr = CheckpointManager("/tmp/ckpt", max_to_keep=3)
    >>> mgr.save(step, model)
    >>> step = mgr.restore(model)   # model must be compile()d first
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 use_orbax: Optional[bool] = None, async_save: bool = False):
        if use_orbax:
            raise ValueError("use_orbax=True but orbax-checkpoint is not "
                             "installed")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.use_orbax = False
        self.async_save = async_save
        self._pending_box: list = [None]
        self._executor = None
        if async_save:
            import weakref
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-save")
            self._finalizer = weakref.finalize(
                self, CheckpointManager._drain, self._executor,
                self._pending_box)
        if self._writer():
            os.makedirs(self.directory, exist_ok=True)
            # a previous writer may have died mid-publish
            self._recover_strays()

    @staticmethod
    def _writer() -> bool:
        from flexflow_tpu_torch.runtime.distributed import rank

        return rank() == 0

    @staticmethod
    def _drain(executor, pending_box):
        fut, pending_box[0] = pending_box[0], None
        try:
            if fut is not None:
                fut.result()
        finally:
            executor.shutdown(wait=True)

    def wait(self) -> None:
        """Block until the in-flight async save (if any) is on disk;
        re-raises its error."""
        fut, self._pending_box[0] = self._pending_box[0], None
        if fut is not None:
            fut.result()

    def close(self) -> None:
        self.wait()
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._finalizer.detach()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(
            _STEP_RE.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    # ------------------------------------------------------------------
    def save(self, step: int, model) -> str:
        """Snapshot a compiled model's full training state (every rank
        calls it; rank 0 writes)."""
        trees = _whole_trees(model)  # host copies: safe for the thread
        path = self._step_dir(step)
        if self._writer():
            arrays: Dict[str, np.ndarray] = {}
            manifest: Dict[str, Any] = {"step": step, "trees": {}}
            for name in _TREES:
                manifest["trees"][name] = list(trees[name])
                for k, v in trees[name].items():
                    arrays[f"{name}/{k}"] = v
            manifest["rng_counter"] = int(getattr(model, "_rng_counter", 0))
            if self.async_save:
                self.wait()  # one in flight; surfaces an earlier error
                self._pending_box[0] = self._executor.submit(
                    self._write_snapshot, path, arrays, manifest)
            else:
                self._write_snapshot(path, arrays, manifest)
        self._barrier(model)
        return path

    @staticmethod
    def _barrier(model) -> None:
        """Every rank of the model's mesh waits for the write (the
        mesh's ranks only: a job shrunk by ``swap_strategy`` runs on a
        block of its ranks)."""
        mesh = model.compiled.mesh
        if mesh.job_world > 1 and mesh.world > 1:
            import torch.distributed as dist

            dist.barrier(group=mesh.group(mesh.names))

    def _write_snapshot(self, path: str, arrays, manifest) -> None:
        """Atomic publish: the snapshot lands whole in ``step_N.tmp``
        and is swapped in by ``os.replace``; the temp and aside names
        do not match ``_STEP_RE``, so a kill at any point leaves the
        previous complete ``step_N`` or none, never a torn one."""
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        old = path + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        if os.path.exists(path):
            # os.replace cannot replace a non-empty directory: move the
            # old snapshot aside first (the rename pair)
            os.rename(path, old)
        os.replace(tmp, path)
        if os.path.exists(old):
            shutil.rmtree(old)
        self._gc()

    # ------------------------------------------------------------------
    def snapshot_complete(self, step: int) -> bool:
        """True when ``step_N`` is complete: its manifest parses and
        the npz holds exactly the keys the manifest promises."""
        return self._complete_dir(self._step_dir(step))

    @staticmethod
    def _complete_dir(path: str) -> bool:
        import zipfile

        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return False
        want = {f"{tree}/{k}"
                for tree, keys in manifest.get("trees", {}).items()
                for k in keys}
        try:
            with np.load(os.path.join(path, "arrays.npz")) as z:
                return set(z.files) == want
        except (OSError, ValueError, EOFError, zipfile.BadZipFile):
            return False

    def latest_complete_step(self) -> Optional[int]:
        """The newest step that passes ``snapshot_complete``."""
        for step in reversed(self.all_steps()):
            if self.snapshot_complete(step):
                return step
        return None

    def restore(self, model, step: Optional[int] = None) -> int:
        """Load a snapshot into a compiled model (each rank its blocks);
        returns its step."""
        kind = _kind(model)
        self.wait()  # an in-flight async save must land first
        if step is None:
            if self.latest_step() is None:
                raise FileNotFoundError(
                    f"no checkpoints in {self.directory}")
            step = self.latest_complete_step()
            if step is None:
                raise ValueError(
                    f"no COMPLETE checkpoint in {self.directory}: every "
                    f"step_N fails the manifest/payload completeness "
                    f"check (torn writes?)")
            skipped = [s for s in self.all_steps() if s > step]
            if skipped:
                warnings.warn(
                    f"checkpoint step(s) {skipped} are truncated "
                    f"(manifest/payload mismatch) — restoring the newest "
                    f"complete step {step}", stacklevel=2)
        path = self._step_dir(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        by_tree: Dict[str, Dict[str, np.ndarray]] = {}
        for key, val in arrays.items():
            name, sub = key.split("/", 1)
            by_tree.setdefault(name, {})[sub] = val
        by_tree = _saved_layout(model, by_tree)
        targets = _targets(model)
        for name in _TREES:
            want = set(by_tree.get(name, {}))
            have = set(targets[name])
            # a stage or segment holds its part of the job's keys
            unexpected = (want - have) if kind == "flat" else set()
            if have - want or unexpected:
                raise ValueError(
                    f"checkpoint structure mismatch in {name!r}: "
                    f"missing={sorted(have - want)[:5]} "
                    f"unexpected={sorted(unexpected)[:5]}")
        pairs, _, _ = _place(targets, by_tree, strict=True)
        _copy_in(pairs)
        model._rng_counter = int(manifest.get("rng_counter", 0))
        return int(manifest["step"])

    # ------------------------------------------------------------------
    def _gc(self) -> None:
        steps = self.all_steps()
        while len(steps) > self.max_to_keep:
            shutil.rmtree(self._step_dir(steps.pop(0)), ignore_errors=True)
        self._recover_strays()

    def _recover_strays(self) -> None:
        """A kill between the rename pair leaves the only complete
        snapshot at ``step_N.old`` with no ``step_N``: rename it back.
        Every other leftover (``.tmp``, superseded or incomplete
        ``.old``) is reclaimed."""
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if name.endswith(".old") and _STEP_RE.match(name[:-4]):
                final = os.path.join(self.directory, name[:-4])
                if not os.path.exists(final) and self._complete_dir(full):
                    os.rename(full, final)
                else:
                    shutil.rmtree(full, ignore_errors=True)
            elif name.endswith(".tmp") and _STEP_RE.match(name[:-4]):
                shutil.rmtree(full, ignore_errors=True)
