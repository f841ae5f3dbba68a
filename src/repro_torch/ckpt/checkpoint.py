"""Fault-tolerant checkpointing: atomic, async-capable. Counterpart of
`repro.ckpt.checkpoint`, with its layout, protocol and keys, so each
package restores the other's checkpoints.

Layout:
    <dir>/step_00001230/arrays.npz     all leaves, path-keyed
    <dir>/step_00001230/meta.json      step, aux metadata
    <dir>/MANIFEST.json                {"latest": 1230, "steps": [...]}

Protocol (crash-safe at every point):
  1. write into step_<n>.tmp/
  2. fsync + atomic rename to step_<n>/
  3. rewrite MANIFEST.json (atomic via tmp+rename) — a checkpoint exists
     iff the manifest lists it, so a crash mid-write never corrupts state.

Keys are the reference's `_path_str`s joined by "$": dict keys, a
`NamedTuple`'s field names (`opt$step`, `opt$m$layers$attn$wq`), list
and tuple indices, and a `PimWeight`'s planes and scale as `0` and `1`,
the flattened children of the reference's registered pytree. Leaves are
saved as host numpy arrays; `restore` gives each the dtype and device of
the target's leaf. A `PimWeight`'s `n_bits` / `group` come from the
target, as in the reference.

bf16 leaves (the serving params `init_lm` makes) are saved as the
reference saves them: numpy has no bf16 dtype without `ml_dtypes`, and
`np.savez` stores the reference's `ml_dtypes` array as raw 2-byte voids
(`'|V2'`), so the port writes a bf16 leaf's bits the same way, byte for
byte. `restore` reads them back as bf16 bit for bit, or widened exactly
into an f32 target.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..quant.bitplane import PimWeight

SEP = "$"


def _items(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """`(key, leaf)` in the reference's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (str(i),))
    elif isinstance(tree, PimWeight):
        yield SEP.join(path + ("0",)), tree.planes
        yield SEP.join(path + ("1",)), tree.scale
    else:
        yield SEP.join(path), tree


def _map(fn, tree, *others, path=()):
    """`fn(leaf, *other_leaves, path)` over `tree`'s tensor leaves (a
    `PimWeight`'s planes and scale as `0` and `1`), same structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *[o[k] for o in others], path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(fn, getattr(tree, n),
                                 *[getattr(o, n) for o in others],
                                 path=path + (n,)) for n in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *[o[i] for o in others],
                               path=path + (str(i),))
                          for i, v in enumerate(tree))
    if isinstance(tree, PimWeight):
        return PimWeight(
            _map(fn, tree.planes, *[o.planes for o in others],
                 path=path + ("0",)),
            _map(fn, tree.scale, *[o.scale for o in others],
                 path=path + ("1",)),
            tree.n_bits, tree.group)
    return fn(tree, *others, path)


def _rebuild(tree, arrays: Dict[str, np.ndarray], device=None):
    """`tree`'s structure with each leaf read from `arrays`, in the
    leaf's dtype, on `device` (default: the leaf's)."""
    return _map(lambda target, path: _leaf(target, arrays, path, device),
                tree)


def _to_device(tree, target, device=None):
    """Each leaf of `tree` on `device`, or its `target` leaf's device."""
    return _map(lambda x, t, path: x.to(
        device=t.device if device is None else device, copy=True),
        tree, target)


def _leaf(target: torch.Tensor, arrays, path, device=None) -> torch.Tensor:
    """The leaf at `path`, in `target`'s dtype, on `device` or
    `target`'s. A 2-byte void array holds bf16 bits: the only 2-byte
    type `ml_dtypes` adds to numpy is bfloat16 (float16 is numpy's own
    `'f2'`), and `np.savez` stores such added types as voids."""
    key = SEP.join(path)
    if key not in arrays:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    # `np.asarray`, not `np.ascontiguousarray`, which makes a 0-dim
    # array (the optimizer's step) 1-dim
    a = np.asarray(arrays[key], order="C")
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        if not target.dtype.is_floating_point:
            raise TypeError(
                f"checkpoint leaf {key!r} holds bfloat16, which does not "
                f"restore into {target.dtype}")
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=target.device if device is None else device,
                dtype=target.dtype)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        # a copy even on the CPU: the snapshot `save_async` writes must
        # not see the in-place updates of the steps that follow
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            # the reference's bytes: its `ml_dtypes` bf16 saves as '|V2'
            return host.view(torch.uint16).numpy().view("V2")
        return host.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _items(tree)}


def _atomic_write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep_n: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None

    # -- manifest ------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, "MANIFEST.json")

    def manifest(self) -> Dict[str, Any]:
        p = self._manifest_path()
        if not os.path.exists(p):
            return {"latest": None, "steps": []}
        with open(p) as f:
            return json.load(f)

    def latest_step(self) -> Optional[int]:
        return self.manifest()["latest"]

    def _step_dir(self, step: int, tmp: bool = False) -> str:
        d = os.path.join(self.directory, f"step_{step:08d}")
        return d + ".tmp" if tmp else d

    # -- save ----------------------------------------------------------

    def save(self, step: int, state: Any, meta: Optional[Dict] = None) -> str:
        """Blocking, atomic save of a state tree."""
        self._write_prefetched(step, _flatten(state), meta)
        return self._step_dir(step)

    def save_async(self, step: int, state: Any, meta: Optional[Dict] = None):
        """Device->host copy happens now; file IO on a background thread."""
        self.wait()
        arrays = _flatten(state)  # synchronous copy (consistent snapshot)

        def work():
            try:
                self._write_prefetched(step, arrays, meta)
            except BaseException as e:  # surfaced by wait()
                self._async_error = e

        self._async_thread = threading.Thread(target=work, daemon=True)
        self._async_thread.start()

    def _write_prefetched(self, step, arrays, meta):
        tmp = self._step_dir(step, tmp=True)
        final = self._step_dir(step)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "meta": meta or {}, "time": time.time()}, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        man = self.manifest()
        steps = sorted(set(man["steps"] + [step]))
        _atomic_write_json(self._manifest_path(), {"latest": step, "steps": steps})
        self._gc(steps)

    def wait(self):
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            raise err

    def _gc(self, steps: List[int]):
        for s in steps[: max(0, len(steps) - self.keep_n)]:
            d = self._step_dir(s)
            if os.path.exists(d):
                shutil.rmtree(d)
        kept = steps[-self.keep_n:]
        _atomic_write_json(
            self._manifest_path(), {"latest": kept[-1], "steps": kept}
        )

    # -- restore ---------------------------------------------------------

    def restore(self, target: Any, step: Optional[int] = None,
                shardings: Optional[Any] = None, mesh=None, device=None
                ) -> Tuple[Any, int]:
        """Restore into the structure of `target` (a tree of tensors of
        the whole shapes — `meta` ones allocate nothing): each leaf gets
        the target leaf's dtype, and its device unless `device` is
        given. With `shardings` (a spec tree of the same structure, as
        `launch.specs.param_shardings` gives) each rank gets its block
        of every leaf on `mesh` (the active sharding context's unless
        given) — any mesh, whatever mesh saved it: checkpoints hold
        whole leaves, so restore is elastic."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        with np.load(os.path.join(self._step_dir(step), "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        if shardings is not None:
            from ..dist.sharding import current_context, place_tree
            mesh = mesh if mesh is not None else current_context().mesh
            whole = _rebuild(target, arrays, device=torch.device("cpu"))
            placed = place_tree(whole, shardings, mesh, copy=False)
            return _to_device(placed, target, device), step
        return _rebuild(target, arrays, device=device), step
