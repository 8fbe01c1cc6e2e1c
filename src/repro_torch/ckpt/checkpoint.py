"""Sharded, fault-tolerant checkpoints: the counterpart of
``repro/ckpt/checkpoint.py``, with its on-disk layout, so a checkpoint
written by either package restores into the other.

Layout:  <root>/step_<N:08d>/
           manifest.json     - leaf names, shapes, dtypes, crc32, lane
           lane<k>/<idx>.npy - one file per leaf, idx its place in the
                               tree's leaf order

* atomic: a save writes ``step_<N>.tmp``, fsyncs it, then renames it; a
  crashed save is never taken for a checkpoint (restore trusts only
  manifests of renamed directories).
* checked: each leaf's crc32 is verified on load.
* asynchronous: ``save(blocking=False)`` copies the tree to the host
  first (so training may go on changing it) and returns a future.
* MIDAS lanes: leaves are assigned to writer lanes by ``WriterPool``.
* collected: the newest ``keep`` checkpoints stay.

Leaf names are the reference's tree paths (``utils.trees``), e.g.
``.params/blocks/0/mixer/wq`` for a ``TrainState``'s stacked weights.
:func:`load_params` reads a checkpoint's weights into a model to serve.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.ckpt.midas_writer import WriterPool
from repro_torch.convert import tree_to_numpy
from repro_torch.utils import tree_flatten_with_names, tree_unflatten_like


class CheckpointManager:
    def __init__(self, root: str, *, lanes: int = 4, keep: int = 3,
                 policy: str = "midas"):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.lanes = lanes
        self.keep = keep
        self.policy = policy
        self._exec = ThreadPoolExecutor(max_workers=1)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, blocking: bool = True
             ) -> Optional[Future]:
        """Write ``tree`` (tensors or numpy leaves) as step ``step``;
        with ``blocking=False`` return a future of the write."""
        host_tree = tree_to_numpy(tree)
        if blocking:
            self._save(step, host_tree)
            return None
        return self._exec.submit(self._save, step, host_tree)

    def _save(self, step: int, host_tree) -> None:
        final = self.root / f"step_{step:08d}"
        tmp = self.root / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        pool = WriterPool(self.lanes, policy=self.policy)
        manifest: Dict[str, Any] = {"step": step, "leaves": {}}
        try:
            for idx, (name, arr) in enumerate(
                    tree_flatten_with_names(host_tree)):
                arr = np.asarray(arr)
                lane = pool.assign(name, int(arr.nbytes))
                (tmp / f"lane{lane}").mkdir(exist_ok=True)
                fname = f"lane{lane}/{idx}.npy"
                manifest["leaves"][name] = {
                    "file": fname,
                    "shape": list(arr.shape),
                    "dtype": str(arr.dtype),
                    "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
                    "lane": lane,
                }
                pool.submit(lane, tmp / fname, arr)
            pool.join()
        finally:
            pool.close()
        manifest["lane_bytes"] = pool.lane_bytes()
        with open(tmp / "manifest.json", "w") as f:
            f.write(json.dumps(manifest))
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    def close(self) -> None:
        """Wait for the saves in flight and stop the save thread."""
        self._exec.shutdown(wait=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for p in self.root.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree):
        """Restore into the structure of ``target_tree`` (tensor or
        numpy leaves): numpy leaves, shapes verified against the
        target's and checksums checked.  Raises ``IOError`` on a bad
        checksum, ``ValueError`` on a shape mismatch, ``KeyError`` on a
        missing leaf."""
        d = self.root / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        names = dict(tree_flatten_with_names(target_tree))
        out = {}
        for name, meta in manifest["leaves"].items():
            arr = np.load(d / meta["file"])
            if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != \
                    meta["crc32"]:
                raise IOError(f"checksum mismatch for {name}")
            if name in names and tuple(arr.shape) != tuple(
                    names[name].shape):
                raise ValueError(
                    f"shape mismatch for {name}: ckpt {arr.shape} vs "
                    f"target {tuple(names[name].shape)}")
            out[name] = arr
        missing = set(names) - set(out)
        if missing:
            raise KeyError(f"checkpoint missing leaves: {sorted(missing)}")
        return tree_unflatten_like(target_tree, [out[n] for n in names])

    def restore_latest(self, target_tree):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target_tree)


def load_params(root: str, cfg, *, step: Optional[int] = None,
                device=None):
    """The weights of a training checkpoint under ``root`` (written by
    either package's ``CheckpointManager``; the latest step unless
    ``step``) as a :class:`~repro_torch.models.Model` of ``cfg`` on
    ``device`` (the card when None), ready to serve
    (``launch.serve.serve(..., model=)``).  Only the ``.params`` leaves
    are read; their checksums and shapes are checked."""
    from repro_torch import models
    from repro_torch.convert import params_from_numpy, params_tree

    target = {".params": params_tree(models.Model(cfg, device="meta"))}
    cm = CheckpointManager(root)
    try:
        step = cm.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
        # a TrainState's weights are named ".params/...": a dict keyed
        # ".params" names its leaves alike
        restored = cm.restore(step, target)
    finally:
        cm.close()
    return params_from_numpy(cfg, restored[".params"], device=device)
