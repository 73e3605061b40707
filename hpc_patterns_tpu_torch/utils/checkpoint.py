"""Checkpoint/resume of the training state: the counterpart of
``hpc_patterns_tpu/utils/checkpoint.py`` (orbax there, ``torch.save``
here).

Layout: ``<path>/step_<N>/`` holding ``params.pt``, ``opt_state.pt`` and
``step.json`` as separate files, so :func:`restore_params` reads the
params and never the optimizer moments (twice the params' bytes). A
step directory is written under a temporary name and renamed into place,
so a reader never sees half a checkpoint. Files load with
``torch.load(weights_only=True)``: tensors, dicts and numbers only.

A sharded state (``layout=``: the params and moments stored as their
rank-stacked shards, ``models/sharding`` or ``models/pp``) saves the
GLOBAL tensors and restores into its layout, so a checkpoint does not
depend on the mesh it was written from.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import torch

from hpc_patterns_tpu_torch.models.train import tree_leaves


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def _layout(params, opt_state, fn):
    """``fn`` (a shard or unshard tree function) over the params and both
    moment trees; the state as it is without one."""
    if fn is None:
        return params, opt_state
    opt = dict(opt_state)
    for k in ("mu", "nu"):
        if k in opt:
            opt[k] = fn(opt[k])
    return fn(params), opt


def save_checkpoint(path, params, opt_state, step: int = 0, *,
                    layout=None) -> str:
    """Write {params, opt_state, step} to ``<path>/step_<step>``
    (replacing one of that step), synchronized; returns its path.
    ``layout``: a sharded state's ``(shard, unshard)`` tree functions
    (``models/sharding.state_layout``, ``models/pp.state_layout``); the
    state is saved as its global tensors."""
    params, opt_state = _layout(_detached(params), _detached(opt_state),
                                layout and layout[1])
    root = Path(path).resolve()
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step}"
    tmp = root / f".step_{step}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save(params, tmp / "params.pt")
    torch.save(opt_state, tmp / "opt_state.pt")
    (tmp / "step.json").write_text(json.dumps({"step": int(step)}))
    old = None
    if final.exists():
        old = root / f".step_{step}.old-{os.getpid()}"
        os.replace(final, old)
    os.replace(tmp, final)
    if old is not None:
        shutil.rmtree(old)
    return str(final)


def latest_step(path) -> int | None:
    steps = sorted(int(p.name.split("_", 1)[1])
                   for p in Path(path).glob("step_*")
                   if p.name.split("_", 1)[1].isdigit())
    return steps[-1] if steps else None


def _step_dir(path, step):
    root = Path(path).resolve()
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no step_* checkpoints under {root}")
    return root / f"step_{step}"


def _load(file, device):
    return torch.load(file, map_location=device, weights_only=True)


def restore_params(path, step: int | None = None, *, device=None):
    """(params, step) from the latest (or the given) step: the params
    file only, onto ``device`` (default: where they were saved)."""
    d = _step_dir(path, step)
    params = _load(d / "params.pt", device)
    return params, json.loads((d / "step.json").read_text())["step"]


def same_structure(a, b) -> bool:
    """Whether two nested dicts hold the same keys, and tensors of the
    same shapes and dtypes (other leaves: values of the same type)."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and a.keys() == b.keys()
                and all(same_structure(a[k], b[k]) for k in a))
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and a.dtype == b.dtype)
    return type(a) is type(b)


def restore_checkpoint(path, params_like, opt_state_like,
                       step: int | None = None, *, layout=None):
    """(params, opt_state, step). ``*_like`` give the structure, shapes,
    dtypes and devices the restored tensors must have (the live state
    created the same way as at save time); a mismatch raises
    ``ValueError``. ``layout`` (as :func:`save_checkpoint`'s):
    ``*_like`` is a sharded state; the global tensors are placed into its
    layout (params requiring grad as ``*_like``'s do)."""
    d = _step_dir(path, step)
    with torch.no_grad():
        like_p, like_o = _layout(params_like, opt_state_like,
                                 layout and layout[1])
    like = {"params": like_p, "opt_state": like_o}
    dev = tree_leaves(params_like)[0].device
    got = {"params": _load(d / "params.pt", dev),
           "opt_state": _load(d / "opt_state.pt", dev)}
    if not same_structure(like, got):
        raise ValueError(f"checkpoint {d} does not match the state's "
                         "structure, shapes or dtypes")
    params, opt_state = _layout(got["params"], got["opt_state"],
                                layout and layout[0])
    if layout is not None:
        for p, q in zip(tree_leaves(params), tree_leaves(params_like)):
            p.requires_grad_(q.requires_grad)
    return (params, opt_state,
            json.loads((d / "step.json").read_text())["step"])
