"""Checkpoint save and load (counterpart of `deep_gcns_torch_tpu/utils/ckpt.py`).

The port saves in the reference's own format (`utils/ckpt_util.py:9-24` of
lightaime/deep_gcns_torch): `torch.save` of {epoch, model_state_dict,
optimizer_state_dict, best_value, extras} to `{path}.pth`, every tensor
moved to the CPU first, beside the JAX package's `{path}.json` metadata
(epoch, best_value, extras). `save_best` keeps the reference's `_best` copy
(`ckpt_util.py:107-111`). `load_jax_ckpt` reads a checkpoint that the JAX
package wrote (`{path}.npz`) into the port's `state_dict`.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import import_jax


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def checkpoint_payload(model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer],
                       epoch: int, best_value: float, extra: Optional[dict]) -> dict:
    """The reference's checkpoint dict, every tensor a CPU copy (so the
    caller may go on training while it is written)."""
    payload = {"epoch": int(epoch), "model_state_dict": _to_cpu(model.state_dict()),
               "best_value": float(best_value)}
    if optimizer is not None:
        payload["optimizer_state_dict"] = _to_cpu(optimizer.state_dict())
    payload.update(extra or {})
    return payload


def write_payload(path: str, payload: dict):
    """`{path}.pth` (the payload) and `{path}.json` (its metadata)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(payload, path + ".pth")
    meta = {k: v for k, v in payload.items()
            if k not in ("model_state_dict", "optimizer_state_dict")}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def save_ckpt(path: str, *, model: torch.nn.Module,
              optimizer: Optional[torch.optim.Optimizer] = None, epoch: int = 0,
              best_value: float = -float("inf"), extra: Optional[dict] = None):
    """Write `{path}.pth` and `{path}.json`."""
    write_payload(path, checkpoint_payload(model, optimizer, epoch, best_value, extra))


def load_ckpt(path: str, *, model: torch.nn.Module,
              optimizer: Optional[torch.optim.Optimizer] = None,
              map_location=None) -> Dict[str, Any]:
    """Restore ``model`` (and ``optimizer``) in place from `{path}.pth`, onto
    ``map_location`` (default: the device of the model's first parameter or
    buffer). Returns the metadata: epoch, best_value and the extras."""
    if map_location is None:
        first = next(iter(model.state_dict().values()), None)
        map_location = first.device if first is not None else "cpu"
    ckpt = torch.load(path + ".pth", map_location=map_location, weights_only=False)
    model.load_state_dict(ckpt["model_state_dict"])
    if optimizer is not None:
        if "optimizer_state_dict" not in ckpt:
            raise KeyError(f"{path}.pth holds no optimizer state")
        optimizer.load_state_dict(ckpt["optimizer_state_dict"])
    return {k: v for k, v in ckpt.items()
            if k not in ("model_state_dict", "optimizer_state_dict")}


def save_best(path: str, is_best: bool):
    """Copy `{path}.pth/.json` to `{path}_best.*`."""
    if not is_best:
        return
    for ext in (".pth", ".json"):
        if os.path.exists(path + ext):
            shutil.copyfile(path + ext, path + "_best" + ext)


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    """{"a/0/b": v} → {"a": {0: {"b": v}}}: the inverse of the JAX package's
    path flattening (`ckpt.py:22-27`); list indices come back as int keys,
    which the importers index like lists."""
    root: dict = {}
    for key, v in flat.items():
        node = root
        parts = [int(p) if p.isdigit() else p for p in key.split("/")]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def load_jax_ckpt(path: str, kind: str, cfg) -> Dict[str, torch.Tensor]:
    """The port's `state_dict` from the JAX package's `{path}.npz`
    (`save_ckpt`, `ckpt.py:34-49`): the `params|…` and `state|…` arrays are
    unflattened into nested dicts and carried across by `utils/import_jax.py`.
    ``kind`` is "deeper_gcn", "rev_gcn" or "rev_gat"; ``cfg`` the model's
    config (either package's). The optimizer state (`opt|…`) is not carried
    across: optax's and torch's layouts differ, so a run resumed from a JAX
    checkpoint starts its optimizer afresh."""
    with np.load(path + ".npz") as z:
        trees: Dict[str, dict] = {"params": {}, "state": {}}
        for key in z.files:
            name, _, rest = key.partition("|")
            if name in trees:
                trees[name][rest] = z[key]
    params, state = _unflatten(trees["params"]), _unflatten(trees["state"])
    if kind == "deeper_gcn":
        return import_jax.deeper_gcn_state_dict_from_jax(params, state, cfg)
    if kind == "rev_gcn":
        return import_jax.rev_gcn_state_dict_from_jax(params, cfg)
    if kind == "rev_gat":
        return import_jax.rev_gat_state_dict_from_jax(params, cfg)
    raise ValueError(f"kind must be 'deeper_gcn', 'rev_gcn' or 'rev_gat', got {kind!r}")
