"""Reference-checkpoint import and export (counterpart of
`deep_gcns_torch_tpu/utils/import_torch.py`).

The reference (lightaime/deep_gcns_torch) saves `{epoch, model_state_dict,
optimizer_state_dict, ...}` with `module.`-prefixed keys when it trained
under DataParallel (`utils/ckpt_util.py:9-64`). The port's modules keep the
reference's parameter names, so an import is three steps: unwrap the
checkpoint dict and the prefix, rename the few keys whose module path
differs, and `load_state_dict`, reporting unused and missing keys as the JAX
importer's ``strict`` does.

What differs from the reference's names:
  RevGCN, RevGAT  the reference wraps each reversible layer in an
                  `InvertibleModuleWrapper` that stores it as `_fn`
                  (`gcns.{l}._fn.Fms.{g}`, `convs.{l}._fn.Fms.{g}`); the port
                  has no wrapper (`gcns.{l}.Fms.{g}`).
  RevGAT          normalises with batch statistics (exact reversibility), so
                  the reference BatchNorms' running statistics have no
                  destination and are dropped, as JAX's `_bn_drop_stats`
                  does; an export writes fresh ones (mean 0, var 1, count 0).
  DeeperGCN       the proteins variant names its norms `layer_norms`
                  (`examples/ogb/ogbn_proteins/model.py:63`); the port's are
                  `norms`.
  DeepGCN (PPI)   nothing: `head.gconv`, `backbone.{i}.body.gconv`,
                  `fusion_block`, `prediction.{0,2,4}`, as the reference's.

An export is the model's `state_dict` as numpy under the reference's names.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_RUNNING = (".running_mean", ".running_var", ".num_batches_tracked")


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """`torch.load` a reference `.pth` on the CPU; unwrap `model_state_dict`
    and the DataParallel `module.` prefix."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k): torch.as_tensor(v)
            for k, v in obj.items()}


def _load(model: torch.nn.Module, sd: Mapping[str, torch.Tensor], strict: bool):
    """`load_state_dict` that reports, when ``strict``, the reference keys
    that found no parameter and the parameters that found no key. A key of
    a fixed scalar (GENConv's t, p or y when not learned: a non-persistent
    buffer here, absent from the reference's `state_dict` but written by the
    JAX exporter) must equal the model's value and is then consumed."""
    sd = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
          for k, v in sd.items()}
    own, buffers = model.state_dict(), dict(model.named_buffers())
    for k in [k for k in sd if k not in own and k in buffers]:
        if not torch.allclose(sd[k].float().cpu(), buffers[k].float().cpu()):
            raise ValueError(f"{k} is {sd[k].tolist()} in the checkpoint and "
                             f"{buffers[k].tolist()} (fixed) in the model")
        del sd[k]
    res = model.load_state_dict(sd, strict=False)
    if strict and (res.unexpected_keys or res.missing_keys):
        left, miss = sorted(res.unexpected_keys), sorted(res.missing_keys)
        raise ValueError(f"unmapped reference keys: {left[:10]}{' …' if len(left) > 10 else ''}"
                         f"; missing: {miss[:10]}{' …' if len(miss) > 10 else ''}")
    return res


def _strip_fn(sd: Mapping, top: str) -> Dict:
    pat = re.compile(rf"^{top}\.(\d+)\._fn\.")
    return {pat.sub(rf"{top}.\1.", k): v for k, v in sd.items()}


def _add_fn(sd: Mapping, top: str) -> Dict:
    pat = re.compile(rf"^{top}\.(\d+)\.Fms\.")
    return {pat.sub(rf"{top}.\1._fn.Fms.", k): v for k, v in sd.items()}


def import_deepergcn(sd: Mapping[str, torch.Tensor], model: torch.nn.Module,
                     strict: bool = True):
    """Load a reference DeeperGCN `state_dict` (arxiv or proteins naming)
    into ``model`` (`models.DeeperGCN`)."""
    sd = {re.sub(r"^layer_norms\.", "norms.", k): v for k, v in sd.items()}
    return _load(model, sd, strict)


def import_deepgcn(sd: Mapping[str, torch.Tensor], model: torch.nn.Module,
                   strict: bool = True):
    """Load a reference PPI DeepGCN `state_dict` (`examples/ppi/
    architecture.py`) into ``model`` (`models.DeepGCNStatic`): the names are
    the reference's, so nothing is renamed. A single zoo conv loads the same
    way (`ref_mrconv`'s `nn.0.weight`, `ref_semigcn`'s `gconv.weight`)."""
    return _load(model, sd, strict)


def import_revgcn(sd: Mapping[str, torch.Tensor], model: torch.nn.Module,
                  strict: bool = True):
    """Load a reference RevGCN `state_dict` into ``model`` (`models.RevGCN`)."""
    return _load(model, _strip_fn(sd, "gcns"), strict)


def import_revgat(sd: Mapping[str, torch.Tensor], model: torch.nn.Module,
                  strict: bool = True):
    """Load a reference RevGAT (DGL) `state_dict` into ``model``
    (`models.RevGAT`), dropping the norms' running statistics."""
    own = model.state_dict()
    sd = {k: v for k, v in _strip_fn(sd, "convs").items()
          if k in own or not k.endswith(_RUNNING)}
    return _load(model, sd, strict)


def _numpy(sd: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def export_deepergcn(model: torch.nn.Module, norm_prefix: str = "norms"
                     ) -> Dict[str, np.ndarray]:
    """The reference DeeperGCN's `state_dict` as numpy; ``norm_prefix``
    "layer_norms" for the proteins variant."""
    return {re.sub(r"^norms\.", norm_prefix + ".", k): v
            for k, v in _numpy(model.state_dict()).items()}


def export_deepgcn(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The reference PPI DeepGCN's `state_dict` as numpy."""
    return _numpy(model.state_dict())


def export_revgcn(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The reference RevGCN's `state_dict` as numpy (`_fn.` restored)."""
    return _add_fn(_numpy(model.state_dict()), "gcns")


def export_revgat(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The reference RevGAT's `state_dict` as numpy (`_fn.` restored), with
    fresh running statistics for every BatchNorm (mean 0, var 1, count 0)."""
    out = _add_fn(_numpy(model.state_dict()), "convs")
    for k in [k for k in out if re.search(r"(^|\.)norm\.weight$", k)]:
        pre = k[: -len(".weight")]
        out[pre + ".running_mean"] = np.zeros_like(out[k])
        out[pre + ".running_var"] = np.ones_like(out[k])
        out[pre + ".num_batches_tracked"] = np.asarray(0, np.int64)
    return out
