"""Carry weights from the JAX package's DeeperGCN into the port's `state_dict`
(the inverse direction of `deep_gcns_torch_tpu/utils/import_torch.py`).

The JAX model keeps per-layer parameters stacked on a leading L axis for
`lax.scan`, `Linear.w` as [in, out], and norms as `scale`/`bias` params plus
`mean`/`var` state. The port keeps one module per layer, `weight` as
[out, in], and `weight`/`bias`/`running_mean`/`running_var`. The arrays
arrive as numpy (the caller converts the JAX pytrees), so this module needs
no JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _linear(out: Dict[str, torch.Tensor], prefix: str, p: dict, layer: Optional[int]):
    pick = (lambda a: np.asarray(a)) if layer is None else (lambda a: np.asarray(a)[layer])
    out[prefix + ".weight"] = _t(pick(p["w"]).T)
    if "b" in p:
        out[prefix + ".bias"] = _t(pick(p["b"]))


def _norm(out, prefix, p: dict, s: dict, norm: str, layer: int):
    if norm in ("batch", "layer"):
        out[prefix + ".weight"] = _t(np.asarray(p["scale"])[layer])
        out[prefix + ".bias"] = _t(np.asarray(p["bias"])[layer])
    if norm == "batch":
        out[prefix + ".running_mean"] = _t(np.asarray(s["mean"])[layer])
        out[prefix + ".running_var"] = _t(np.asarray(s["var"])[layer])
        out[prefix + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _mlp_seq(n_layers: int, norm: str) -> List[dict]:
    """Sequential child index of each MLP entry's Linear and norm (the last
    Linear is bare), as the port's and the reference's MLP number them."""
    entries, seq = [], 0
    for i in range(1, n_layers + 1):
        e = {"lin": seq}
        seq += 1
        if i < n_layers:
            if norm != "none":
                e["norm"] = seq
                seq += 1
            seq += 1  # ReLU
        entries.append(e)
    return entries


def deeper_gcn_state_dict_from_jax(params: dict, state: dict, cfg
                                   ) -> Dict[str, torch.Tensor]:
    """`state_dict` of `models.DeeperGCN(cfg)` from the JAX `DeeperGCN(cfg)`'s
    (params, state) pytrees of numpy arrays; loads with `load_state_dict`.
    Fixed (not learned) t/p/y are buffers rebuilt from ``cfg``, not entries."""
    out: Dict[str, torch.Tensor] = {}
    norm = str(cfg.norm).lower()
    _linear(out, "node_features_encoder", params["encoder"], None)
    _linear(out, "node_pred_linear", params["pred"], None)
    gp, gs = params["gcns"], state.get("gcns", {})
    learned = {"t": cfg.learn_t and cfg.aggr in ("softmax", "softmax_sum"),
               "p": cfg.learn_p and cfg.aggr in ("power", "power_sum"),
               "y": cfg.learn_y and cfg.aggr in ("softmax_sum", "power_sum")}
    for l in range(cfg.num_layers):
        pre = f"gcns.{l}"
        for i, e in enumerate(_mlp_seq(cfg.mlp_layers, norm)):
            _linear(out, f"{pre}.mlp.{e['lin']}", gp["mlp"][i]["lin"], l)
            if "norm" in e:
                _norm(out, f"{pre}.mlp.{e['norm']}", gp["mlp"][i]["norm"],
                      gs["mlp"][i].get("norm", {}), norm, l)
        for name, on in learned.items():
            if on:
                out[f"{pre}.{name}"] = _t(np.asarray(gp[name])[l])
        if "msg_norm" in gp:
            out[f"{pre}.msg_norm.msg_scale"] = _t(np.asarray(gp["msg_norm"]["s"])[l])
        _norm(out, f"norms.{l}", params["norms"], state.get("norms", {}), norm, l)
    return out
