"""Carry weights from the JAX package's DeeperGCN, RevGCN (GEN or GAT group
functions), RevGAT and PyG GATConv into the port's `state_dict` (the inverse
direction of `deep_gcns_torch_tpu/utils/import_torch.py`).

The JAX model keeps per-layer parameters stacked on a leading L axis for
`lax.scan`, `Linear.w` as [in, out], and norms as `scale`/`bias` params plus
`mean`/`var` state. The port keeps one module per layer, `weight` as
[out, in], and `weight`/`bias`/`running_mean`/`running_var`. The arrays
arrive as numpy (the caller converts the JAX pytrees), so this module needs
no JAX.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _linear(out: Dict[str, torch.Tensor], prefix: str, p: dict, layer):
    """``layer``: None, or the index of the leading stacked axes to pick."""
    pick = (lambda a: np.asarray(a)) if layer is None else (lambda a: np.asarray(a)[layer])
    out[prefix + ".weight"] = _t(pick(p["w"]).T)
    if "b" in p:
        out[prefix + ".bias"] = _t(pick(p["b"]))


def _norm(out, prefix, p: dict, s: dict, norm: str, layer):
    if norm in ("batch", "layer"):
        out[prefix + ".weight"] = _t(np.asarray(p["scale"])[layer])
        out[prefix + ".bias"] = _t(np.asarray(p["bias"])[layer])
    if norm == "batch":
        out[prefix + ".running_mean"] = _t(np.asarray(s["mean"])[layer])
        out[prefix + ".running_var"] = _t(np.asarray(s["var"])[layer])
        out[prefix + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _mlp_seq(n_layers: int, norm: str, last_lin: bool = True) -> List[dict]:
    """Sequential child index of each MLP entry's Linear and norm (the last
    Linear is bare when ``last_lin``), as the port's and the reference's MLP
    number them."""
    entries, seq = [], 0
    for i in range(1, n_layers + 1):
        e = {"lin": seq}
        seq += 1
        if i < n_layers or not last_lin:
            if norm != "none":
                e["norm"] = seq
                seq += 1
            seq += 1  # ReLU
        entries.append(e)
    return entries


def _learned(cfg) -> Dict[str, bool]:
    """Which of GENConv's t/p/y are parameters (the others are buffers
    rebuilt from the config, not `state_dict` entries)."""
    return {"t": cfg.learn_t and cfg.aggr in ("softmax", "softmax_sum"),
            "p": cfg.learn_p and cfg.aggr in ("power", "power_sum"),
            "y": cfg.learn_y and cfg.aggr in ("softmax_sum", "power_sum")}


def _entry(seq, i: int) -> dict:
    """Entry i of a list of per-layer trees, or of a dict keyed by int (a
    tree read back from a file, where leafless entries are missing)."""
    if isinstance(seq, dict):
        return seq.get(i, {})
    return seq[i] if i < len(seq) else {}


def _genconv(out, pre: str, gp: dict, gs: dict, cfg, norm: str, idx):
    """One GENConv's entries under ``pre`` from the JAX conv params stacked
    on leading axes, picked at ``idx`` (a layer, or a (layer, group) pair)."""
    gs_mlp = gs.get("mlp", {})
    for i, e in enumerate(_mlp_seq(cfg.mlp_layers, norm)):
        _linear(out, f"{pre}.mlp.{e['lin']}", gp["mlp"][i]["lin"], idx)
        if "norm" in e:
            _norm(out, f"{pre}.mlp.{e['norm']}", gp["mlp"][i]["norm"],
                  _entry(gs_mlp, i).get("norm", {}), norm, idx)
    for name, on in _learned(cfg).items():
        if on:
            out[f"{pre}.{name}"] = _t(np.asarray(gp[name])[idx])
    if "msg_norm" in gp:
        out[f"{pre}.msg_norm.msg_scale"] = _t(np.asarray(gp["msg_norm"]["s"])[idx])
    if "edge_encoder" in gp:
        _encoder(out, f"{pre}.edge_encoder", gp["edge_encoder"], "bond_embedding_list", idx)


def _encoder(out, prefix: str, p: dict, list_name: str, layer=None):
    """A Linear ({w, b}) or a MultiEmbedding ({tables}: the Atom/Bond
    encoder, tables under ``prefix.list_name.{k}.weight``), picked at
    ``layer`` of the leading stacked axes when given."""
    if "tables" not in p:
        _linear(out, prefix, p, layer)
        return
    for k, tbl in enumerate(p["tables"]):
        a = np.asarray(tbl) if layer is None else np.asarray(tbl)[layer]
        out[f"{prefix}.{list_name}.{k}.weight"] = _t(a)


def deeper_gcn_state_dict_from_jax(params: dict, state: dict, cfg
                                   ) -> Dict[str, torch.Tensor]:
    """`state_dict` of `models.DeeperGCN(cfg)` from the JAX `DeeperGCN(cfg)`'s
    (params, state) pytrees of numpy arrays; loads with `load_state_dict`.
    Fixed (not learned) t/p/y are buffers rebuilt from ``cfg``, not entries.
    Covers the linear and atom node encoders, the one-hot encoder, the
    model-level edge encoders ("one_time", "one_time_bond"), the per-layer
    ones ("per_layer", "bond"), the virtual node (`vn_emb` and the stacked
    `vn_mlps`) and the graph-level head."""
    out: Dict[str, torch.Tensor] = {}
    norm = str(cfg.norm).lower()
    if cfg.node_encoder == "atom":
        _encoder(out, "atom_encoder", params["encoder"], "atom_embedding_list")
    else:
        _linear(out, "node_features_encoder", params["encoder"], None)
    _linear(out, "graph_pred_linear" if cfg.graph_pooling else "node_pred_linear",
            params["pred"], None)
    if "one_hot_encoder" in params:
        _linear(out, "node_one_hot_encoder", params["one_hot_encoder"], None)
    if "edge_encoder" in params:
        bond = cfg.edge_mode == "one_time_bond"
        _encoder(out, "bond_encoder" if bond else "edge_encoder", params["edge_encoder"],
                 "bond_embedding_list")
    gp, gs = params["gcns"], state.get("gcns", {})
    for l in range(cfg.num_layers):
        _genconv(out, f"gcns.{l}", gp, gs, cfg, norm, l)
        _norm(out, f"norms.{l}", params["norms"], state.get("norms", {}), norm, l)
    if "vn_emb" in params:
        out["virtualnode_embedding.weight"] = _t(params["vn_emb"])
        vp, vs = params["vn_mlps"], state.get("vn_mlps", {})
        for l in range(cfg.num_layers - 1):
            for i, e in enumerate(_mlp_seq(2, norm, last_lin=False)):
                pre = f"mlp_virtualnode_list.{l}.{{}}"
                _linear(out, pre.format(e["lin"]), vp[i]["lin"], l)
                if "norm" in e:
                    _norm(out, pre.format(e["norm"]), vp[i]["norm"],
                          _entry(vs, i).get("norm", {}), norm, l)
    return out


def link_predictor_state_dict_from_jax(params: dict, state: dict
                                       ) -> Dict[str, torch.Tensor]:
    """`state_dict` of `models.LinkPredictor` from the JAX `LinkPredictor`'s
    (params, state) of numpy arrays: `lins.{i}` and, with a norm,
    `norms.{i}` (batch or layer, told apart by the running statistics)."""
    out: Dict[str, torch.Tensor] = {}
    for i, p in enumerate(params["lins"]):
        _linear(out, f"lins.{i}", p, None)
    states = state.get("norms", [])
    for i, p in enumerate(params.get("norms", [])):
        s = _entry(states, i)
        _norm(out, f"norms.{i}", p, s, "batch" if "mean" in s else "layer", ())
    return out


def rev_gcn_state_dict_from_jax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """`state_dict` of `models.RevGCN(cfg)` from the JAX `RevGCN(cfg)`'s params
    (numpy arrays). The JAX layers are stacked [L, G, ...] (one `lax.scan`
    over L couplings of G group functions); here they unstack into
    `gcns.{l}.Fms.{g}.norm.*` and `gcns.{l}.Fms.{g}.gcn.*`, the reference
    coupling's names without the `_fn` of its wrapper; ``conv`` "gen" or
    "gat"."""
    out: Dict[str, torch.Tensor] = {}
    norm = str(cfg.norm).lower()
    if "one_hot_encoder" in params:
        _linear(out, "node_one_hot_encoder", params["one_hot_encoder"], None)
    _linear(out, "node_features_encoder", params["encoder"], None)
    if "edge_encoder" in params:
        _linear(out, "edge_encoder", params["edge_encoder"], None)
    out["last_norm.weight"] = _t(params["last_norm"]["scale"])
    out["last_norm.bias"] = _t(params["last_norm"]["bias"])
    _linear(out, "node_pred_linear", params["pred"], None)
    layers = params["layers"]
    for l in range(cfg.num_layers):
        for g in range(cfg.group):
            pre = f"gcns.{l}.Fms.{g}"
            _norm(out, f"{pre}.norm", layers["norm"], {}, norm, (l, g))
            if cfg.conv == "gat":
                gat_conv_entries(out, f"{pre}.gcn", layers["gcn"], (l, g))
            else:
                _genconv(out, f"{pre}.gcn", layers["gcn"], {}, cfg, norm, (l, g))
    return out


def gat_conv_entries(out: Dict[str, torch.Tensor], prefix: str, p: dict, idx=()):
    """One PyG GATConv (`convs.sparse.GATConv`) under ``prefix``: JAX's w
    [in, H·D] is PyG's `gconv.weight` as it is, att [H, 2D] → [1, H, 2D],
    b → `gconv.bias`, a prelu slope → `unlinear.0.weight`; ``idx`` picks
    from the leading stacked axes. A norm (`unlinear.*`) is the caller's."""
    out[prefix + ".gconv.weight"] = _t(np.asarray(p["w"])[idx])
    out[prefix + ".gconv.att"] = _t(np.asarray(p["att"])[idx][None])
    if "b" in p:
        out[prefix + ".gconv.bias"] = _t(np.asarray(p["b"])[idx])
    if "prelu" in p:
        out[prefix + ".unlinear.0.weight"] = _t(np.asarray(p["prelu"])[idx])


def _gat(out: Dict[str, torch.Tensor], prefix: str, p: dict, idx=()):
    """One SymGATConv: JAX's fc/res_fc [in, H·D] → torch [H·D, in], attn
    [H, D] → [1, H, D]; ``idx`` picks from the leading stacked axes."""
    out[prefix + ".fc.weight"] = _t(np.asarray(p["fc"])[idx].T)
    for name in ("attn_l", "attn_r"):
        if name in p:
            out[f"{prefix}.{name}"] = _t(np.asarray(p[name])[idx][None])
    if "res_fc" in p:
        out[prefix + ".res_fc.weight"] = _t(np.asarray(p["res_fc"])[idx].T)


def rev_gat_state_dict_from_jax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """`state_dict` of `models.RevGAT(cfg)` from the JAX `RevGAT(cfg)`'s params
    (numpy arrays). The JAX middle layers are stacked [L−2, G, ...]; here they
    unstack into `convs.{l}.Fms.{g}.norm.*` and `convs.{l}.Fms.{g}.conv.*`,
    the names of `export_revgat` (`utils/import_torch.py:381-410`) without
    the `_fn.` of the reference's wrapper and without running statistics."""
    out: Dict[str, torch.Tensor] = {}
    last = cfg.n_layers - 1
    _gat(out, "convs.0", params["first"])
    mid = params["mid"]
    for l in range(cfg.n_layers - 2):
        for g in range(cfg.group):
            pre = f"convs.{l + 1}.Fms.{g}"
            out[pre + ".norm.weight"] = _t(np.asarray(mid["norm"]["scale"])[l, g])
            out[pre + ".norm.bias"] = _t(np.asarray(mid["norm"]["bias"])[l, g])
            _gat(out, pre + ".conv", mid["conv"], (l, g))
    _gat(out, f"convs.{last}", params["last"])
    out["norm.weight"] = _t(params["norm"]["scale"])
    out["norm.bias"] = _t(params["norm"]["bias"])
    out["bias_last.bias"] = _t(params["bias_last"])
    return out
