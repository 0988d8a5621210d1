"""Rank-side programs of the parallel tests, run by
`deep_gcns_torch_tpu_torch.parallel.launch` in spawned ranks. This module
imports torch and the port only, so a rank never loads JAX; every function
returns numpy arrays (and `jax_free` reports whether JAX got in).

A case is a dict with a ``kind`` and its inputs (host shards, numpy
weights as a `state_dict`, configs as keyword dicts); `run_cases` runs a
list of them in one spawn, in order, on every rank."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from deep_gcns_torch_tpu_torch.models import DeeperGCNConfig, RevGCNConfig
from deep_gcns_torch_tpu_torch.parallel import comm, make_grid
from deep_gcns_torch_tpu_torch.parallel.data_parallel import cluster_dp_train_step
from deep_gcns_torch_tpu_torch.parallel.spatial import (SpatialDeeperGCN, masked_bce_sum,
                                                        masked_nll_sum, spatial_train_step)
from deep_gcns_torch_tpu_torch.parallel.spatial_rev import SpatialRevGCN


def _np_state(model):
    return {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}


def _load(model, sd):
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                          strict=False)
    return model


def _t(a, dev, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t if dtype is None else t.to(dtype)


def case_adjoint(rank, world, dev, case):
    """⟨A x, y⟩ and ⟨x, Aᵀ y⟩ summed over the ranks for every collective A
    (each rank's x and y drawn from its own seed). With ``grid`` (D, T) the
    collectives run over each axis's subgroups of a D × T grid instead
    (`_adjoint_grid`)."""
    if case.get("grid"):
        return _adjoint_grid(rank, dev, case)
    rng = np.random.default_rng(100 + rank)
    rows, c = case["rows"], case["c"]
    x0 = rng.standard_normal((rows, c)).astype(np.float32)
    out = {}
    ops = {f"ppermute{k}": (lambda x, k=k: comm.ppermute(x, k)) for k in range(1, world)}
    ops["all_gather"] = comm.all_gather
    ops["all_reduce_sum"] = comm.all_reduce_sum
    for name, op in ops.items():
        x = _t(x0, dev).requires_grad_(True)
        ax = op(x)
        y = _t(rng.standard_normal(tuple(ax.shape)).astype(np.float32), dev)
        (ax * y).sum().backward()
        lhs = comm.all_reduce_sum((ax.detach() * y).sum())
        rhs = comm.all_reduce_sum((x.detach() * x.grad).sum())
        out[name] = (float(lhs), float(rhs))
    return out


def _adjoint_grid(rank, dev, case):
    """For each axis ("gp", "tp") of a ``grid`` and each collective over
    that axis's group: (⟨A x, y⟩, ⟨x, Aᵀ y⟩), summed over the group's ranks.
    `all_reduce_replicated` is the adjoint on replicated outputs: its y is
    drawn alike on the group's ranks and ⟨A x, y⟩ counts once."""
    grid = make_grid(*case["grid"])
    rows, c = case["rows"], case["c"]
    out = {}
    for axis, group, size, other in (("gp", grid.gp_group, grid.gp_size, grid.tp_index),
                                     ("tp", grid.tp_group, grid.tp_size, grid.gp_index)):
        rng = np.random.default_rng(100 + rank)
        x0 = rng.standard_normal((rows, c)).astype(np.float32)
        ops = {f"ppermute{k}": (lambda x, k=k: comm.ppermute(x, k, group))
               for k in range(1, size)}
        ops["all_gather"] = lambda x: comm.all_gather(x, group)
        ops["psum_scatter"] = lambda x: comm.psum_scatter(x, 1, group)
        ops["all_reduce_sum"] = lambda x: comm.all_reduce_sum(x, group)
        ops["all_reduce_replicated"] = lambda x: comm.all_reduce_replicated(x, group)
        for name, op in ops.items():
            x = _t(x0, dev).requires_grad_(True)
            ax = op(x)
            replicated = name == "all_reduce_replicated"
            y_rng = np.random.default_rng(7 + other) if replicated else rng
            y = _t(y_rng.standard_normal(tuple(ax.shape)).astype(np.float32), dev)
            (ax * y).sum().backward()
            lhs = (ax.detach() * y).sum()
            lhs = lhs if replicated else comm.all_reduce_sum(lhs, group)
            rhs = comm.all_reduce_sum((x.detach() * x.grad).sum(), group)
            out[f"{axis}:{name}"] = (float(lhs), float(rhs))
    return out


def _reset_launches():
    """The launch counters of the kernels on the spatial routes, set to 0."""
    from deep_gcns_torch_tpu_torch.ops import band, spmm_cuda

    counted = {"K1": (spmm_cuda.csr_seg_sum, "launches"),
               "K2": (spmm_cuda.softmax_agg, "launches"),
               "K2 msgs": (spmm_cuda.softmax_agg_msgs, "launches"),
               "K3": (band.band_call, "launches")}
    for fn, attr in counted.values():
        setattr(fn, attr, 0)
    return counted


def _deeper(case, dev):
    model = SpatialDeeperGCN(DeeperGCNConfig(**case["cfg"]), exchange=case["exchange"])
    return _load(model, case["state"]).to(dev)


def case_deeper(rank, world, dev, case):
    """SpatialDeeperGCN on this rank's shard: eval logits, and with ``lr`` one
    SGD step (its loss, the updated state and the train-mode logits)."""
    sh = case["shards"].rank(rank, dev)
    model = _deeper(case, dev)
    x = _t(case["x"][rank], dev)
    nf = None if case.get("nf") is None else _t(case["nf"][rank], dev)
    out = {}
    if case.get("lr") is None:
        model.eval()
        counted = _reset_launches()
        with torch.no_grad():
            out["logits"] = model(x, sh, node_feats=nf).float().cpu().numpy()
        out["launches"] = {k: getattr(fn, attr) for k, (fn, attr) in counted.items()}
        return out
    opt = torch.optim.SGD(model.parameters(), lr=case["lr"])
    lab = _t(case["labels"][rank], dev)
    mask = _t(case["mask"][rank], dev)
    loss_fn = masked_bce_sum if case.get("loss") == "bce" else masked_nll_sum
    loss = spatial_train_step(model, opt, sh, x, lab, mask, loss_fn, node_feats=nf,
                              max_grad_norm=case.get("clip"))
    out["loss"] = float(loss)
    out["state"] = _np_state(model)
    return out


def case_rev(rank, world, dev, case):
    """SpatialRevGCN on this rank's shard: eval logits, or one SGD step."""
    sh = case["shards"].rank(rank, dev)
    model = _load(SpatialRevGCN(RevGCNConfig(**case["cfg"]), exchange=case["exchange"]),
                  case["state"]).to(dev)
    x = _t(case["x"][rank], dev)
    nf = _t(case["nf"][rank], dev)
    out = {}
    if case.get("lr") is None:
        model.eval()
        with torch.no_grad():
            out["logits"] = model(x, sh, node_feats=nf).float().cpu().numpy()
        return out
    opt = torch.optim.SGD(model.parameters(), lr=case["lr"])
    loss = spatial_train_step(model, opt, sh, x, _t(case["labels"][rank], dev),
                              _t(case["mask"][rank], dev), masked_nll_sum, node_feats=nf)
    out["loss"] = float(loss)
    out["state"] = _np_state(model)
    return out


def case_dp(rank, world, dev, case):
    """One cluster-DP step on this rank's cluster (a host `Graph`) of a
    RevGCN or a DeeperGCN."""
    from deep_gcns_torch_tpu_torch.models import DeeperGCN, RevGCN
    from deep_gcns_torch_tpu_torch.utils.loss import cross_entropy

    g = case["graphs"][rank].to(dev)
    model = (RevGCN(RevGCNConfig(**case["cfg"])) if case["model"] == "rev"
             else DeeperGCN(DeeperGCNConfig(**case["cfg"])))
    model = _load(model, case["state"]).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=case["lr"])
    loss = cluster_dp_train_step(model, opt, g, g.x, _t(case["labels"][rank], dev),
                                 g.node_mask, cross_entropy)
    return {"loss": float(loss), "state": _np_state(model)}


def _np_full_state(model):
    """The gathered single-process `state_dict` of a TP model (a collective)."""
    return {k: v.float().cpu().numpy() for k, v in model.single_state_dict().items()}


def case_tp_deeper(rank, world, dev, case):
    """`TPDeeperGCN` with its channels over all ``world`` ranks on the whole
    graph: eval logits, or with ``lr`` one SGD step (loss and the gathered
    updated `state_dict`)."""
    from deep_gcns_torch_tpu_torch.parallel import TPDeeperGCN, tp_forward, tp_train_step
    from deep_gcns_torch_tpu_torch.utils.loss import cross_entropy

    grid = make_grid(1, world)
    g = case["graph"].to(dev)
    model = TPDeeperGCN(DeeperGCNConfig(**case["cfg"]), grid.tp_group).to(dev)
    model.load_single_state_dict({k: torch.from_numpy(np.asarray(v))
                                  for k, v in case["state"].items()})
    if case.get("lr") is None:
        return {"logits": tp_forward(model, g, g.x).float().cpu().numpy()}
    opt = torch.optim.SGD(model.parameters(), lr=case["lr"])
    loss = tp_train_step(model, opt, g, g.x, _t(case["labels"], dev), g.node_mask,
                         cross_entropy)
    return {"loss": float(loss), "state": _np_full_state(model)}


def _rev_inputs(case, dev):
    g = case["graph"].to(dev)
    return g, _t(case["species"], dev), _t(case["nf"], dev)


def case_tp_rev(rank, world, dev, case):
    """`TPRevGCN` over all ``world`` ranks: eval logits, or one SGD step with
    the given full dropout masks (``masks``: shared [N, C] and the head's
    float mask, each split group-major here), or with ``mask_seed`` one
    step whose masks `make_tp_mask` draws, beside the single-process
    RevGCN's step on the same generator seed."""
    from deep_gcns_torch_tpu_torch.models import RevGCN
    from deep_gcns_torch_tpu_torch.parallel import TPRevGCN, tp_rev_forward, tp_rev_train_step
    from deep_gcns_torch_tpu_torch.parallel.tensor import split_grouped
    from deep_gcns_torch_tpu_torch.utils.loss import cross_entropy

    grid = make_grid(1, world)
    cfg = RevGCNConfig(**case["cfg"])
    g, sp, nf = _rev_inputs(case, dev)
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in case["state"].items()}
    model = TPRevGCN(cfg, grid.tp_group).to(dev)
    model.load_single_state_dict(sd)
    if case.get("lr") is None:
        return {"logits": tp_rev_forward(model, g, sp, nf).float().cpu().numpy()}
    opt = torch.optim.SGD(model.parameters(), lr=case["lr"])
    lab = _t(case["labels"], dev)
    out = {}
    masks = gen = None
    if case.get("masks") is not None:
        shared, head = (torch.from_numpy(np.asarray(m)) for m in case["masks"])
        masks = (split_grouped(shared, world, 1, cfg.group)[rank].to(dev),
                 split_grouped(head > 0, world, 1, cfg.group)[rank].to(dev))
    if case.get("mask_seed") is not None:
        gen = torch.Generator(device=dev).manual_seed(case["mask_seed"])
        single = RevGCN(cfg).to(dev)
        single.load_state_dict(sd)
        s_opt = torch.optim.SGD(single.parameters(), lr=case["lr"])
        single.train()
        s_loss = cross_entropy(single(sp, g, node_feats=nf,
                                      generator=torch.Generator(device=dev).manual_seed(
                                          case["mask_seed"])), lab, g.node_mask)
        s_loss.backward()
        s_opt.step()
        out["single"] = (float(s_loss.detach()), _np_state(single))
    loss = tp_rev_train_step(model, opt, g, sp, lab, g.node_mask, cross_entropy, node_feats=nf,
                             generator=gen, masks=masks)
    out.update(loss=float(loss), state=_np_full_state(model))
    return out


def case_spatial_tp(rank, world, dev, case):
    """`SpatialTPDeeperGCN` on a ``grid`` (D, T) with D·T = ``world``: eval
    logits of this rank's node shard, or one SGD step."""
    from deep_gcns_torch_tpu_torch.parallel import (SpatialTPDeeperGCN, spatial_tp_forward,
                                                    spatial_tp_train_step)

    grid = make_grid(*case["grid"])
    sh = case["shards"].rank(grid.gp_index, dev)
    model = SpatialTPDeeperGCN(DeeperGCNConfig(**case["cfg"]), grid, exchange=case["exchange"])
    model = model.to(dev)
    model.load_single_state_dict({k: torch.from_numpy(np.asarray(v))
                                  for k, v in case["state"].items()})
    x = _t(case["x"][grid.gp_index], dev)
    if case.get("lr") is None:
        return {"logits": spatial_tp_forward(model, sh, x).float().cpu().numpy()}
    opt = torch.optim.SGD(model.parameters(), lr=case["lr"])
    loss = spatial_tp_train_step(model, opt, sh, x, _t(case["labels"][grid.gp_index], dev),
                                 _t(case["mask"][grid.gp_index], dev), masked_nll_sum)
    return {"loss": float(loss), "state": _np_full_state(model)}


def case_hang(rank, world, dev, case):
    """Rank 1 never joins the all-reduce that rank 0 waits on."""
    if rank == 1:
        time.sleep(case["sleep"])
        return {}
    comm.all_reduce_sum(torch.ones(3, device=dev))
    return {}


def case_raise(rank, world, dev, case):
    if rank == case["rank"]:
        raise ValueError(case["message"])
    return {}


KINDS = {"adjoint": case_adjoint, "deeper": case_deeper, "rev": case_rev, "dp": case_dp,
         "tp_deeper": case_tp_deeper, "tp_rev": case_tp_rev, "spatial_tp": case_spatial_tp,
         "hang": case_hang, "raise": case_raise}


def run_cases(rank, world, cases, device="cpu"):
    """Every case on this rank, in order; returns [(result, jax_loaded)]."""
    dev = torch.device("cpu") if device == "cpu" else torch.device("cuda", torch.cuda.current_device())
    out = [KINDS[c["kind"]](rank, world, dev, c) for c in cases]
    return {"results": out, "jax_free": "jax" not in sys.modules}
