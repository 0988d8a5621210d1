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
from deep_gcns_torch_tpu_torch.parallel import comm
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
    (each rank's x and y drawn from its own seed)."""
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
         "hang": case_hang, "raise": case_raise}


def run_cases(rank, world, cases, device="cpu"):
    """Every case on this rank, in order; returns [(result, jax_loaded)]."""
    dev = torch.device("cpu") if device == "cpu" else torch.device("cuda", torch.cuda.current_device())
    out = [KINDS[c["kind"]](rank, world, dev, c) for c in cases]
    return {"results": out, "jax_free": "jax" not in sys.modules}
