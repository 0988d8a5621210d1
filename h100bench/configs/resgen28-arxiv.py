"""ResGEN-28 through the port's `apps/ogbn_arxiv.py` on the gather route (no
reorder, no band): the app adapter the harness drives, the weight init, the
FLOP count of `mfu_pct` and the kernel calls of a step and of an
evaluation."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def app_argv(cfg: Dict) -> List[str]:
    """The app's flags for this configuration."""
    argv = ["--num_layers", str(cfg["num_layers"]),
            "--hidden_channels", str(cfg["hidden_channels"]), "--block", cfg["block"],
            "--gcn_aggr", cfg["gcn_aggr"], "--t", str(cfg["t"]), "--norm", cfg["norm"],
            "--mlp_layers", str(cfg["mlp_layers"]), "--dropout", str(cfg["dropout"]),
            "--optimizer", cfg["optimizer"], "--lr", str(cfg["lr"]),
            "--num_classes", str(cfg["num_classes"]), "--compute_dtype", cfg["compute_dtype"],
            "--reorder", "none", "--band", "off"]
    if cfg["learn_t"]:
        argv.append("--learn_t")
    return argv


class Job:
    """The app's DeeperGCN and optimizer on the whole graph: `train` is
    `apps.ogbn_arxiv.train_step` on the training nodes with the dropout
    stream from the harness's seed, `predict` the app's `predict` (the
    argmax of an evaluation forward). The app does no host work between
    epochs."""

    def __init__(self, cfg: Dict, data, device: torch.device, drop_seed: int):
        from deep_gcns_torch_tpu_torch.apps import ogbn_arxiv as app
        from deep_gcns_torch_tpu_torch.utils.optim import make_optimizer

        self.app, self.data, self.device = app, data, device
        self.args = args = app.get_args(app_argv(cfg))
        self.model = app.build_model(args, data.in_dim).to(device)
        require_per_receiver_shift(self.model.gcns[0], data.graph, cfg["hidden_channels"])
        self.opt = make_optimizer(args.optimizer, self.model.parameters(), args.lr,
                                  args.weight_decay)
        self.gen = torch.Generator(device=device).manual_seed(drop_seed)
        self.train_mask = data.mask("train")

    def host(self, epoch: int):
        return None

    def train(self, a) -> torch.Tensor:
        return self.app.train_step(self.model, self.opt, self.data.graph,
                                   self.data.labels_dev, self.train_mask, self.gen)

    def predict(self) -> torch.Tensor:
        return self.app.predict(self.model, self.data.graph)

    def accuracies(self, pred: np.ndarray) -> Dict[str, float]:
        return self.app.split_accuracies(pred, self.data.labels, self.data.splits)


# a score spread of a channel far past 87/t, where exp underflows in float32
# unless each receiver's softmax is shifted by its own maximum; a power of
# two, and the other inputs multiples of 1/16, so that bfloat16 holds them
PROBE_PEAK = 8192.0
# the probe asks whether receivers keep their weights, not how precisely:
# a lost receiver reads 0 or NaN against answers in [1/2, 1]
PROBE_RTOL = 1e-2


def require_per_receiver_shift(conv, g, c: int) -> None:
    """Stop with an error, before any epoch, where ``conv``'s aggregation
    cannot run this configuration: ResGEN-28's residual stream spreads a
    channel's scores past 87/t, and a softmax shifted by one maximum a
    channel (not a receiver) then loses every receiver whose senders are
    all small, so that the run's answers would be wrong. The probe puts
    one sender's channel 0 at ``PROBE_PEAK`` and every other node's in
    [1/2, 1), runs the conv's forward on ``g``, reads the aggregation m
    off its MLP's input x + m, and holds channel 0 against the per-receiver
    softmax of the reference's scatter_softmax, in float64."""
    n, n_pad = g.n_node, g.num_nodes_padded
    dev = g.senders.device
    x = 0.5 + (torch.arange(n_pad, device=dev, dtype=torch.float32) % 8 / 16)
    x = x[:, None].repeat(1, c)
    v = g.edge_mask
    s, r = g.senders[v].long(), g.receivers[v].long()
    x[s[0], 0] = PROBE_PEAK
    seen = []
    hook = conv.mlp.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    try:
        with torch.no_grad():
            conv(x, g)
    finally:
        hook.remove()
    with torch.no_grad():
        out = (seen[0].float() - x)[:n, 0].double()
        m = torch.relu(x[:, 0].double()[s]) + conv.eps
        z = float(conv.t) * m
        top = torch.full((n_pad,), -math.inf, dtype=torch.float64, device=dev)
        top = top.scatter_reduce(0, r, z, "amax")
        w = torch.exp(z - top[r])
        num = torch.zeros(n_pad, dtype=torch.float64, device=dev).index_add_(0, r, w * m)
        den = torch.zeros(n_pad, dtype=torch.float64, device=dev).index_add_(0, r, w)
        ref = (num / den)[:n]
        lost = ~((out - ref).abs() <= PROBE_RTOL * ref.abs()) & (den[:n] > 0)
    if bool(lost.any()):
        raise RuntimeError(
            f"this program cannot run resgen28-arxiv: GENConv's aggregation answers "
            f"{int(lost.sum())} of {n} receivers wrongly where a channel's scores spread "
            f"past 87/t (it needs each receiver's softmax shifted by its own maximum)")


def init_weights(shapes: Dict[str, tuple], gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """PyTorch's default inits, as the published model takes them: every
    Linear weight and bias U(-1/sqrt(in), 1/sqrt(in)) from one draw on the
    generator's device (in the order of ``shapes``); norm weights 1, norm
    biases 0."""
    def is_linear(k):
        return not k.startswith("norms.")

    def fan_in(k):
        return shapes[k.rsplit(".", 1)[0] + ".weight"][1]

    drawn = [k for k in shapes if is_linear(k)]
    u = torch.rand(sum(math.prod(shapes[k]) for k in drawn), generator=gen, device=gen.device)
    out, off = {}, 0
    for k in shapes:
        size = math.prod(shapes[k])
        if is_linear(k):
            bound = 1.0 / math.sqrt(fan_in(k))
            out[k] = ((u[off:off + size] * 2.0 - 1.0) * bound).reshape(shapes[k])
            off += size
        else:
            fill = 1.0 if k.endswith("weight") else 0.0
            out[k] = torch.full(shapes[k], fill, device=gen.device)
    return out


# float32 operations per (edge, channel) of the aggregation, as the model
# needs them: forward the message relu(x) + eps (2), its score (1), the
# shift (1), exp (1), the weighted message (1) and the two sums (2);
# backward the weight again (shift and exp, 2), its product with the
# cotangent (1), relu's mask (1) and the sum into the sender (1)
EDGE_CH_FWD, EDGE_CH_BWD = 8, 5


def flops(cfg: Dict, n: int, e: int) -> Dict[str, float]:
    """Model FLOPs of one train step and one evaluation: the encoder, each
    conv's MLP and the head as 2·M·K·N products (the backward two products
    a Linear, the encoder no dX) and the aggregation's arithmetic over the
    e edges of each conv. Norms, relu and dropout do not count."""
    c, k, fin, L = cfg["hidden_channels"], cfg["num_classes"], cfg["in_channels"], \
        cfg["num_layers"]
    enc, mlp, head = 2 * n * fin * c, 2 * n * c * c, 2 * n * c * k
    fwd = enc + L * (mlp + e * c * EDGE_CH_FWD) + head
    bwd = enc + L * (2 * mlp + e * c * EDGE_CH_BWD) + 2 * head
    return {"train_step": float(fwd + bwd), "predict": float(fwd)}


def kernel_calls(cfg: Dict, g) -> Dict[str, Dict[str, List[Dict]]]:
    """The port's kernel calls of one train step and one evaluation on graph
    ``g``: the gather route's K2 once a conv forward and K4's gather form
    once a conv backward, over [N_pad, C] node tables and the graph's
    edges."""
    nb = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    shape = {"n": g.num_nodes_padded, "e": g.n_edge, "e_pad": g.num_edges_padded,
             "c": cfg["hidden_channels"], "bytes": nb, "ee": False, "gw": cfg["learn_t"]}
    L = cfg["num_layers"]
    return {"train_step": {"K2": [shape] * L, "K4": [shape] * L},
            "predict": {"K2": [shape] * L}}
