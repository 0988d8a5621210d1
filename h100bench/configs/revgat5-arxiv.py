"""RevGAT-5L through the port's `apps/ogbn_arxiv_dgl.py` (teacher mode, label
reuse): the app adapter the harness drives, the weight init, the FLOP count
of `mfu_pct` and the kernel calls of a step and of an evaluation."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def app_argv(cfg: Dict) -> List[str]:
    """The app's flags for this configuration."""
    argv = ["--n_layers", str(cfg["n_layers"]), "--n_hidden", str(cfg["n_hidden"]),
            "--n_heads", str(cfg["n_heads"]), "--group", str(cfg["group"]),
            "--dropout", str(cfg["dropout"]), "--input_drop", str(cfg["input_drop"]),
            "--edge_drop", str(cfg["edge_drop"]), "--lr", str(cfg["lr"]),
            "--warmup_epochs", str(cfg["warmup_epochs"]),
            "--num_classes", str(cfg["num_classes"]),
            "--mask_rate", str(cfg["mask_rate"]), "--n_label_iters", str(cfg["n_label_iters"]),
            "--compute_dtype", cfg["compute_dtype"]]
    if cfg["use_attn_dst"]:
        argv.append("--use_attn_dst")
    if not cfg["use_symmetric_norm"]:
        argv.append("--no_norm_adj")
    argv.append("--use_labels" if cfg["use_labels"] else "--no-use_labels")
    return argv


class Job:
    """The app's RevGAT, RMSprop with its warm-up schedule, and the app's
    per-epoch split of the training nodes into label input and supervision
    (`host`), drawn from a numpy generator of the harness's seed. `train` is
    `apps.ogbn_arxiv_dgl.train_step`; `predict` the app's `predict` with the
    training nodes' labels as input, as the app evaluates."""

    def __init__(self, cfg: Dict, data, device: torch.device, drop_seed: int):
        from deep_gcns_torch_tpu_torch.apps import ogbn_arxiv_dgl as app
        from deep_gcns_torch_tpu_torch.utils.optim import linear_schedule, make_optimizer

        self.app, self.data, self.device = app, data, device
        self.args = args = app.get_args(app_argv(cfg))
        self.model = app.build_model(args, data.in_dim).to(device)
        self.opt = make_optimizer("rmsprop", self.model.parameters(), 1.0)
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.opt, linear_schedule(args.lr / 50, args.lr, args.warmup_epochs))
        self.gen = torch.Generator(device=device).manual_seed(drop_seed)
        k = args.num_classes
        self.onehot = (torch.nn.functional.one_hot(data.labels_dev, k).float()
                       if args.use_labels else None)
        self.train_idx = np.asarray(data.splits["train"])
        self.eval_mask = data.mask("train")
        self.rng = np.random.default_rng([int(data.seed), 3])
        self.label_splits: List[np.ndarray] = []

    def host(self, epoch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The app's per-epoch split (`apps/ogbn_arxiv_dgl.py` main loop): a
        random half of the training nodes as label input, the rest
        supervised; two masks uploaded and the input features built."""
        n_pad = self.data.n_pad
        sel = self.rng.random(len(self.train_idx)) < self.args.mask_rate
        self.label_splits.append(sel)
        lm = torch.zeros(n_pad, dtype=torch.bool)
        lm[torch.from_numpy(self.train_idx[sel])] = True
        sm = torch.zeros(n_pad, dtype=torch.bool)
        sm[torch.from_numpy(self.train_idx[~sel])] = True
        lm, sm = lm.to(self.device), sm.to(self.device)
        return self.app.make_features(self.data.graph.x, self.onehot, lm), sm

    def train(self, a) -> torch.Tensor:
        feat, sm = a
        return self.app.train_step(self.model, self.opt, self.sched, self.data.graph, feat,
                                   self.data.labels_dev, sm, self.gen)

    def predict(self) -> torch.Tensor:
        return self.app.predict(self.model, self.data.graph, self.data.graph.x, self.onehot,
                                self.eval_mask, self.args.n_label_iters).argmax(-1)

    def accuracies(self, pred: np.ndarray) -> Dict[str, float]:
        from deep_gcns_torch_tpu_torch.utils.metrics import accuracy

        return {k: accuracy(pred[v], self.data.labels[v]) for k, v in self.data.splits.items()}


def _xavier_std(k: str, shape: tuple) -> float:
    """std = sqrt(2)·sqrt(2/(fan_in + fan_out)): fc and res_fc [H·D, in] have
    fans (in, H·D), attn_l [1, H, D] has (D, 1)."""
    fan_in, fan_out = (shape[-1], 1) if k.endswith("attn_l") else (shape[1], shape[0])
    return math.sqrt(2.0) * math.sqrt(2.0 / (fan_in + fan_out))


def init_weights(shapes: Dict[str, tuple], gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """fc, res_fc and attn_l xavier-normal with gain sqrt(2) from one draw on
    the generator's device; norm weights 1, norm biases and the last bias 0."""
    drawn = [k for k in shapes if k.endswith(("weight", "attn_l")) and ".norm." not in k
             and not k.startswith("norm.")]
    z = torch.randn(sum(math.prod(shapes[k]) for k in drawn), generator=gen, device=gen.device)
    out, off = {}, 0
    for k in shapes:
        size = math.prod(shapes[k])
        if k in drawn:
            out[k] = (z[off:off + size] * _xavier_std(k, shapes[k])).reshape(shapes[k])
            off += size
        else:
            fill = 1.0 if k.endswith("weight") else 0.0
            out[k] = torch.full(shapes[k], fill, device=gen.device)
    return out


def _convs(cfg: Dict) -> List[Tuple[int, int, int]]:
    """(in, heads, head width) of the convs of one forward, in order."""
    h, d, G = cfg["n_heads"], cfg["n_hidden"], cfg["group"]
    fin = cfg["in_channels"] + (cfg["num_classes"] if cfg["use_labels"] else 0)
    mid = [(h * d // G, h, d // G)] * ((cfg["n_layers"] - 2) * G)
    return [(fin, h, d)] + mid + [(h * d, 1, cfg["num_classes"])]


# operations per (edge, head): score (leaky relu), shift, exp, the
# denominator's sum; per (edge, channel): the weighted message and its sum.
# The backward per (edge, head): the weight's cotangent, the softmax's and
# the leaky relu's chain, the sum; per (edge, channel): the dot with the
# cotangent and the weighted cotangent with its sum.
EDGE_HEAD_FWD, EDGE_CH_FWD, EDGE_HEAD_BWD, EDGE_CH_BWD = 4, 2, 4, 4


def flops(cfg: Dict, n: int, e: int) -> Dict[str, float]:
    """Model FLOPs of one train step and one evaluation (1 + n_label_iters
    forwards): per conv the fc and res_fc products (2·M·K·N each; the
    backward two products a Linear, the first conv no dX) and the attention
    arithmetic over the edges a pass aggregates, (1 − edge_drop)·e in
    training and e in the evaluation. The reversible recomputation does not
    count."""
    keep = 1.0 - cfg["edge_drop"]
    fwd_t = fwd_e = bwd = 0.0
    for i, (fin, h, d) in enumerate(_convs(cfg)):
        mm = 2 * (2 * n * fin * h * d)
        att = h * EDGE_HEAD_FWD + h * d * EDGE_CH_FWD
        fwd_t += mm + keep * e * att
        fwd_e += mm + e * att
        bwd += (mm if i == 0 else 2 * mm) + keep * e * (h * EDGE_HEAD_BWD + h * d * EDGE_CH_BWD)
    return {"train_step": fwd_t + bwd, "predict": (1 + cfg["n_label_iters"]) * fwd_e}


def kernel_calls(cfg: Dict, g) -> Dict[str, Dict[str, List[Dict]]]:
    """The port's kernel calls of one train step and one evaluation on graph
    ``g`` (sender-only scores). The CSC route: K5 a conv forward, K6 a conv
    backward, on the packed table [msg | el] padded to a multiple of 8
    columns; a step runs each group conv forward twice (the reversible
    backward evaluates it again) and backward once."""
    nb = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    n_pad, e = g.num_nodes_padded, g.n_edge
    keep = 1.0 - cfg["edge_drop"]
    convs = _convs(cfg)
    ends, mid = [convs[0], convs[-1]], convs[1:-1]
    n_eval = 1 + cfg["n_label_iters"]

    def shape(conv, work):
        _, h, d = conv
        p = h * d + h
        return {"n": n_pad, "e": e, "e_work": work, "p": p + (-p) % 8, "h": h, "d": d,
                "bytes": nb, "drop": work < e}

    step = {"K5": [shape(c, keep * e) for c in ends + mid + mid],
            "K6": [shape(c, keep * e) for c in ends + mid]}
    return {"train_step": step, "predict": {"K5": [shape(c, e) for c in convs] * n_eval}}
