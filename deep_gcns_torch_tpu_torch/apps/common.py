"""Shared scaffolding of the apps (the port's copy of `examples/common.py`):
the common flags, the DeeperGCN flag surface, the optimizer of
``--optimizer``, the spatial flags, an epoch timer and the experiment
directory, which the apps write only with ``--save_ckpt``.

The parser takes ``--device cuda|cpu`` in place of the JAX apps'
``--platform``; the entry points run on the card unless asked for the CPU.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Iterable, Optional, Tuple

import torch

from ..utils.logger import ScalarLogger, create_exp_dir, setup_logging
from ..utils.optim import make_optimizer as _make_optimizer

OPTIMIZERS = ("adam", "radam", "adamw_ref", "adamw")


def add_optimizer_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """``--optimizer`` and ``--weight_decay`` (`examples/common.py:36-43`)."""
    p.add_argument("--optimizer", type=str, default="adam", choices=OPTIMIZERS,
                   help="adam matches the reference apps (torch.optim.Adam); radam / "
                        "adamw_ref are the reference's own utils/optim.py rules; adamw "
                        "is AdamW whose first update has lr 0")
    p.add_argument("--weight_decay", type=float, default=0.0)
    return p


def base_parser(description: str) -> argparse.ArgumentParser:
    """The flags every app shares (`examples/common.py:17-44`)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--data_root", type=str, default="data/")
    p.add_argument("--exp_root", type=str, default="runs/")
    p.add_argument("--exp_name", type=str, default="exp")
    p.add_argument("--synthetic", action="store_true",
                   help="run on synthetic data (no dataset download available)")
    p.add_argument("--synthetic_nodes", type=int, default=4096)
    p.add_argument("--pretrained_model", type=str, default="",
                   help="checkpoint prefix to score (the test scripts)")
    p.add_argument("--save_ckpt", action="store_true",
                   help="write {exp}/ckpt_best at every new best score")
    return add_optimizer_flags(p)


def add_deeper_gcn_flags(p: argparse.ArgumentParser, *, num_layers=28, hidden=128,
                         norm="batch", t=1.0, aggr="softmax") -> argparse.ArgumentParser:
    """The reference's DeeperGCN flag surface (`examples/common.py:66-91`).
    As in the JAX apps that use it, ``--compute_dtype`` and ``--remat`` are
    parsed and not passed to the model: those apps run in float32."""
    p.add_argument("--num_layers", type=int, default=num_layers)
    p.add_argument("--hidden_channels", type=int, default=hidden)
    p.add_argument("--block", type=str, default="res+")
    p.add_argument("--conv", type=str, default="gen")
    p.add_argument("--gcn_aggr", type=str, default=aggr)
    p.add_argument("--norm", type=str, default=norm)
    p.add_argument("--mlp_layers", type=int, default=1)
    p.add_argument("--t", type=float, default=t)
    p.add_argument("--learn_t", action="store_true")
    p.add_argument("--p", type=float, default=1.0)
    p.add_argument("--learn_p", action="store_true")
    p.add_argument("--y", type=float, default=0.0)
    p.add_argument("--learn_y", action="store_true")
    p.add_argument("--msg_norm", action="store_true")
    p.add_argument("--learn_msg_scale", action="store_true")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--remat", action="store_true")
    return p


def add_spatial_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Edge-partitioned spatial and tensor parallelism (`examples/common.py:
    94-112`): ``--spatial N`` trains the full graph exactly on N ranks
    (`apps/spatial_common.py`) with the boundary ``--exchange``; ``--tp T``
    splits the channels over T ranks (ogbn-arxiv; the other apps refuse
    ``--tp`` > 1, `spatial_common.refuse_tp`)."""
    p.add_argument("--spatial", type=int, default=1,
                   help="partition the graph's edges over N ranks (full-graph training)")
    p.add_argument("--exchange", type=str, default="auto",
                   choices=["auto", "halo", "allgather"],
                   help="boundary rows by per-offset halo permutes or a full all-gather; "
                        "auto picks the fewer rows shipped")
    p.add_argument("--tp", type=int, default=1,
                   help="split the hidden channels over T ranks (tensor parallelism)")
    return p


def make_optimizer(args, params: Iterable[torch.nn.Parameter],
                   lr: Optional[float] = None) -> torch.optim.Optimizer:
    """The optimizer of ``--optimizer`` at ``--lr`` (or ``lr``) and
    ``--weight_decay`` (`examples/common.py:47-62`)."""
    return _make_optimizer(getattr(args, "optimizer", "adam"), params,
                           args.lr if lr is None else lr, getattr(args, "weight_decay", 0.0))


def setup_experiment(args, name: str) -> Tuple[str, logging.Logger, ScalarLogger]:
    """`{exp_root}/{name}-{exp_name}-…` with its log file and scalar log."""
    exp = create_exp_dir(args.exp_root, f"{name}-{args.exp_name}")
    logger = setup_logging(exp)
    logger.info("args: %s", vars(args))
    return exp, logger, ScalarLogger(exp)


class EpochTimer:
    """Host seconds between laps (`examples/common.py:170-184`)."""

    def __init__(self):
        self.t0 = time.time()
        self.times = []

    def lap(self) -> float:
        t = time.time()
        self.times.append(t - self.t0)
        self.t0 = t
        return self.times[-1]


def open_experiment(args, name: str):
    """With ``--save_ckpt``, `setup_experiment`'s (directory, logger, scalar
    log); without it (None, None, None): the apps write nothing under
    ``--exp_root`` unless asked to."""
    if not getattr(args, "save_ckpt", False):
        return None, None, None
    return setup_experiment(args, name)


def report(logger: Optional[logging.Logger], msg: str):
    """One line to the experiment's log (which echoes it), else to stdout."""
    if logger is not None:
        logger.info(msg)
    else:
        print(msg, flush=True)
