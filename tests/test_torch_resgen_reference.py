"""ResGEN-28 through the port's DeeperGCN, built by `apps/ogbn_arxiv.py` at
its published defaults (28 res+ layers of 128 channels, softmax_sg at
t = 0.1, batch norm, a one-layer MLP) with dropout 0, on the CPU, against
the plain reference `tests/torch_ref_resgen.py`: the logits, the loss and
every leaf's gradient, on a 300-node power-law graph made undirected with
self-loops, with seeded random weights (the norms' too).

The second case scales the input by 10^4: conv 0's messages then spread past
870 in every channel (scores past 87 at t = 0.1), where one global shift a
channel, as the JAX package takes it, leaves every weight of a receiver
whose senders are all small at 0 in float32."""

import numpy as np
import pytest
import torch

from deep_gcns_torch_tpu_torch.apps import ogbn_arxiv as app
from deep_gcns_torch_tpu_torch.data.synthetic import powerlaw_community_edges
from deep_gcns_torch_tpu_torch.graph import add_self_loops, build_graph, to_undirected
from deep_gcns_torch_tpu_torch.utils.loss import cross_entropy

import torch_ref_resgen as ref
from torch_budget import budget  # noqa: F401

N, C_IN, K = 300, 128, 40
# float32 on both sides, in other orders of summation: the port takes the
# norm's variance in one pass (E[x²] − μ²) and the reference in two, and 28
# layers carry those differences forward. The logits and the loss are held
# to 1e-4 relative (about 8x the largest reading); each leaf's gradient to
# 1e-3 relative above a floor of 1e-4 of the larger of that leaf's largest
# entry and the median leaf's (the gradients of the deep layers are sums of
# mixed signs; a bias that a norm follows has a gradient of round-off alone).
LOGIT_RTOL, LOSS_RTOL = 1e-4, 1e-4
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4


def _case(scale: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    s, r = powerlaw_community_edges(rng, N, 6, n_comm=8, alpha=0.6)
    s, r = add_self_loops(*to_undirected(s, r), N)
    x = (rng.standard_normal((N, C_IN)) * scale).astype(np.float32)
    g = build_graph(x, s, r, num_nodes=N)
    labels = rng.integers(0, K, g.num_nodes_padded)
    rows = np.sort(rng.choice(N, N // 2, replace=False))
    args = app.get_args(["--device", "cpu", "--dropout", "0"])
    model = app.build_model(args, C_IN, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(seed + 1)
        for k, p in model.named_parameters():
            if k.startswith("norms."):
                p.copy_((torch.rand(p.shape, generator=gen) + 0.5) if k.endswith("weight")
                        else torch.randn(p.shape, generator=gen) * 0.1)
    return g, torch.from_numpy(labels), torch.from_numpy(rows), model, args


@pytest.mark.parametrize("scale", [1.0, 1e4])
def test_resgen28_matches_the_plain_reference(scale):
    g, labels, rows, model, args = _case(scale)
    assert (args.num_layers, args.hidden_channels, args.gcn_aggr, args.t) == \
        (28, 128, "softmax_sg", 0.1)
    mask = torch.zeros(g.num_nodes_padded, dtype=torch.bool)
    mask[rows] = True
    model.train()
    logits = model(g.x, g)
    loss = cross_entropy(logits, labels, mask)
    loss.backward()

    ne = g.n_edge
    params = {k: p.detach() for k, p in model.named_parameters()}
    want_logits, want_loss, want_grads = ref.loss_and_grads(
        params, g.x[:N], g.senders[:ne].long(), g.receivers[:ne].long(), labels[:N], rows,
        args.num_layers, args.t)
    if scale > 1:
        # the case is past the threshold: under conv 0's global bound every
        # weight of some receiver underflows in float32
        h0 = ref.linear(g.x[:N], params, "node_features_encoder")
        m = torch.relu(h0) + ref.EPS_MSG
        top = args.t * m.max(0).values
        s, r = g.senders[:ne].long(), g.receivers[:ne].long()
        w = torch.exp(args.t * m[s] - top)
        dead = torch.zeros(N, C_IN).index_add(0, r, w) == 0
        assert dead.any()
    np.testing.assert_allclose(logits[:N].detach().numpy(), want_logits.numpy(),
                               rtol=LOGIT_RTOL, atol=LOGIT_RTOL * float(want_logits.abs().max()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    med = float(np.median([float(v.abs().max()) for v in want_grads.values()]))
    for k, p in model.named_parameters():
        want = want_grads[k].numpy()
        floor = GRAD_ATOL_REL * max(float(np.abs(want).max()), med)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=GRAD_RTOL, atol=floor, err_msg=k)
