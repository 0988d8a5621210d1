"""K4 (`csrc/softmax_bwd_csc.cu`): per sender row, over its CSC edges, the
backward of K2's aggregation with each edge's normalised weight
a = exp(t·m − lse[r]) read against its receiver's log-normaliser:
dx[s] = sum relu'(x_j)·g[r]·a (·(1 + t·(m − out[r])) with learned weights).
Reads x, the cotangent g (and out with learned weights) and lse once, the
column pointers, the CSC receivers and t once (and ee_csc with edge
embeddings); writes dx once (and dee over all E_pad rows, and one float32
dt partial a sender row with learned weights).

Operations, per (edge, channel): the message (2), its score (1), the shift
(1), exp, the product with the cotangent (1), relu's mask (1) and the sum
(1); with learned weights the factor 1 + t·(m − out) (3), its product (1)
and dt's term and sum (3); with edge embeddings the add (1). An accurate
expf counts 16 float32 operations, as in `costs/K2.py`."""

NAME = "dgc::softmax_bwd_csc_kernel"
SFU = 16  # float32 operations an accurate expf stands for


def cost(s):
    n, e, c, b = s["n"], s["e"], s["c"], s["bytes"]
    ee, gw = bool(s.get("ee")), bool(s.get("gw"))
    q_cols = 2 * c if gw else c
    nbytes = (n * c * b + n * q_cols * b + n * c * 4 + (n + 1) * 4 + e * 4 + 4
              + n * c * b)
    if ee:
        nbytes += e * c * b + s["e_pad"] * c * b
    if gw:
        nbytes += n * 4
    flops = e * c * (7 + SFU + (7 if gw else 0) + (1 if ee else 0))
    return float(flops), float(nbytes)
