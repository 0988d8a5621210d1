"""K2 (`csrc/softmax_agg.cu`): per receiver row, over its CSR edges, the
softmax aggregation of m = relu(x[send] [+ ee]) + eps shifted by the row's
own maximum score: out = sum w·m / sum w and lse = M + log(sum w). Reads x,
the senders, the row pointers and t once (and ee with edge embeddings);
writes out (n x c in x's type) and lse (n x c float32) once.

Operations, per (edge, channel): the message (2), its score (1), the
running maximum (1), the shift (1), exp, the weighted message (1) and the
two sums (2), and with edge embeddings the add (1); per (node, channel) the
quotient (1), log and the add (1). An accurate expf or logf counts 16
float32 operations, the float32 rate over the special-function units' rate
of the H100 (67e12 / 4.18e12), so that `peaks.least_seconds` gives the
expf bound of the kernel table's K2 row."""

NAME = "dgc::softmax_agg_kernel"
SFU = 16  # float32 operations an accurate expf or logf stands for


def cost(s):
    n, e, c, b = s["n"], s["e"], s["c"], s["bytes"]
    ee = bool(s.get("ee"))
    nbytes = (n * c * b + e * 4 + (n + 1) * 4 + 4 + (e * c * b if ee else 0)
              + n * c * b + n * c * 4)
    flops = e * c * (8 + SFU + (1 if ee else 0)) + n * c * (2 + SFU)
    return float(flops), float(nbytes)
