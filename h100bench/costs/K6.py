"""K6 (`csrc/gat_bwd_csc.cu`): per sender row, over its kept CSC edges, the
cotangent of the packed table: [sum w·gnum | sum (<msg, gnum> + gden)·w·
lrelu'(el)]. Reads the table, the cotangent, the column pointers, the
receivers and (with edge-drop) the keep flags once; writes dT once. Per kept
(edge, head) four operations, per kept (edge, channel) four (the dot and the
weighted cotangent with their sums)."""

NAME = "dgc::gat_bwd_csc_kernel"


def cost(s):
    n, p, e, b = s["n"], s["p"], s["e"], s["bytes"]
    h, d, work = s["h"], s["d"], s["e_work"]
    keep = e if s.get("drop") else 0
    nbytes = 2 * n * p * b + (n + 1) * 4 + e * 4 + keep + h * 4 + n * p * b
    return float(work * (4 * h + 4 * h * d)), float(nbytes)
