"""K5 (`csrc/gat_fwd.cu`): per receiver row, over its kept edges, the
attention weights w = exp(leaky_relu(el[send]) - cmax) per head and
[sum w·msg | sum w] of the packed table [msg | el] (``p`` columns, ``h``
heads of ``d``). Reads the table, the senders, the effective receivers and
the row pointers once; writes the [n, p] output once. Per kept (edge, head)
four operations (score, shift, exp, sum), per kept (edge, channel) two."""

NAME = "dgc::gat_fwd_kernel"


def cost(s):
    n, p, e, b = s["n"], s["p"], s["e"], s["bytes"]
    h, d, work = s["h"], s["d"], s["e_work"]
    nbytes = n * p * b + 2 * e * 4 + (n + 1) * 4 + h * 4 + n * p * b
    return float(work * (4 * h + 2 * h * d)), float(nbytes)
