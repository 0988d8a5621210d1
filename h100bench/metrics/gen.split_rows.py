"""gen.split_rows: K2's long receiver rows split over warps a window epoch, as the port counts
them: the window's K2 gather-form launches (the differences of `.launches` and `.launches_ee`)
times the rows a launch of the process split on average (`softmax_agg.split_rows` over both
forms' launches). A program without that counter splits no row and reads 0."""


def read(ctx):
    from deep_gcns_torch_tpu_torch.ops import spmm_cuda

    k2 = spmm_cuda.softmax_agg
    d = sum(ctx.counters1["launches"].get(k, 0) - ctx.counters0["launches"].get(k, 0)
            for k in ("K2", "K2ee"))
    launched = getattr(k2, "launches", 0) + getattr(k2, "launches_ee", 0)
    return ctx.per_epoch(d * getattr(k2, "split_rows", 0) / launched if launched else 0)
