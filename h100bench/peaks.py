"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates):
the yardstick of every roofline share and of `mfu_pct`. float32 is the rate
outside the tensor cores: the cells run IEEE float32 with TF32 off."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take for the work: bytes over the
    memory rate or float32 operations over their rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
