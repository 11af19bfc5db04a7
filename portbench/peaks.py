"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its 700 W limit): float32 outside the tensor cores, HBM3 bandwidth."""

PEAK_F32 = 67e12        # FLOP/s
PEAK_BYTES = 3.35e12    # bytes/s
