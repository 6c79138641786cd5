"""The table of peaks the rooflines and the MFU are read against: one NVIDIA
H100 SXM at its 700 W limit, dense rates without sparsity (NVIDIA's data
sheet). A run records the card's name beside them; a card set below 700 W
reads lower shares."""

BF16_FLOPS = 989e12  # tensor cores, bf16 / fp16, dense
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(flops / BF16_FLOPS, n_bytes / HBM_BYTES_PER_S)
