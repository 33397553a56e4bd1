"""The card's peaks and the byte counts of the kernels whose roofline share
the benchmark reports, computed from shapes."""

# NVIDIA H100 SXM, HBM3 (the data sheet's 3.35 TB/s at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12

EXTENDED_HALO = 10  # the extended test's window reach: 5 + 2 + 3 columns


def packed_word_lanes(width: int, halo: int) -> int:
    """32-bit word lanes of a row of the packed [counts | words] output: the
    padded width rounded up to 128 columns, in words, rounded up to 8."""
    wp = (width + 2 * halo + 127) // 128 * 128
    return (wp // 32 + 7) // 8 * 8


def extended_threshold_bytes(batch: int, height: int, width: int, pixel_bytes: int) -> int:
    """Compulsory bytes of one extended-threshold launch: the batch's frames
    and the mask read once, the (B, H, 2 * lanes) int32 output written once."""
    lanes = packed_word_lanes(width, EXTENDED_HALO)
    return batch * height * width * pixel_bytes + height * width + batch * height * 2 * lanes * 4
