"""Published peaks of the cards the benchmark runs on (the vendor's data
sheet, dense rates, no sparsity), matched by the device's name.

NVIDIA H100 SXM: 989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of
HBM3 at the full 700 W. A float32-accurate product needs at least three bf16
passes or their equal, so no implementation of float32-grade work reads over
100 % against the bf16 rate, and every implementation of the same work is
held to the same yardstick.
"""

PEAKS = {
    "H100": {"flops": 989e12, "bytes_per_s": 3.35e12},
}


def for_device(name: str):
    """The peaks of the card called ``name``, or None for an unknown one."""
    for key, peak in PEAKS.items():
        if key in name:
            return peak
    return None
