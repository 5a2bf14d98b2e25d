"""mfu.scan: a null-grid scan call's flops (its kernel's count and the
rotation) over the traced window at the card's bf16 tensor peak."""

from portbench.core import readers


def read(ctx):
    return readers.mfu_pct(ctx)
