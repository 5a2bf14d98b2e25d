"""lod_roofline: the LOD kernel's least time (its flops at the bf16 tensor
peak or its bytes at the HBM bandwidth, whichever is larger, launch by
launch) over its device time."""

from portbench.core import readers


def read(ctx):
    return readers.roofline_pct(ctx, 'lod')
