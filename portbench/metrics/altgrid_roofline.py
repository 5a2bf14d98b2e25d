"""altgrid_roofline: the alt-grid kernel's least time over its device time,
as lod_roofline."""

from portbench.core import readers


def read(ctx):
    return readers.roofline_pct(ctx, 'altgrid')
