"""idle_pct.altgrid: share of the traced window of an alt-grid cell in which
no kernel, copy or fill ran on the device."""

from portbench.core import readers


def read(ctx):
    return readers.idle_pct(ctx)
