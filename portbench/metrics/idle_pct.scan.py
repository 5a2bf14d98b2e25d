"""idle_pct.scan: share of the traced window of a null-grid scan cell in
which no kernel, copy or fill ran on the device."""

from portbench.core import readers


def read(ctx):
    return readers.idle_pct(ctx)
