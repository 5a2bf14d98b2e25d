"""prep_idle_pct.altgrid: share of the traced window of an alt-grid cell
(bulkscan, method="alt-grid") that is idle while the program's preparation
holds the card: its innermost span is a ``bulklmm.prep.*`` one (the
rotation, the null fit, the kernels' operands, the shuffle indices), or a
``bulklmm.sync.*`` span inside one."""

from portbench.core import spans


def read(ctx):
    return spans.idle_pct(ctx.summary, "prep")
