"""syncs_per_call.altgrid: points a call of an alt-grid cell (bulkscan,
method="alt-grid") at which the host waits on the card or its driver: the
program's ``bulklmm.sync.*`` spans in the traced window over its calls."""

from portbench.core import spans


def read(ctx):
    return spans.syncs_per_call(ctx.summary)
