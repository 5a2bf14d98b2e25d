"""syncs_per_call.scan: points a call of a null-grid scan cell (bulkscan) at
which the host waits on the card or its driver: the program's
``bulklmm.sync.*`` spans in the traced window over its calls."""

from portbench.core import spans


def read(ctx):
    return spans.syncs_per_call(ctx.summary)
