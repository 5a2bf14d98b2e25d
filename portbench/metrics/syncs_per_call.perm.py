"""syncs_per_call.perm: points a call of a permutation cell (bulkscan_perms) at
which the host waits on the card or its driver: the program's
``bulklmm.sync.*`` spans in the traced window over its calls."""

from portbench.core import spans


def read(ctx):
    return spans.syncs_per_call(ctx.summary)
