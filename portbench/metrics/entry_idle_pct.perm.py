"""entry_idle_pct.perm: share of the traced window of a permutation cell
(bulkscan_perms) that is idle while the program's entry layer holds the
card: its innermost span is a ``bulklmm.entry.*`` one (the entry point's
checks, the memory budget, a trait chunk's own work), or a
``bulklmm.sync.*`` span inside one."""

from portbench.core import spans


def read(ctx):
    return spans.idle_pct(ctx.summary, "entry")
