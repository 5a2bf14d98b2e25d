"""entry_idle_pct.scan: share of the traced window of a null-grid scan cell
(bulkscan) that is idle while the program's entry layer holds the card: its
innermost span is a ``bulklmm.entry.*`` one (the entry point's checks, the
memory budget, a trait chunk's own work), or a ``bulklmm.sync.*`` span
inside one."""

from portbench.core import spans


def read(ctx):
    return spans.idle_pct(ctx.summary, "entry")
