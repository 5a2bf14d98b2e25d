"""prep_idle_pct.p95: share of the traced window of a cell judged by its
calls' 95th percentile (scan_p95_ms) that is idle while the program's
preparation holds the card: its innermost span is a ``bulklmm.prep.*`` one
(the rotation with the host ``eigh`` of a kinship passed as a matrix, the
null fit, the kernels' operands), or a ``bulklmm.sync.*`` span inside one.
The same reading as ``prep_idle_pct.scan``, for a host-paced cell whose
rate spreads too widely to bound."""

from portbench.core import spans


def read(ctx):
    return spans.idle_pct(ctx.summary, "prep")
