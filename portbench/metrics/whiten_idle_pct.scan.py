"""whiten_idle_pct.scan: share of the traced window of a null-grid scan cell
(bulkscan) that is idle while the wide LOD kernel's whitening holds the
card: its innermost span is ``bulklmm.prep.whiten`` (the covariates' Gram,
its batched Cholesky factorisation, the triangular solve and V), or a
``bulklmm.sync.*`` span inside it (the factorisation's wait). A part of
``prep_idle_pct.scan``. None where the window holds no whitening span: a
cell off the wide kernel, or a program without the span."""

import dataclasses

from portbench.core import spans

WHITEN = "bulklmm.prep.whiten"
#: the whitening span under a layer of its own, so that ``core/spans.py``
#: puts its idle time, and that of the sync spans inside it, apart
AS_LAYER = "bulklmm.whiten.span"


def read(ctx):
    summary = ctx.summary
    if not any(r.name == WHITEN for r in summary.host):
        return None
    host = [dataclasses.replace(r, name=AS_LAYER) if r.name == WHITEN else r
            for r in summary.host]
    return spans.idle_pct(dataclasses.replace(summary, host=host), spans.layer(AS_LAYER))
