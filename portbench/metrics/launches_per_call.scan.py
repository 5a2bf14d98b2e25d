"""launches_per_call.scan: kernel launches a call of a null-grid scan cell
(bulkscan), counted from the device's kernel records in the traced calls,
the harness's checksum left out."""

from portbench.core import readers


def read(ctx):
    return readers.launches_per_call(ctx)
