"""launches_per_call.altgrid: kernel launches a call of an alt-grid cell
(bulkscan, method alt-grid), counted from the device's kernel records in the
traced calls, the harness's checksum left out."""

from portbench.core import readers


def read(ctx):
    return readers.launches_per_call(ctx)
