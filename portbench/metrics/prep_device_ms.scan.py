"""prep_device_ms.scan: device milliseconds a call of a null-grid scan cell
in which anything of the program but the LOD kernel ran: the rotation, the
null grid, the kernel's operands, copies (the harness's checksum left out)."""

from portbench.core import readers


def read(ctx):
    return readers.prep_device_ms(ctx)
