"""prep_device_ms.altgrid: device milliseconds a call of an alt-grid cell in
which anything of the program but the alt-grid kernel ran: the rotation,
the null grid, the kernel's operands, the float64 outputs, copies."""

from portbench.core import readers


def read(ctx):
    return readers.prep_device_ms(ctx)
