"""prep_device_ms.perm: device milliseconds a call of a permutation cell in
which anything of the program but the permutation kernel ran: the
rotation, the null fits, the trait blocks' operands, copies (the harness's
checksum left out)."""

from portbench.core import readers


def read(ctx):
    return readers.prep_device_ms(ctx)
