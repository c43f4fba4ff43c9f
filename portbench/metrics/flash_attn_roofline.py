"""K1 (both bodies), K9a and K9b launches of the traced step at their
roofline (%)."""

from portbench.rooflines import share


def read(record):
    return share(record, "flash")
