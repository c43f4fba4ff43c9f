"""K2a, K2b, K4a and K5 launches of the traced slice (the prefill's int8
tiles and fused adapters, and layer 0's in_proj GEMV of each decode step)
at their roofline (%)."""

from portbench.rooflines import share


def read(record):
    return share(record, "int8")
