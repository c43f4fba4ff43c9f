"""K8 (``decode_all_layers_kernel``) launches of the traced slice at their
roofline (%)."""

from portbench.rooflines import share


def read(record):
    return share(record, "k8")
