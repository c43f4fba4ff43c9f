"""Device idle time inside the traced step's ``train.forward`` and
``train.backward`` spans (the micro-batches' loss and gradients), per
``train.step``, in ms."""

from portbench import spans


def read(record):
    s = spans.read(record)
    n = s.count(("train.step",)) if s else 0
    return 1e3 * s.idle_s(("train.forward", "train.backward")) / n if n else None
