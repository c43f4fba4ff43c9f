"""Mean host wall time of the traced step's ``train.optimizer`` spans
(``AdamW.step``: the update of every trainable tensor queued), in ms."""

from portbench import spans

NAMES = ("train.optimizer",)


def read(record):
    s = spans.read(record)
    n = s.count(NAMES) if s else 0
    return 1e3 * s.wall_s(NAMES) / n if n else None
