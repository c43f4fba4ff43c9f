"""Mean host wall time of the traced slice's ``kernel.*`` spans: what a
launch of a hand-written kernel costs the host from the wrapper's entry
through the launch (checks, tensor maps, allocation), in us."""

from portbench import spans

NAMES = ("kernel.",)


def read(record):
    s = spans.read(record)
    n = s.count(NAMES) if s else 0
    return 1e6 * s.wall_s(NAMES) / n if n else None
