"""Device idle time inside the traced slice's ``lm.decode_step`` spans (a
token's sampling, EOS check and decode forward), per decode step, in ms."""

from portbench import spans

NAMES = ("lm.decode_step",)


def read(record):
    s = spans.read(record)
    n = s.count(NAMES) if s else 0
    return 1e3 * s.idle_s(NAMES) / n if n else None
