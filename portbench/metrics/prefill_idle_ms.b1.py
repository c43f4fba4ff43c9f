"""Device idle time inside the traced slice's ``lm.prefill`` spans (cache
allocation, the prompt's forward, the head), per prefill, in ms."""

from portbench import spans

NAMES = ("lm.prefill",)


def read(record):
    s = spans.read(record)
    n = s.count(NAMES) if s else 0
    return 1e3 * s.idle_s(NAMES) / n if n else None
