"""The traced slice's true prompt positions over the positions its
prefills ran after padding (the program's counters ``lm.prompt_positions``
and ``lm.prefill_positions``), in %."""

from portbench import spans


def read(record):
    s = spans.read(record)
    c = (s.counters or {}) if s else {}
    ran = c.get("lm.prefill_positions", 0)
    return 100.0 * c.get("lm.prompt_positions", 0) / ran if ran else None
