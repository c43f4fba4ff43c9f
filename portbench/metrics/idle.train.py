"""Share of the traced slice in which no kernel, copy or memset ran on the
device, in %."""


def read(record):
    t = record.get("trace")
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None
