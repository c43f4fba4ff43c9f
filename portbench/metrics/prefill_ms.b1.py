"""Mean of ``generate(timing=...)``'s ``prefill_ms`` (CUDA events: cache
allocation, the prompt's forward, the first sampling)."""


def read(record):
    ms = record.get("prefill_ms") or []
    return sum(ms) / len(ms) if ms else None
