"""``generate(timing=...)``'s ``decode_ms`` over its decode forwards (steps
- 1), total over total, in ms a token."""


def read(record):
    n = record.get("decode_steps") or 0
    return record["decode_ms"] / n if n else None
