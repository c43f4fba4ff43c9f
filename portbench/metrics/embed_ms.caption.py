"""Mean device time of a request's preprocessing and embedding (tower,
ImagePrefix, token lookup), CUDA events around ``submit_prompt``."""


def read(record):
    ms = record.get("embed_ms") or []
    return sum(ms) / len(ms) if ms else None
