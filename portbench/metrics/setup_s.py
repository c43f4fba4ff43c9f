"""Set-up: process start to the first timed request or step (host clock)."""


def read(record):
    return record["setup_s"]
