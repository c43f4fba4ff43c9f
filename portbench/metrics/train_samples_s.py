"""Samples of all whole steps done in the window over their time: the
window's start to the last step's synchronised end (host clock)."""


def read(record):
    return record["samples"] / record["window_s"]
