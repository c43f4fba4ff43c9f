"""95th percentile (nearest rank) over every request due in the window of the
time from its due time to its last token, in ms."""

import math


def read(record):
    lat = sorted(record["latency_ms"])
    return lat[math.ceil(0.95 * len(lat)) - 1]
