"""Model FLOPs of the requests of the window (true positions only) over
their seconds and the bf16 peak, in %; the traced requests, which the
profiler slows, are left out of both the work and the time."""

from portbench.cost import BF16_FLOPS


def read(record):
    if not record["mfu_flops"]:
        return None
    return 100.0 * record["mfu_flops"] / record["mfu_s"] / BF16_FLOPS
