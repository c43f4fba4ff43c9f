"""Model FLOPs the window's samples require over their true positions
(forward, backward to the inputs through the frozen LM, adapter and tower
gradients) over their steps' seconds and the bf16 peak, in %; the traced
step, which the profiler slows, is left out of both the work and the time."""

from portbench.cost import BF16_FLOPS


def read(record):
    if not record["mfu_flops"]:
        return None
    return 100.0 * record["mfu_flops"] / record["mfu_s"] / BF16_FLOPS
