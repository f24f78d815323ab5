"""Model FLOPs of a train step (forward and backward, no recompute) over (a step's untraced
time x the bf16 peak), in %."""

from port_bench.harness.readers import mfu_pct


def read(run):
    return mfu_pct(run, 'train')
