"""Forward FLOPs of a lead over (a lead's untraced time x the bf16 peak), in %."""

from port_bench.harness.readers import mfu_pct


def read(run):
    return mfu_pct(run, 'forecast')
