"""Share of a train step's untraced time in which the traced window's device ran nothing, in %."""

from port_bench.harness.readers import idle_pct


def read(run):
    return idle_pct(run, 'train')
