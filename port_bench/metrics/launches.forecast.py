"""Device kernel launches a lead time (a count)."""

from port_bench.harness.readers import launches


def read(run):
    return launches(run, 'forecast')
