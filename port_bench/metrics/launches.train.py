"""Device kernel launches a train step (a count)."""

from port_bench.harness.readers import launches


def read(run):
    return launches(run, 'train')
