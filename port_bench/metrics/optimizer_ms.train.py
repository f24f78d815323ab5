"""Device ms a train step of the kernels launched inside ``optimizer.step``."""

from port_bench.harness.readers import range_ms


def read(run):
    return range_ms(run, 'train', 'optimizer')
