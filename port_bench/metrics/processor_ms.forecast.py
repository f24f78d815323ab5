"""Device ms a lead time of the kernels launched inside the processor's forward."""

from port_bench.harness.readers import range_ms


def read(run):
    return range_ms(run, 'forecast', 'processor')
