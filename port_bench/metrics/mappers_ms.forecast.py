"""Device ms a lead time of the kernels launched inside the encoder's and the decoder's forwards."""

from port_bench.harness.readers import range_ms


def read(run):
    return range_ms(run, 'forecast', 'encoder', 'decoder')
