"""Least time of a train step's band attention (flash_attention forward and backward)
over the device time of those kernels, in %."""

from port_bench.harness.readers import flash_roofline


def read(run):
    return flash_roofline(run, 'train')
