"""Least time of a lead's band attention over the device time of flash_attention, in %."""

from port_bench.harness.readers import flash_roofline


def read(run):
    return flash_roofline(run, 'forecast')
