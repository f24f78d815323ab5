"""Least time of a lead's edge-attention work (kv_proj, edge_attn_csr) over the
device time of those kernels, in %."""

from port_bench.harness.readers import edge_roofline


def read(run):
    return edge_roofline(run, 'forecast')
