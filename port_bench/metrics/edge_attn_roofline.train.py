"""Least time of a train step's edge-attention work (one forward and one backward of
kv_proj, edge_attn_csr, edge_attn_csr_bwd) over the device time of those kernels, in %."""

from port_bench.harness.readers import edge_roofline


def read(run):
    return edge_roofline(run, 'train')
