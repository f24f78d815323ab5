"""Model parallelism over a (data, model) grid of ranks on ``torch.distributed``.

The port's counterpart of ``anemoi_models_tpu.parallel``, under the JAX
package's names where they exist: the mesh (``api``), the collectives with
their adjoints (``primitives``), the 1-hop halo exchange (``halo``), the GNN
and GraphTransformer layers under it (``halo_conv``) and the
destination-sharded mappers (``mapper_conv``). The layers take these paths
by themselves under an active mesh whose ``model`` axis is larger than 1;
``all_reduce_gradients`` is the train step's reduction of the replicated
parameters' gradients; ``fsdp`` shards the parameters and the optimizer
state (ZeRO-1 / FSDP) for ``training.train_run``; ``make_hybrid_mesh`` lays
the data axis over hosts and a host's ranks.
"""

from anemoi_models_tpu_torch.parallel.api import (
    Mesh,
    get_mesh,
    hybrid_rank_grid,
    make_hybrid_mesh,
    make_mesh,
    model_sharded,
    row_range,
    set_mesh,
    use_mesh,
)
from anemoi_models_tpu_torch.parallel.fsdp import ShardPlan, array_shardings, shard_train_state, train_state_shardings
from anemoi_models_tpu_torch.parallel.halo import halo_exchange, pad_nodes, unpad_nodes
from anemoi_models_tpu_torch.parallel.halo_conv import halo_graph_conv, halo_graph_transformer_conv, shard_edge_values
from anemoi_models_tpu_torch.parallel.mapper_conv import (
    gather_source_rows,
    sharded_mapper_edge_attention,
    sharded_mapper_gnn_conv,
)
from anemoi_models_tpu_torch.parallel.primitives import (
    all_reduce_gradients,
    change_channels_in_shape,
    gather_tensor,
    get_shape_shards,
    reduce_shard_tensor,
    reduce_tensor,
    shard_tensor,
    sync_tensor,
)

__all__ = [
    "Mesh",
    "ShardPlan",
    "all_reduce_gradients",
    "array_shardings",
    "change_channels_in_shape",
    "gather_source_rows",
    "gather_tensor",
    "get_mesh",
    "get_shape_shards",
    "halo_exchange",
    "halo_graph_conv",
    "halo_graph_transformer_conv",
    "hybrid_rank_grid",
    "make_hybrid_mesh",
    "make_mesh",
    "model_sharded",
    "pad_nodes",
    "reduce_shard_tensor",
    "reduce_tensor",
    "row_range",
    "set_mesh",
    "shard_edge_values",
    "shard_tensor",
    "shard_train_state",
    "sharded_mapper_edge_attention",
    "sharded_mapper_gnn_conv",
    "sync_tensor",
    "train_state_shardings",
    "unpad_nodes",
    "use_mesh",
]
