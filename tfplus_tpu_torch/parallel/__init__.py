"""The distributed tier on ``torch.distributed`` (PyTorch port of
``tfplus_tpu.parallel``): one process per rank, each holding its own shard;
the bodies take a process group or a ``DeviceMesh`` where the JAX package
takes an axis name. The JAX package's placement helpers (``table_sharding``,
``replicated``, ``table_sharding_2d``) only build JAX sharding objects and
have no counterpart here."""
from . import hybrid, mesh, serving, sharded2d, sharded_table
from .hybrid import ShardedHybridTable
from . import ring_attention  # module (ring_attention.ring_attention = fn)
from .mesh import TABLE_AXIS, initialize_multihost, make_mesh
from .sharded_table import (ExchangeState, create_sharded,
                            dropped_positions, grow_sharded_if_needed,
                            init_optimizer_sharded, local_shard, route_stats,
                            shard_sizes, sharded_apply_grads,
                            sharded_embedding_lookup_sparse, sharded_grow,
                            sharded_lookup, sharded_needs_grow)
from .sharded2d import (COL_AXIS, ROW_AXIS, combine_col_shards,
                        create_sharded_2d, for_col_axis,
                        grow_sharded_2d_if_needed,
                        init_optimizer_sharded_2d, local_shard_2d,
                        make_mesh_2d, shard_sizes_2d,
                        sharded_apply_grads_2d, sharded_grow_2d,
                        sharded_lookup_2d, sharded_needs_grow_2d)
