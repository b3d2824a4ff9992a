from .distributed import (from_rank0, initialize_distributed, launch, on_rank0,
                          process_local_rows)
from .mesh import (Mesh, embedding_table_shapes, is_row_sharded, make_mesh, mesh_axes,
                   parse_mesh_spec, resolve_mesh, shard_range)
