"""Multi-rank execution (counterpart of ``spconv_tpu/parallel``): the JAX
package's five functions over ``torch.distributed`` (``mesh``), and
``launch.run_ranks``, which starts ranks on one host."""

from .launch import run_ranks
from .mesh import (Mesh, axis_group, channel_parallel_conv,
                   data_parallel_call, data_parallel_value_and_grad,
                   make_mesh, stack_sparse_batch)

__all__ = [
    "make_mesh",
    "stack_sparse_batch",
    "data_parallel_call",
    "data_parallel_value_and_grad",
    "channel_parallel_conv",
    "Mesh",
    "axis_group",
    "run_ranks",
]
