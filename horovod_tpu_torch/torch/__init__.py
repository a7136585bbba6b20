"""Torch frontend -- ``import horovod_tpu_torch.torch as hvd``.

API parity with ``horovod_tpu/torch`` for the ported slices: collectives
over device tensors (sparse ones too), ``DistributedOptimizer`` (with
autograd hooks, Adasum and sparse gradients, or weight-update sharded),
``SyncBatchNorm``, compression, parameter and optimizer-state
broadcast, and the elastic frontend (``elastic.run``, ``TorchState``,
``ElasticSampler``).
"""

from ..common.basics import (  # noqa: F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
    cross_rank, cross_size, is_homogeneous, bind_rank, unbind_rank, device,
    mpi_threads_supported, mpi_built, gloo_built, nccl_built, ddl_built,
    ccl_built, cuda_built, rocm_built, xla_built, tpu_built,
    mpi_enabled, gloo_enabled,
)
from ..common.exceptions import HorovodInternalError  # noqa: F401
from ..common.process_sets import (  # noqa: F401
    ProcessSet, add_process_set, remove_process_set, global_process_set,
)
from ..runner.thread_launcher import run  # noqa: F401
from .compression import Compression  # noqa: F401
from .functions import (  # noqa: F401
    allgather_object, broadcast_object, broadcast_optimizer_state,
    broadcast_parameters,
)
from .mpi_ops import (  # noqa: F401
    allreduce, allreduce_async, allreduce_, allreduce_async_,
    grouped_allreduce, grouped_allreduce_async,
    grouped_allreduce_, grouped_allreduce_async_,
    allgather, allgather_async, grouped_allgather, grouped_allgather_async,
    broadcast, broadcast_async, broadcast_, broadcast_async_,
    alltoall, alltoall_async,
    reducescatter, reducescatter_async,
    grouped_reducescatter, grouped_reducescatter_async,
    barrier, join, synchronize, poll, sparse_allreduce_async,
    Average, Sum, Adasum, Min, Max, Product,
    HorovodAllreduce, HorovodGroupedAllreduce, HorovodAllgather,
    HorovodGroupedAllgather, HorovodBroadcast, HorovodAlltoall,
    HorovodReducescatter, HorovodGroupedReducescatter,
)
from .optimizer import DistributedOptimizer  # noqa: F401
from .sync_batch_norm import SyncBatchNorm  # noqa: F401
from . import elastic  # noqa: F401
