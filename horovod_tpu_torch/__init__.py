"""horovod_tpu_torch -- the PyTorch/CUDA port of ``horovod_tpu``.

Horovod's data-parallel training path on PyTorch: ``init``, rank
threads (``run``), engine negotiation and tensor fusion into device
fusion buffers packed and unpacked by a hand-written Hopper kernel
(``ops/csrc/scale_cast.cu``), the reduction over ``torch.distributed``
or stacked rows, the rest of the collective contract (alltoall with its
int8/int4 wire, barrier, join, process sets), the torch frontend's
``DistributedOptimizer``, and the compiled path
(``make_compiled_train_step``: one CUDA graph a step; ``CompiledAlltoall``).

Entry points run on the card unless the caller asks for the CPU
(``init(device="cpu")``, ``run(fn, np, device="cpu")``).  The package
imports neither ``jax`` nor ``horovod_tpu``.
"""

from .version import __version__  # noqa: F401
from .common.basics import (  # noqa: F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
    cross_rank, cross_size, is_homogeneous, bind_rank, unbind_rank, device,
    engine,
    mpi_threads_supported, mpi_built, gloo_built, nccl_built, ddl_built,
    ccl_built, cuda_built, rocm_built, xla_built, tpu_built,
)
from .common.exceptions import (  # noqa: F401
    HorovodInitError, HorovodInternalError, TensorShapeMismatchError,
)
from .common.process_sets import (  # noqa: F401
    ProcessSet, add_process_set, remove_process_set, global_process_set,
    process_set_ids,
)
from .core.message import ReduceOp, Adasum  # noqa: F401
from .ops.api import (  # noqa: F401
    allreduce, allreduce_async, allreduce_, allreduce_async_,
    grouped_allreduce, grouped_allreduce_async,
    grouped_allreduce_, grouped_allreduce_async_,
    allgather, allgather_async, grouped_allgather, grouped_allgather_async,
    broadcast, broadcast_async, broadcast_, broadcast_async_,
    reducescatter, reducescatter_async,
    grouped_reducescatter, grouped_reducescatter_async,
    alltoall, alltoall_async, barrier, join,
    synchronize, poll, broadcast_object, allgather_object,
    Average, Sum, Min, Max, Product,
)
from .ops.compiled import (  # noqa: F401
    compiled_allreduce, compiled_alltoall, compiled_grouped_allreduce,
    CompiledAlltoall, CompiledGroupedAllreduce, CompiledPredict,
    TopologyHint, make_compiled_train_step,
)
from .runner.thread_launcher import run  # noqa: F401
from .torch.compression import Compression  # noqa: F401
