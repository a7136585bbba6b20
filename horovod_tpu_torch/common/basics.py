"""Global runtime state and rank contexts (port of
``horovod_tpu/common/basics.py``).

Ranks hosted by this process are thread-bound contexts, as in the JAX
package; every rank of this process works on one device.  The device
is the card unless the caller asks for the CPU: ``init()`` without a
device takes ``cuda:<HOROVOD_LOCAL_RANK>`` and raises when there is no
CUDA device, rather than carrying on on the CPU.  Under the launcher's
``--cpu`` (``HOROVOD_TORCH_PLATFORM=cpu``) it is the CPU.

Under the multi-process launcher (``HOROVOD_CONTROLLER=http``, the
reference's gloo_run.py:66-103 env handoff) ``init()`` builds the
:class:`~..core.store_controller.StoreController` and brings up
``torch.distributed`` at the address process 0 hosts, the counterpart of
the JAX package's ``jax.distributed.initialize``: one process group
member per process, which hosts ``HOROVOD_TPU_RANKS_PER_PROC`` rank
threads (or its entry of ``HOROVOD_TPU_RANKS_OF_PROC`` in a
heterogeneous host:slots job), CPU tensors over gloo, CUDA tensors over
NCCL unless ``HOROVOD_GPU_OPERATIONS=gloo``, with a second group of
every process for the compiled path (``ops/compiled.py``).
"""

import datetime
import threading
from contextlib import contextmanager

import torch
import torch.distributed as dist

from . import env as env_mod
from .exceptions import HorovodInitError

_state_lock = threading.RLock()
_engine = None
_tls = threading.local()
#: host index per global rank (the launcher's HOROVOD_TPU_HOST_OF_RANK,
#: one entry per process, expanded by each process's rank count); one
#: host in a single-process job
_host_of_rank = None
#: True while init() owns a torch.distributed default process group
_dist_up = False


class RankContext:
    """Per-rank identity + auto-naming counters (the reference names
    unnamed ops ``<op>.noname.<n>``)."""

    def __init__(self, rank):
        self.rank = rank
        self._counters = {}

    def next_name(self, op_name):
        n = self._counters.get(op_name, 0) + 1
        self._counters[op_name] = n
        return f"{op_name}.noname.{n}"


def resolve_device(device=None) -> torch.device:
    """The runtime's device: ``device`` if given, else the card of this
    process's local rank.  Raises when CUDA is asked for (explicitly or
    by default) and there is none."""
    if device is None and env_mod.get_str(
            env_mod.HOROVOD_TORCH_PLATFORM) == "cpu":
        device = "cpu"
    if device is None:
        if not torch.cuda.is_available():
            raise HorovodInitError(
                "horovod_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        device = torch.device(
            "cuda", env_mod.get_int(env_mod.HOROVOD_LOCAL_RANK, 0))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise HorovodInitError(f"{device} requested but CUDA is not "
                                   f"available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise HorovodInitError(f"unsupported device {device}")
    return device


def check_gpu_operations(device_uuids, gpu_operations):
    """The backend rule for CUDA tensors, before NCCL's own opaque error:
    NCCL refuses two ranks of one communicator on one GPU, so when NCCL
    is asked for and two processes of the job hold the same device
    (equal UUIDs, one per process) this raises, naming the way out."""
    if gpu_operations not in ("nccl", "gloo"):
        raise HorovodInitError(
            f"HOROVOD_GPU_OPERATIONS={gpu_operations!r}: expected nccl "
            f"or gloo")
    if gpu_operations != "nccl":
        return
    seen = {}
    for proc, uuid in enumerate(device_uuids):
        if uuid in seen:
            raise HorovodInitError(
                f"processes {seen[uuid]} and {proc} both hold GPU "
                f"{uuid}, and NCCL refuses two ranks of one communicator "
                f"on one GPU; run one process a GPU, or set "
                f"HOROVOD_GPU_OPERATIONS=gloo to carry CUDA tensors over "
                f"gloo")
        seen[uuid] = proc


def _exchange_device_uuids(client, proc, num_procs, device):
    """Every process's device UUID, through the rendezvous KV store."""
    own = str(torch.cuda.get_device_properties(device).uuid)
    client.put(f"/hvd_torch/device_uuid/{proc}", own.encode())
    uuids = []
    for p in range(num_procs):
        v = client.get(f"/hvd_torch/device_uuid/{p}", wait=60.0)
        if v is None:
            raise HorovodInitError(
                f"process {p} never published its device UUID")
        uuids.append(v.decode())
    return uuids


#: the bypass vote's timeout when stall shutdown is off: a week (gloo
#: keeps timeouts in milliseconds, and this stays inside a 32-bit count)
BYPASS_VOTE_TIMEOUT_SECS = 7 * 24 * 3600


def _init_multiproc(device, num_ranks, config):
    """The launcher's env handoff (engine.py/basics.py:193-300 of the
    JAX package): controller, ``torch.distributed`` and the engine."""
    global _host_of_rank, _dist_up
    from ..core.engine import Engine
    from ..core.store_controller import StoreController

    rpp = num_ranks or env_mod.get_int(env_mod.HOROVOD_TPU_RANKS_PER_PROC,
                                       1) or 1
    proc = env_mod.get_int(env_mod.HOROVOD_TPU_PROC_INDEX, 0)
    num_procs = env_mod.get_int(env_mod.HOROVOD_TPU_NUM_PROCS, 1)
    coordinator = env_mod.get_str(env_mod.HOROVOD_TPU_COORDINATOR)
    if not coordinator:
        raise HorovodInitError(
            "HOROVOD_CONTROLLER=http without HOROVOD_TPU_COORDINATOR: "
            "launch through horovod_tpu_torch.runner.launch")
    # heterogeneous host:slots jobs carry per-process rank counts; the
    # uniform layout is rpp ranks in every process (basics.py:294-307 of
    # the JAX package)
    rop = env_mod.get_str(env_mod.HOROVOD_TPU_RANKS_OF_PROC)
    ranks_of_proc = None
    if rop:
        ranks_of_proc = [int(x) for x in rop.split(",")]
        if len(ranks_of_proc) != num_procs:
            raise HorovodInitError(
                f"HOROVOD_TPU_RANKS_OF_PROC has {len(ranks_of_proc)} "
                f"entries for {num_procs} processes (stale environment?)")
        rpp = ranks_of_proc[proc]
    counts = ranks_of_proc or [rpp] * num_procs
    secret = env_mod.get_str(env_mod.HOROVOD_SECRET_KEY)
    controller = StoreController(
        env_mod.get_str(env_mod.HOROVOD_RENDEZVOUS_ADDR, "127.0.0.1"),
        env_mod.get_int(env_mod.HOROVOD_RENDEZVOUS_PORT, 0),
        bytes.fromhex(secret) if secret else None, proc, num_procs, rpp)
    dev = resolve_device(device)
    gpu_ops = env_mod.get_str(env_mod.HOROVOD_GPU_OPERATIONS,
                              "nccl").lower()
    uuids = []
    if dev.type == "cuda" and gpu_ops == "nccl":
        uuids = _exchange_device_uuids(controller.client, proc, num_procs,
                                       dev)
    check_gpu_operations(uuids, gpu_ops)
    # CPU tensors always ride gloo; CUDA tensors NCCL or, when asked
    # for, gloo
    backend = "gloo" if dev.type == "cpu" or gpu_ops == "gloo" \
        else "cpu:gloo,cuda:nccl"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", rank=proc,
        world_size=num_procs, timeout=datetime.timedelta(
            seconds=env_mod.get_int(env_mod.HOROVOD_TPU_INIT_TIMEOUT, 300)))
    _dist_up = True
    # the compiled path's own group over every process: its collectives
    # come from the caller's thread un-negotiated, so they must never
    # share a communicator with the engine thread's (ProcessSetState)
    compiled_group = dist.new_group(ranks=list(range(num_procs)))
    # the negotiation bypass's vote: a process whose cached keys are
    # ready waits in it for the slowest process (one that checkpoints or
    # evaluates for minutes), as it waited at the coordinator before the
    # bypass armed, so it gets a gloo group whose timeout is the stall
    # shutdown's, or BYPASS_VOTE_TIMEOUT_SECS when that is off, and not
    # the job group's HOROVOD_TPU_INIT_TIMEOUT
    vote_group = dist.new_group(
        ranks=list(range(num_procs)), backend="gloo",
        timeout=datetime.timedelta(seconds=config.stall_shutdown_secs
                                   or BYPASS_VOTE_TIMEOUT_SECS))
    hof = env_mod.get_str(env_mod.HOROVOD_TPU_HOST_OF_RANK)
    host_of_proc = [int(x) for x in hof.split(",")] if hof \
        else list(range(num_procs))
    if len(host_of_proc) != num_procs:
        raise HorovodInitError(
            f"HOROVOD_TPU_HOST_OF_RANK has {len(host_of_proc)} entries "
            f"for {num_procs} processes (stale environment?)")
    # processes on one host share its local-rank space
    _host_of_rank = [host_of_proc[p] for p in range(num_procs)
                     for _ in range(counts[p])]
    return Engine(rpp, dev, config=config, controller=controller,
                  rank_offset=sum(counts[:proc]), global_size=sum(counts),
                  world_group=dist.group.WORLD,
                  compiled_group=compiled_group,
                  ranks_of_proc=ranks_of_proc, vote_group=vote_group)


def init(device=None, num_ranks=None, process_sets=None):
    """Start the runtime (reference horovod_init): ``num_ranks`` ranks
    hosted by this process on ``device`` (default 1, or the launcher's
    ``HOROVOD_TPU_RANKS_PER_PROC``); ``process_sets`` (``ProcessSet``
    objects) are registered at once.  Under the launcher
    (``HOROVOD_CONTROLLER=http``) this process hosts its run of the job's
    ranks (see the module docstring)."""
    global _engine, _host_of_rank
    with _state_lock:
        if _engine is not None:
            _bind_thread_if_unbound()
            return
        from ..core.engine import Engine

        config = env_mod.Config()
        if env_mod.get_str(env_mod.HOROVOD_CONTROLLER) == "http":
            _engine = _init_multiproc(device, num_ranks, config)
        else:
            _engine = Engine(num_ranks or 1, resolve_device(device),
                             config=config)
            _host_of_rank = [0] * _engine.num_ranks
        _bind_thread_if_unbound()
        if process_sets:
            from . import process_sets as ps_mod
            for ps in process_sets:
                ps_mod.add_process_set(ps)


def _bind_thread_if_unbound():
    if getattr(_tls, "ctx", None) is None and _engine is not None \
            and _engine.num_local == 1:
        _tls.ctx = RankContext(_engine.rank_offset)


def bind_rank(rank):
    """Bind the calling thread to rank ``rank`` of this process."""
    if _engine is None:
        raise HorovodInitError("horovod_tpu_torch.init() has not been called")
    if rank < 0 or rank >= _engine.num_local:
        raise ValueError(
            f"local rank {rank} out of range [0, {_engine.num_local})")
    _tls.ctx = RankContext(_engine.rank_offset + rank)
    return _tls.ctx


def unbind_rank():
    _tls.ctx = None


@contextmanager
def bound_context(ctx):
    """Temporarily bind ``ctx`` to the calling thread.  Autograd runs
    CUDA backward work (and so the optimizer's gradient hooks) on its
    own device thread; the hooks carry the owning rank across with
    this."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def context() -> RankContext:
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        if _engine is None:
            raise HorovodInitError(
                "horovod_tpu_torch has not been initialized; call init()")
        _bind_thread_if_unbound()
        ctx = getattr(_tls, "ctx", None)
        if ctx is None:
            raise HorovodInitError(
                "this thread is not bound to a rank; use "
                "horovod_tpu_torch.run() or bind_rank()")
    return ctx


def engine():
    if _engine is None:
        raise HorovodInitError(
            "horovod_tpu_torch has not been initialized; call init()")
    return _engine


def is_initialized():
    return _engine is not None


def shutdown():
    """Stop the engine (a multi-process one says goodbye to the
    coordinator first) and destroy the process group init() made."""
    global _engine, _host_of_rank, _dist_up
    with _state_lock:
        if _engine is None:
            return
        from ..ops.compiled import reset_compiled_state
        from . import process_sets as ps_mod

        # a re-init at another world size must never serve an old program
        reset_compiled_state()
        ps_mod._reset()
        _engine.shutdown()
        _engine = None
        _host_of_rank = None
        _tls.ctx = None
        if _dist_up:
            _dist_up = False
            dist.destroy_process_group()


# -- topology queries (common/topology.py's Topology of the JAX package):
#    ranks sharing a host index are local to each other -----------------------

def rank():
    return context().rank


def size():
    return engine().num_ranks


def _local_ranks(r):
    host = _host_of_rank[r]
    return [x for x, h in enumerate(_host_of_rank) if h == host]


def local_rank():
    r = rank()
    return _local_ranks(r).index(r)


def local_size():
    return len(_local_ranks(rank()))


def cross_rank():
    """Rank among same-local-rank peers across hosts (reference
    cross_comm semantics): the hosts before this one that have a rank
    at this local index."""
    r = rank()
    lr = local_rank()
    return sum(1 for h in range(_host_of_rank[r])
               if len(_local_ranks(_host_of_rank.index(h))) > lr)


def cross_size():
    lr = local_rank()
    return sum(1 for h in sorted(set(_host_of_rank))
               if len(_local_ranks(_host_of_rank.index(h))) > lr)


def is_homogeneous():
    return len({len(_local_ranks(r)) for r in range(len(_host_of_rank))}) \
        <= 1


def device() -> torch.device:
    """The device the runtime's tensors live on."""
    return engine().device


# -- build-feature queries (common/basics.py:620-675 of the JAX package,
#    reference basics.py:250-340), answered from the torch build.  The port
#    has one controller, the HTTP store coordinator, and torch.distributed
#    as its data plane: NCCL for CUDA tensors, gloo for CPU tensors ---------

def mpi_threads_supported():
    """False: the port has no MPI controller."""
    return False


def mpi_built():
    """Whether this torch was built with the MPI backend of
    ``torch.distributed`` (the port's launcher never uses it)."""
    return dist.is_available() and dist.is_mpi_available()


def gloo_built():
    return dist.is_available() and dist.is_gloo_available()


def nccl_built():
    return dist.is_available() and dist.is_nccl_available()


def ddl_built():
    return False


def ccl_built():
    return False


def cuda_built():
    return torch.version.cuda is not None


def rocm_built():
    return getattr(torch.version, "hip", None) is not None


def xla_built():
    return False


def tpu_built():
    return False


def mpi_enabled():
    """Whether an MPI controller drives negotiation (reference mpi_ops
    ``mpi_enabled``): never in the port."""
    return False


def gloo_enabled():
    """Whether the gloo-style control plane is active (reference mpi_ops
    ``gloo_enabled``): always, as in the JAX package, since the HTTP
    store controller fills the gloo controller's role on every launch
    path."""
    return True
