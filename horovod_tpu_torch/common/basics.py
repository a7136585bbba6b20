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

A worker of an elastic job (``HOROVOD_ELASTIC=1``, spawned by
``runner/elastic/driver.py``) takes its process index, the job's size,
the ``torch.distributed`` address and the host layout from the round the
driver publishes at ``/elastic/round`` (:func:`_elastic_rendezvous`),
not from the static handoff; every round has an address of its own, so
an elastic reset re-initializes in place (:func:`shutdown`, then
:func:`init`).

Under ``HOROVOD_CONTROL_PLANE_TIER=host`` the lowest-indexed process of
each host starts that host's aggregator (runner/http/aggregator.py) and
every process of the host routes its control traffic through it; under
``HOROVOD_FAULT_PLAN`` the seeded fault injector (chaos/inject.py) is
installed before the engine starts and handed to it.
"""

import atexit
import datetime
import threading
from contextlib import contextmanager

import torch
import torch.distributed as dist

from . import env as env_mod
from .exceptions import HorovodInitError
from .topology import Topology

_state_lock = threading.RLock()
_engine = None
_tls = threading.local()
#: host index per global rank (the launcher's HOROVOD_TPU_HOST_OF_RANK,
#: one entry per process, expanded by each process's rank count); one
#: host in a single-process job
_host_of_rank = None
#: True while init() owns a torch.distributed default process group
_dist_up = False
#: the elastic round this process last joined (0: none yet); the next
#: rendezvous waits for a newer one
_elastic_round = 0
#: a one-rank process's context: an elastic re-init rebinds this object
#: to the new round's rank, so what holds it (the optimizer's gradient
#: hooks) follows the process into the next round
_proc_ctx = None
#: set by shutdown() when the engine thread outlived the teardown's bound
_teardown_wedged = False
#: True once the interpreter-exit teardown is registered
_atexit_registered = False


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


def _exchange_device_uuids(client, proc, num_procs, device, round_id=0):
    """Every process's device UUID, through the rendezvous KV store (keyed
    by the elastic round: a process index of an earlier round may have
    been another process)."""
    own = str(torch.cuda.get_device_properties(device).uuid)
    client.put(f"/hvd_torch/device_uuid/{round_id}/{proc}", own.encode())
    uuids = []
    for p in range(num_procs):
        v = client.get(f"/hvd_torch/device_uuid/{round_id}/{p}", wait=60.0)
        if v is None:
            raise HorovodInitError(
                f"process {p} never published its device UUID")
        uuids.append(v.decode())
    return uuids


#: the bypass vote's timeout when stall shutdown is off: a week (gloo
#: keeps timeouts in milliseconds, and this stays inside a 32-bit count)
BYPASS_VOTE_TIMEOUT_SECS = 7 * 24 * 3600


def _elastic_rendezvous(client):
    """This worker's place in the next elastic round, from the driver's
    ``/elastic/round`` record on the launcher's KV store (reference:
    rank and size re-fetched from the rendezvous server on every reset,
    gloo_context.cc:168-206; basics.py:66-113 of the JAX package).
    Returns ``(proc, size, coordinator, round, host_of_proc)``: the
    host index of each process, by its host's first place in rank
    order, is the round's own layout."""
    import json
    import logging
    import time

    global _elastic_round
    identity = (f"{env_mod.get_str(env_mod.HOROVOD_HOSTNAME, 'localhost')}"
                f":{env_mod.get_int(env_mod.HOROVOD_LOCAL_RANK, 0)}")
    deadline = time.monotonic() + env_mod.get_float(
        env_mod.HOROVOD_ELASTIC_TIMEOUT, 600.0)
    while time.monotonic() < deadline:
        raw = client.get("/elastic/round", wait=10.0)
        if raw is None:
            continue
        info = json.loads(raw)
        if info.get("suspended") and info["round"] > _elastic_round:
            # the job was preempted to zero workers (driver.suspend): the
            # last commit is in the spill and the control plane stays up,
            # so a worker that outlives the suspension exits cleanly and
            # the resumed round restores the commit in fresh workers
            logging.getLogger("horovod_tpu_torch").warning(
                "job suspended at round %d; exiting cleanly (state "
                "committed to the spill)", info["round"])
            raise SystemExit(0)
        if info["round"] <= _elastic_round:
            time.sleep(0.2)
            continue
        if identity not in info["assignments"]:
            # not part of this round (blacklisted, or beyond max_np):
            # keep waiting; the driver terminates us if we stay out
            time.sleep(0.5)
            continue
        _elastic_round = info["round"]
        proc = info["assignments"][identity]
        # round-formation marker: the driver's elastic timeout watches
        # these to tell a forming round from a stuck one
        client.put(f"/elastic/joined/{info['round']}/{proc}", b"1")
        hosts = []
        by_rank = sorted(info["assignments"].items(), key=lambda kv: kv[1])
        for key, _ in by_rank:
            host = key.rsplit(":", 1)[0]
            if host not in hosts:
                hosts.append(host)
        host_of_proc = [hosts.index(key.rsplit(":", 1)[0])
                        for key, _ in by_rank]
        return (proc, info["size"], info["coordinator"], info["round"],
                host_of_proc)
    raise HorovodInitError("timed out waiting for elastic rendezvous")


def _init_multiproc(device, num_ranks, config):
    """The launcher's env handoff (engine.py/basics.py:193-300 of the
    JAX package): controller, ``torch.distributed`` and the engine."""
    global _host_of_rank, _dist_up
    from ..core.engine import Engine
    from ..core.store_controller import StoreController
    from ..runner.http.http_client import StoreClient

    secret = env_mod.get_str(env_mod.HOROVOD_SECRET_KEY)
    rdv = (env_mod.get_str(env_mod.HOROVOD_RENDEZVOUS_ADDR, "127.0.0.1"),
           env_mod.get_int(env_mod.HOROVOD_RENDEZVOUS_PORT, 0),
           bytes.fromhex(secret) if secret else None)
    rpp = num_ranks or env_mod.get_int(env_mod.HOROVOD_TPU_RANKS_PER_PROC,
                                       1) or 1
    round_id = 0
    host_of_proc = None
    if config.elastic:
        if rpp != 1:
            raise HorovodInitError(
                f"an elastic worker hosts one rank, not {rpp} (the "
                f"elastic driver sets HOROVOD_TPU_RANKS_PER_PROC=1)")
        proc, num_procs, coordinator, round_id, host_of_proc = \
            _elastic_rendezvous(StoreClient(*rdv))
    else:
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
    rop = None if config.elastic else \
        env_mod.get_str(env_mod.HOROVOD_TPU_RANKS_OF_PROC)
    ranks_of_proc = None
    if rop:
        ranks_of_proc = [int(x) for x in rop.split(",")]
        if len(ranks_of_proc) != num_procs:
            raise HorovodInitError(
                f"HOROVOD_TPU_RANKS_OF_PROC has {len(ranks_of_proc)} "
                f"entries for {num_procs} processes (stale environment?)")
        rpp = ranks_of_proc[proc]
    counts = ranks_of_proc or [rpp] * num_procs
    if host_of_proc is None:
        hof = env_mod.get_str(env_mod.HOROVOD_TPU_HOST_OF_RANK)
        host_of_proc = [int(x) for x in hof.split(",")] if hof \
            else list(range(num_procs))
    if len(host_of_proc) != num_procs:
        raise HorovodInitError(
            f"HOROVOD_TPU_HOST_OF_RANK has {len(host_of_proc)} entries "
            f"for {num_procs} processes (stale environment?)")
    # per-host aggregator tier (basics.py:345-360 of the JAX package):
    # the lowest-indexed process of each host starts the aggregator and
    # publishes its address in the launcher's KV store; every process of
    # the host routes its control traffic through it, the coordinator
    # staying the fallback route (TieredStoreClient)
    agg_addr = agg_port = None
    from ..runner.http import aggregator as agg_mod
    if agg_mod.tier_enabled() and num_procs > 1:
        agg_addr, agg_port, _agg_id = agg_mod.ensure_host_aggregator(
            rdv[0], rdv[1], rdv[2], proc, host_of_proc, round_id=round_id)
    controller = StoreController(*rdv, proc, num_procs, rpp,
                                 round_id=round_id, agg_addr=agg_addr,
                                 agg_port=agg_port)
    chaos = _install_chaos(config, proc, sum(counts[:proc]), rpp,
                           controller.client)
    dev = resolve_device(device)
    gpu_ops = env_mod.get_str(env_mod.HOROVOD_GPU_OPERATIONS,
                              "nccl").lower()
    uuids = []
    if dev.type == "cuda" and gpu_ops == "nccl":
        uuids = _exchange_device_uuids(controller.client, proc, num_procs,
                                       dev, round_id)
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
    # processes on one host share its local-rank space
    _host_of_rank = [host_of_proc[p] for p in range(num_procs)
                     for _ in range(counts[p])]
    return Engine(rpp, dev, config=config, controller=controller,
                  rank_offset=sum(counts[:proc]), global_size=sum(counts),
                  world_group=dist.group.WORLD,
                  compiled_group=compiled_group,
                  ranks_of_proc=ranks_of_proc, vote_group=vote_group,
                  chaos=chaos, topology=Topology(size=sum(counts),
                                                 host_of_rank=_host_of_rank))


def _install_chaos(config, proc, rank_offset, num_local, client=None):
    """The seeded fault plan's injector for this process (basics.py:
    373-400 of the JAX package), or None without a plan.  Installed
    before the engine exists, so request-count triggers see every fabric
    request, and hooked into the controller's client (wire faults); the
    engine takes it for ``slow_rank`` and ``hang``.  An elastic re-init
    or a second init in one process rebinds the one injector to the
    process's new index and rank threads, so its trigger counters span
    the process's life.  A malformed plan, or one naming a kind the port
    has not ported, raises here: a fault test whose faults never
    installed would pass vacuously."""
    if not config.fault_plan:
        return None
    from .. import chaos as chaos_mod
    plan = chaos_mod.plan_from_env()
    if plan is None or not plan.events:
        return None
    return chaos_mod.install(plan, proc=proc, rank_offset=rank_offset,
                             num_local=num_local, client=client)


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
            n = num_ranks or 1
            _engine = Engine(n, resolve_device(device), config=config,
                             chaos=_install_chaos(config, 0, 0, n))
            _host_of_rank = [0] * _engine.num_ranks
        _rebind_proc_ctx()
        _bind_thread_if_unbound()
        _register_exit_teardown()
        if process_sets:
            from . import process_sets as ps_mod
            for ps in process_sets:
                ps_mod.add_process_set(ps)


def _register_exit_teardown():
    """Tear the runtime down at interpreter exit when the script did not.
    A worker that returns from its training function without
    ``shutdown()`` otherwise exits with its engine thread, its heartbeat
    thread and its gloo process group alive: the coordinator reads the
    silence as a death, and gloo's destructor can abort the process
    (``terminate called without an active exception``, exit -6), which
    the elastic driver would take for a failed worker.  ``atexit`` runs
    while daemon threads still run, so the teardown joins the engine
    thread, says goodbye to the coordinator and destroys the group."""
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(_exit_teardown)


def _exit_teardown():
    try:
        shutdown()
    except Exception:  # noqa: BLE001 — the interpreter is exiting
        pass


def _bind_thread_if_unbound():
    global _proc_ctx
    if getattr(_tls, "ctx", None) is None and _engine is not None \
            and _engine.num_local == 1:
        _tls.ctx = RankContext(_engine.rank_offset)
        if _proc_ctx is None:
            _proc_ctx = _tls.ctx


def _rebind_proc_ctx():
    """After a re-init of a one-rank process: the first context of the
    earlier init takes the new rank (and restarts its op names, as a new
    process's would) and is bound to this thread."""
    if _proc_ctx is not None and _engine.num_local == 1:
        _proc_ctx.rank = _engine.rank_offset
        _proc_ctx._counters.clear()
        _tls.ctx = _proc_ctx


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


def needs_exec_restart():
    """True when recovery needs a fresh process (basics.py:478 of the
    JAX package, whose distributed client cannot outlive a peer's
    death): the engine aborted while NCCL carries this process's CUDA
    tensors, and a NCCL communicator whose peer died cannot be torn down
    in place.  Gloo groups can, so an aborted gloo job re-initializes
    in place."""
    if _engine is None or _engine._aborted is None or not _dist_up \
            or _engine.device.type != "cuda":
        return False
    return env_mod.get_str(env_mod.HOROVOD_GPU_OPERATIONS,
                           "nccl").lower() == "nccl"


def take_teardown_wedged():
    """True (once) when the last :func:`shutdown` left an engine thread
    blocked in a collective (basics.py:490-498 of the JAX package): the
    process group it blocks in cannot be destroyed under it, so the
    elastic reset exec-restarts this worker."""
    global _teardown_wedged
    wedged, _teardown_wedged = _teardown_wedged, False
    return wedged


def shutdown():
    """Stop the engine (a multi-process one says goodbye to the
    coordinator first) and destroy the process group init() made.  An
    engine thread that outlives the teardown's bound (blocked in a
    collective with a peer that left) keeps its group: it is flagged
    for :func:`take_teardown_wedged` instead."""
    global _engine, _host_of_rank, _dist_up, _teardown_wedged
    with _state_lock:
        if _engine is None:
            return
        from ..ops.compiled import reset_compiled_state
        from . import process_sets as ps_mod

        # a re-init at another world size must never serve an old program
        reset_compiled_state()
        ps_mod._reset()
        _engine.shutdown()
        wedged = _engine.wedged
        _engine = None
        _host_of_rank = None
        _tls.ctx = None
        if _dist_up:
            _dist_up = False
            if wedged:
                import logging
                logging.getLogger("horovod_tpu_torch").warning(
                    "the engine thread is still blocked in a collective "
                    "after the teardown's bound; leaving its process group "
                    "(this worker exec-restarts into the next round)")
                _teardown_wedged = True
            else:
                dist.destroy_process_group()


# -- topology queries (reference operations.cc:996-1075), answered by the
#    Topology of the job's host map (the engine's ``topology``): ranks
#    sharing a host index are local to each other -------------------------

def rank():
    return context().rank


def size():
    return engine().num_ranks


def _topology():
    return Topology(size=len(_host_of_rank), host_of_rank=list(_host_of_rank))


def local_rank():
    return _topology().local_rank(rank())


def local_size():
    return _topology().local_size(rank())


def cross_rank():
    """Rank among same-local-rank peers across hosts (reference
    cross_comm semantics): the hosts before this one that have a rank
    at this local index."""
    return _topology().cross_rank(rank())


def cross_size():
    return _topology().cross_size(rank())


def is_homogeneous():
    return _topology().is_homogeneous()


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
