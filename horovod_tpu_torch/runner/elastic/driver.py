"""Elastic driver (port of ``horovod_tpu/runner/elastic/driver.py``;
reference ``horovod/runner/elastic/driver.py:69-320`` ElasticDriver):
discovery thread, rank/host assignment with ordering stability, worker
lifecycle, blacklisting, round (re-)rendezvous.

A membership change re-forms the job's ``torch.distributed`` process
group, so each round publishes a fresh store address (a new port on rank
0's host) plus the rank assignments to the KV store, and resets the
coordinator to the round; workers destroy their process group in place
and re-initialize against the new round, their state surviving in
memory as in the reference's gloo re-rendezvous.
"""

import json
import logging
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List

from ..hosts import HostInfo, get_host_assignments
from ..http.http_server import free_port as _free_port, local_ip
from ..proc_run import is_local, ssh_command
from .discovery import HostManager
from .registration import WorkerStateRegistry

logger = logging.getLogger("horovod_tpu_torch.elastic")

DISCOVER_HOSTS_FREQUENCY_SECS = 1.0
ROUND_KEY = "/elastic/round"
NOTIFY_KEY = "/elastic/notify"


class ElasticDriver:
    def __init__(self, server, discovery, min_np, max_np, command,
                 env=None, reset_limit=None, cooldown_range=None,
                 platform=None, verbose=False, on_event=None,
                 elastic_timeout=600):
        self._server = server            # RendezvousServer (KV + coord)
        self._host_manager = HostManager(discovery, cooldown_range)
        self._min_np = min_np
        self._max_np = max_np
        self._command = command
        self._env = env or {}
        self._platform = platform
        self._verbose = verbose
        # lifecycle event hook (reference ray/elastic_v2.py:402-470
        # callback queue): called with dicts like
        # {"event": "round_start", ...}; exceptions are logged, never
        # fatal to the driver
        self._on_event = on_event
        # bound on each round's (re-)initialization — how long workers
        # may take to rendezvous after a reset before the round is
        # declared stuck and restarted (reference --elastic-timeout,
        # launch.py: "timeout for elastic initialisation after
        # re-scaling the cluster"); never bounds healthy training
        self._elastic_timeout = elastic_timeout

        self._registry = WorkerStateRegistry(self, self._host_manager,
                                             reset_limit=reset_limit)
        # autoscale lever (serving/autoscale.py): rounds are sized
        # min(available slots, _target_np); starts wide open
        self._target_np = max_np
        # multi-caller lever arbitration (docs/fleet.md): once an
        # owner claims the lever (the fleet controller), calls from
        # other writers are ignored, and a tagged write with a stale
        # epoch loses to the last accepted one — two racing callers
        # serialize into last-writer-wins instead of ping-ponging the
        # fleet through competing rounds
        self._lever_owner = None
        self._lever_epoch = -1
        # preemption-to-zero (docs/fleet.md "Suspension"): a suspended
        # job keeps its control plane (server, journal, spill) but
        # forms no rounds and drains its workers at a commit boundary
        self._suspended = False
        self._round = 0
        self._round_started_at = 0.0
        self._assignments: Dict[str, int] = {}
        self._slots_by_key: Dict[str, object] = {}  # "host:slot" -> SlotInfo
        self._worker_servers: Dict[str, tuple] = {}
        self._procs: Dict[str, subprocess.Popen] = {}  # "host:slot" -> p
        self._deassigned: Dict[str, float] = {}        # key -> deadline
        self._churn_respawns: Dict[str, int] = {}
        # procs the coordinator's liveness scan declared dead that the
        # monitor already acted on this round (missed-heartbeat feed —
        # catches HUNG workers that never exit; docs/fault_tolerance)
        self._dead_handled: set = set()
        # slots whose worker exited 0 in the current round: the job is
        # finishing, and such a slot is never spawned again
        self._finished_slots: set = set()
        self._notify_version = 0
        # committed worker state spills here so crash recovery can
        # restore it across process restarts
        self._spill_dir = tempfile.mkdtemp(prefix="hvd_elastic_state_")

        self._shutdown = threading.Event()
        self._error = False
        self._lock = threading.RLock()
        self._discovery_thread = threading.Thread(
            target=self._discover_hosts, daemon=True,
            name="elastic-discovery")
        self._monitor_thread = threading.Thread(
            target=self._monitor_workers, daemon=True,
            name="elastic-monitor")

    # -- lifecycle -----------------------------------------------------------

    def start(self, start_timeout=None):
        """``start_timeout`` bounds the wait for min_np slots (the
        reference's --start-timeout semantics); it does NOT bound job
        runtime."""
        self.wait_for_available_slots(
            self._min_np,
            timeout=120 if start_timeout is None else start_timeout)
        self._start_round()
        self._discovery_thread.start()
        self._monitor_thread.start()

    def wait_for_available_slots(self, min_np, timeout=120):
        deadline = time.monotonic() + timeout
        while True:
            # availability is checked at least once, so timeout=0 means
            # "fail fast unless slots are ALREADY available"
            self._host_manager.update_available_hosts()
            if self._host_manager.current_hosts.count_available_slots() \
                    >= min_np:
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"timed out waiting for {min_np} slots to become "
                    f"available")
            time.sleep(DISCOVER_HOSTS_FREQUENCY_SECS)

    def join(self, timeout=None) -> bool:
        """Block until the job finishes; True on success.  ``timeout``
        (if given) bounds total runtime — normal jobs pass None; the
        startup wait is bounded separately in start()."""
        deadline = time.monotonic() + timeout if timeout else None
        while not self._shutdown.is_set():
            if deadline and time.monotonic() > deadline:
                self.stop(error=True)
                raise TimeoutError("elastic job timed out")
            time.sleep(0.1)
        self._terminate_all()
        # the job is over: its spilled commits have no reader left
        shutil.rmtree(self._spill_dir, ignore_errors=True)
        return not self._error

    def finished(self):
        return self._shutdown.is_set()

    def stop(self, error=False):
        with self._lock:
            self._error = self._error or error
            self._shutdown.set()

    def resume(self):
        """Registry decided to start a new round (some workers failed
        or membership changed)."""
        with self._lock:
            if not self._shutdown.is_set():
                self._start_round()

    def _emit(self, event, **fields):
        if self._on_event is None:
            return
        try:
            self._on_event({"event": event, **fields})
        except Exception:  # noqa: BLE001 — user callback bug
            logger.exception("elastic event callback failed (%s)", event)

    # -- round management ----------------------------------------------------

    def _compute_assignments(self) -> List:
        hosts = self._host_manager.current_hosts
        host_infos = [HostInfo(h, hosts.host_slots[h])
                      for h in hosts.host_assignment_order]
        np = min(hosts.count_available_slots(), self._target_np)
        return get_host_assignments(host_infos, np)

    def current_world_size(self) -> int:
        """Workers in the current round (0 before the first forms)."""
        with self._lock:
            return len(self._assignments)

    def refresh_hosts(self) -> bool:
        """Synchronously re-poll discovery; True when membership
        changed.  The fleet controller calls this right after moving a
        job's placement view so the set_target_np that follows
        computes its effective size against the NEW hosts instead of
        the discovery thread's 1s-cadence cache (a shrink racing the
        cache would otherwise form a transient round on a host the
        controller just revoked).  Cheap for in-memory discoveries
        (FleetDiscovery); script-based discoveries pay one script run."""
        return self._host_manager.update_available_hosts()

    def acquire_target_lever(self, owner: str):
        """Claim exclusive ownership of the ``set_target_np`` lever
        (docs/fleet.md): after this, only calls tagged with ``owner``
        move the target — a per-job autoscaler racing the fleet
        controller is serialized out instead of re-forming rounds the
        fleet immediately undoes."""
        with self._lock:
            self._lever_owner = owner

    def release_target_lever(self):
        with self._lock:
            self._lever_owner = None
            self._lever_epoch = -1

    def set_target_np(self, target: int, owner: str = None,
                      epoch: int = None) -> int:
        """Autoscale lever (serving/autoscale.py): retarget the fleet
        to ``target`` workers, clamped to [min_np, max_np], and
        re-form the round exactly like a membership change — scale-up
        claims available slots, scale-down de-assigns workers (they
        get the usual drain grace before termination).  Returns the
        accepted target (the CURRENT target when the write was
        rejected).  A no-op target keeps the current round.

        Multi-caller arbitration: when an owner holds the lever
        (:meth:`acquire_target_lever`), writes from anyone else are
        ignored; ``epoch``-tagged writes are last-writer-wins — a
        write whose epoch is below the last accepted one is stale and
        dropped (two callers racing the lever resolve to the newest
        decision instead of interleaving rounds)."""
        with self._lock:
            if self._lever_owner is not None and \
                    owner != self._lever_owner:
                logger.info(
                    "set_target_np(%s) from %r ignored: lever owned "
                    "by %r", target, owner, self._lever_owner)
                return self._target_np
            if epoch is not None:
                if epoch < self._lever_epoch:
                    logger.info(
                        "set_target_np(%s) epoch %d is stale "
                        "(last accepted %d); dropped", target, epoch,
                        self._lever_epoch)
                    return self._target_np
                self._lever_epoch = epoch
            target = max(self._min_np, min(int(target), self._max_np))
            if target == self._target_np:
                return target
            prev, self._target_np = self._target_np, target
            # only re-form a live round (round 0 = driver not started:
            # start() will size its first round off the new target),
            # and only when the EFFECTIVE size actually moves — a
            # scale-up with no free slots must not bounce every
            # replica through a re-rendezvous for zero capacity gain
            # (the discovery thread starts the bigger round when new
            # hosts appear; _compute_assignments reads the target)
            effective = min(
                self._host_manager.current_hosts
                    .count_available_slots(), target)
            changed = self._round > 0 and \
                effective != len(self._assignments)
        logger.info("autoscale target: %d -> %d workers", prev, target)
        self._emit("autoscale_target", target=target, previous=prev)
        if changed and not self._shutdown.is_set():
            self._start_round()
        return target

    # -- suspension (docs/fleet.md "Suspension"): preemption to zero is
    #    a control-plane pause, not a restart ------------------------------

    @property
    def suspended(self) -> bool:
        return self._suspended

    def suspend(self, drain_grace: float = 30.0):
        """Preempt the job to ZERO workers while keeping its control
        plane: publish a ``suspended`` round so every worker drains at
        its next commit boundary (the committed state is already in
        the spill; the worker self-aborts cleanly — see
        ``basics._elastic_rendezvous``), journal the transition through
        the coordinator (a ``reset`` at size 0 — a later
        journal-restarted coordinator restores into the suspended
        shape), and stop forming rounds until :meth:`unsuspend`.
        Workers that miss the drain grace are terminated; their state
        survives in the spill either way."""
        with self._lock:
            if self._suspended:
                return
            self._suspended = True
            self._round += 1
            self._assignments = {}
            self._slots_by_key = {}
            round_info = {"round": self._round, "size": 0,
                          "suspended": True, "assignments": {}}
            self._server.store.put(ROUND_KEY,
                                   json.dumps(round_info).encode())
            self._notify_version += 1
            self._server.store.put(
                NOTIFY_KEY,
                json.dumps({"version": self._notify_version,
                            "round": self._round,
                            "suspended": True}).encode())
            # flush the suspension into the coordinator journal: the
            # round reset is a journaled transition, so a coordinator
            # (or fleet-controller) restart while suspended rebuilds
            # the paused control plane, not a live round
            self._server.coordinator.reset(world_size=0,
                                           round_id=self._round)
            now = time.monotonic()
            for key, p in list(self._procs.items()):
                if p.poll() is None:
                    self._deassigned.setdefault(key, now + drain_grace)
        logger.warning("job suspended at round %d (workers draining "
                       "at their next commit)", self._round)
        self._emit("suspend", round=self._round)

    def unsuspend(self):
        """Resume a suspended job: re-form a round from the current
        target + discovery.  Fresh workers restore the last elastic
        commit from the spill, and the coordinator's journal/epoch
        machinery fences any restart that happened while paused — the
        resumed job continues from the committed step."""
        with self._lock:
            if not self._suspended:
                return
            self._suspended = False
        logger.warning("job resuming from suspension")
        self._emit("resume", round=self._round)
        self._host_manager.update_available_hosts()
        self._start_round()

    def _start_round(self):
        with self._lock:
            if self._suspended:
                return
            # reap first, then decide: a worker that already exited is
            # recorded before the round is formed.  A survivor that
            # finished (exit 0) between two rounds would otherwise read
            # as a dead slot and be respawned, and its successor would
            # restore the last commit and train its steps a second time
            rid = self._registry.last_rendezvous()
            failed_hosts = self._reap_exits_locked(time.monotonic())
            if self._shutdown.is_set() or \
                    self._registry.last_rendezvous() != rid:
                # the reap completed the registry: the job ended, or the
                # registry's resume already formed the next round
                return
            if self._finished_slots:
                # a worker of this round exited 0: the job is finishing.
                # No new round; once no worker of the round is left the
                # job ends (all successes already stopped it through the
                # registry, so what remains is a failure after a success)
                if not any(p.poll() is None
                           for key, p in self._procs.items()
                           if key in self._assignments):
                    logger.error("a worker finished while another "
                                 "failed; ending the job")
                    self.stop(error=True)
                return
            if failed_hosts:
                for host in failed_hosts:
                    self._host_manager.blacklist(host)
                if not self._registry.note_reset():
                    self.stop(error=True)
                    return
                self._host_manager.update_available_hosts()
            slots = self._compute_assignments()
            if len(slots) < self._min_np:
                logger.warning(
                    "only %d slots available (< min_np %d); waiting",
                    len(slots), self._min_np)
                return
            assignments = {
                f"{s.hostname}:{s.local_rank}": s.rank for s in slots}
            if not failed_hosts and assignments == self._assignments \
                    and all(key in self._procs
                            and self._procs[key].poll() is None
                            for key in assignments):
                # the discovery thread catching up with a change the
                # current round already took in (a blacklist the
                # monitor's round applied): the same live workers at the
                # same ranks form no new round
                return
            self._round += 1
            self._assignments = assignments
            self._slots_by_key = {
                f"{s.hostname}:{s.local_rank}": s for s in slots}
            size = len(slots)
            # routable addresses when the round spans hosts: rendezvous
            # lives here; the torch.distributed store on rank 0's host
            # (same rule as proc_run.launch_procs)
            any_remote = any(not is_local(s.hostname) for s in slots)
            self._rdv_addr = local_ip() if any_remote else "127.0.0.1"
            rank0_host = slots[0].hostname
            coord_host = self._rdv_addr if is_local(rank0_host) \
                else rank0_host
            coordinator = f"{coord_host}:{_free_port()}"
            self._registry.reset(size)
            self._server.coordinator.reset(world_size=size,
                                           round_id=self._round)
            round_info = {
                "round": self._round,
                "size": size,
                "coordinator": coordinator,
                "assignments": self._assignments,
            }
            self._server.store.put(ROUND_KEY,
                                   json.dumps(round_info).encode())
            self._notify_version += 1
            self._server.store.put(
                NOTIFY_KEY,
                json.dumps({"version": self._notify_version,
                            "round": self._round}).encode())
            logger.info("round %d: %d workers %s", self._round, size,
                        self._assignments)
            self._emit("round_start", round=self._round, size=size,
                       assignments=dict(self._assignments))
            self._round_started_at = time.monotonic()
            self._churn_respawns.clear()
            self._dead_handled.clear()
            self._finished_slots.clear()
            # spawn processes for slots without a live worker (every
            # exit was reaped above, so a slot without one lost it)
            for key in self._assignments:
                p = self._procs.get(key)
                self._deassigned.pop(key, None)
                if p is None or p.poll() is not None:
                    self._spawn_worker(key)
            # de-assigned workers get a grace period to exit cleanly
            # (they participate in the old round's shutdown barrier,
            # then park in rendezvous wait) before being terminated
            for key, p in list(self._procs.items()):
                if key not in self._assignments and p.poll() is None:
                    self._deassigned.setdefault(
                        key, time.monotonic() + 30.0)

    def _spawn_worker(self, key):
        host, slot = key.rsplit(":", 1)
        env = dict(os.environ)
        env.update(self._env)
        # elastic workers derive topology from the rendezvous, not a
        # static host map — a stale inherited value would mislead them
        env.pop("HOROVOD_TPU_HOST_OF_RANK", None)
        env.update({
            "HOROVOD_ELASTIC": "1",
            "HOROVOD_CONTROLLER": "http",
            "HOROVOD_CPU_OPERATIONS": "gloo",
            "HOROVOD_HOSTNAME": host,
            "HOROVOD_LOCAL_RANK": slot,
            "HOROVOD_GLOO_RENDEZVOUS_ADDR": getattr(
                self, "_rdv_addr", "127.0.0.1"),
            "HOROVOD_GLOO_RENDEZVOUS_PORT": str(self._server.port),
            "HOROVOD_SECRET_KEY": self._server.secret.hex()
            if self._server.secret else "",
            "HOROVOD_TPU_RANKS_PER_PROC": "1",
            # fail fast out of a stale round's rendezvous so the
            # respawn picks up the current one
            "HOROVOD_TPU_INIT_TIMEOUT": "20",
            # crash-durable commit spill (common/elastic.py)
            "HOROVOD_STATE_SPILL": self._spill_dir,
        })
        if self._platform == "cpu":
            env["HOROVOD_TORCH_PLATFORM"] = "cpu"
        if self._verbose:
            logger.info("spawning worker %s", key)
        self._emit("worker_start", host=host, slot=int(slot),
                   round=self._round)
        if is_local(host):
            self._procs[key] = subprocess.Popen(self._command, env=env)
        else:
            # remote slot: same ssh + stdin env handoff as the static
            # launcher (proc_run.ssh_command).  The Popen handle tracks
            # the ssh client; terminating it drops the connection and
            # sshd delivers SIGHUP to the remote worker.
            cmd, payload = ssh_command(host, self._command, env,
                                       cwd=os.getcwd(),
                                       extra_keys=set(self._env))
            p = subprocess.Popen(cmd, env=dict(os.environ),
                                 stdin=subprocess.PIPE)
            try:
                p.stdin.write(payload)
                p.stdin.close()
            except (BrokenPipeError, OSError):
                # ssh died instantly (unreachable host, auth failure):
                # leave the dead Popen in _procs so the monitor thread
                # reaps it and blacklists the host like any worker exit
                logger.warning("ssh to %s closed before env handoff",
                               host)
            self._procs[key] = p

    # -- background threads --------------------------------------------------

    def _discover_hosts(self):
        while not self._shutdown.is_set():
            try:
                changed = self._host_manager.update_available_hosts()
            except Exception:  # noqa: BLE001 — discovery script hiccup
                logger.exception("host discovery failed")
                changed = False
            if changed:
                logger.info("host membership changed: %s",
                            self._host_manager.current_hosts.host_slots)
                self._emit(
                    "hosts_updated",
                    hosts=dict(
                        self._host_manager.current_hosts.host_slots))
                self._start_round()
            self._shutdown.wait(DISCOVER_HOSTS_FREQUENCY_SECS)

    # -- reference per-worker rendezvous verbs (driver.py:200-260;
    #    consumed by elastic/rendezvous.py's handler adapter) ----------------

    def record_ready(self, host, local_rank):
        """A worker at ``host:local_rank`` reached rendezvous
        (reference driver.py record_ready).  The KV path records this
        via /elastic/joined markers; this direct form feeds the same
        registry.  Rank AND round are resolved under one lock so a
        concurrent ``_start_round`` cannot stamp the marker into the
        wrong round."""
        with self._lock:
            rank = self._assignments.get(f"{host}:{local_rank}")
            round_id = self._round
        if rank is not None:
            self._server.store.put(
                f"/elastic/joined/{round_id}/{rank}", b"1")

    def get_slot_info(self, host, local_rank):
        """SlotInfo for a worker slot in the current round (reference
        driver.py get_slot_info); INVALID for unassigned slots.
        Served from the allocator's own slot table (``_slots_by_key``,
        recorded at round start) so cross/local ranks always match the
        published round."""
        from ..common.util.hosts import INVALID_SLOT_INFO

        with self._lock:
            return self._slots_by_key.get(f"{host}:{local_rank}",
                                          INVALID_SLOT_INFO)

    def register_worker_server(self, host, local_rank, addresses,
                               secret_key):
        """Store a worker's notification-service address (reference
        driver.py register_worker_server) so the driver can push
        HostsUpdatedRequests over TCP in addition to the KV bump."""
        with self._lock:
            self._worker_servers[f"{host}:{local_rank}"] = \
                (addresses, secret_key)

    def get_worker_client(self, slot_info):
        """WorkerNotificationClient for a registered worker, or None
        (reference driver.py get_worker_client)."""
        from .worker import WorkerNotificationClient

        with self._lock:
            entry = self._worker_servers.get(
                f"{slot_info.hostname}:{slot_info.local_rank}")
        if entry is None:
            return None
        addresses, key = entry
        return WorkerNotificationClient(addresses, key,
                                        verbose=self._verbose)

    def _round_joined(self):
        """How many of this round's workers picked up the rendezvous
        (the /elastic/joined markers workers write on re-init)."""
        store = self._server.store
        return sum(
            1 for rank in range(len(self._assignments))
            if store.get(f"/elastic/joined/{self._round}/{rank}",
                         timeout=0.01) is not None)

    def _check_round_formation(self, now):
        """A round whose workers never all rendezvous within
        elastic_timeout is stuck (hung worker, stale state): terminate
        its processes and start a fresh round, burning one reset
        (reference --elastic-timeout role, launch.py)."""
        if not self._elastic_timeout or not self._assignments:
            return
        if (now - self._round_started_at) <= self._elastic_timeout:
            return
        joined = self._round_joined()
        size = len(self._assignments)
        if joined >= size:
            return
        logger.warning(
            "round %d never formed within %.0fs (%d/%d workers "
            "rendezvoused); restarting the round", self._round,
            self._elastic_timeout, joined, size)
        with self._lock:
            for key in list(self._assignments):
                p = self._procs.pop(key, None)
                if p is not None and p.poll() is None:
                    p.terminate()
                    try:
                        p.wait(timeout=5)
                    except subprocess.TimeoutExpired:
                        p.kill()
            if not self._registry.note_reset():
                self.stop(error=True)
                return
            self._host_manager.update_available_hosts()
            self._start_round()

    def _reap_exits_locked(self, now):
        """Record every worker exit that is already visible (``poll()``
        is not None) and return the hosts of the failed ones.  Each exit
        is reaped once: its worker leaves ``_procs`` here.  Both the
        monitor and :meth:`_start_round` reap first, so a round is never
        decided on a slot whose exit is visible but unrecorded.  Must
        hold the lock."""
        failed_hosts = []
        exits = [(key, p.poll()) for key, p in list(self._procs.items())
                 if p.poll() is not None]
        # successes first: a round with a finished worker is finishing,
        # and a peer's abort seen in the same pass is then no churn
        exits.sort(key=lambda kc: kc[1] != 0)
        for key, code in exits:
            del self._procs[key]
            if key in self._deassigned:
                self._deassigned.pop(key, None)
                continue       # expected exit of a removed slot
            host, slot = key.rsplit(":", 1)
            self._emit("worker_exit", host=host,
                       slot=int(slot), code=code,
                       round=self._round)
            in_churn = (now - self._round_started_at) < 25.0
            churns = self._churn_respawns.get(key, 0)
            is_churn_exit = code in (-6, 134) or \
                (code == 1 and in_churn)
            if code == 0:
                self._finished_slots.add(key)
                self._registry.record_success(host, int(slot))
            elif is_churn_exit and churns < 10 and \
                    not self._finished_slots:
                # SIGABRT / early-round deaths are a worker that
                # lost its peers or its round while re-forming
                # (a process-group init that timed out, a stale
                # rendezvous): churn, not a bad host, so respawn
                # against the current round (committed state
                # restores from the spill).  Not once a peer of the
                # round finished: the job is done training, and a
                # respawn would train its last steps again
                logger.info("worker %s exited (%d) during "
                            "re-rendezvous churn; respawning",
                            key, code)
                self._churn_respawns[key] = churns + 1
                if key in self._assignments and \
                        not self._shutdown.is_set():
                    self._spawn_worker(key)
            else:
                logger.warning("worker %s exited with %d",
                               key, code)
                # distinct from worker_exit (which ALSO fires
                # for churn/clean exits): this is the event
                # consumers like the fleet controller treat as
                # a real slot failure (docs/fleet.md)
                self._emit("worker_failed", host=host,
                           slot=int(slot), code=code,
                           round=self._round)
                self._registry.record_failure(host, int(slot))
                failed_hosts.append(host)
        return failed_hosts

    def _monitor_workers(self):
        while not self._shutdown.is_set():
            failed_hosts = []
            now = time.monotonic()
            self._check_round_formation(now)
            rid_before = self._registry.last_rendezvous()
            with self._lock:
                # reap grace-expired de-assigned workers
                for key, deadline in list(self._deassigned.items()):
                    p = self._procs.get(key)
                    if p is None or p.poll() is not None:
                        self._procs.pop(key, None)
                        self._deassigned.pop(key, None)
                    elif now > deadline:
                        p.terminate()
                failed_hosts += self._reap_exits_locked(now)
                # coordinator liveness feed: a proc whose heartbeats
                # stopped but whose PROCESS never exited (hung worker,
                # network partition) would otherwise survive until the
                # stall timeout — reap it, fail its slot, blacklist
                # its host, exactly like an observed exit
                for proc, info in \
                        self._server.coordinator.dead_procs().items():
                    if proc in self._dead_handled:
                        continue
                    self._dead_handled.add(proc)
                    key = next((k for k, r in self._assignments.items()
                                if r == proc), None)
                    if key is None:
                        continue
                    p = self._procs.get(key)
                    if p is None or p.poll() is not None:
                        # the process also EXITED: the exit-code path
                        # above owns that failure — recording it here
                        # too would double-count one death
                        continue
                    host, slot = key.rsplit(":", 1)
                    logger.warning(
                        "worker %s (proc %d, global ranks %s) missed "
                        "heartbeats; treating as failed", key, proc,
                        info.get("ranks") or "unknown")
                    self._procs.pop(key, None)
                    p.kill()            # a hung process never exits
                    self._emit("worker_dead", host=host,
                               slot=int(slot), round=self._round,
                               ranks=info.get("ranks") or [])
                    self._registry.record_failure(host, int(slot))
                    failed_hosts.append(host)
            if failed_hosts and not self._shutdown.is_set() and \
                    self._registry.last_rendezvous() == rid_before:
                # a failure mid-run must not wait for survivors to
                # reach a terminal state — they are likely blocked in a
                # collective with the dead peer.  Blacklist and start a
                # new round now; survivors get a stale-round error and
                # re-rendezvous (reference driver.py:304-320
                # _handle_worker_exit -> blacklist -> new assignments).
                # (When record_failure completed the round, the registry
                # already blacklisted / consumed one reset / resumed —
                # last_rendezvous moved on, and burning a second reset
                # here would double-count one failure event.)
                for host in failed_hosts:
                    self._host_manager.blacklist(host)
                if not self._registry.note_reset():
                    self.stop(error=True)
                else:
                    self._host_manager.update_available_hosts()
                    self._start_round()
            self._shutdown.wait(0.2)

    def _terminate_all(self):
        with self._lock:
            for p in self._procs.values():
                if p.poll() is None:
                    p.terminate()
            t0 = time.monotonic()
            while time.monotonic() - t0 < 5:
                if all(p.poll() is not None for p in self._procs.values()):
                    break
                time.sleep(0.05)
            for p in self._procs.values():
                if p.poll() is None:
                    p.kill()


ELASTIC_TIMEOUT_SECS = 600


class Results:
    """Collected worker results for a run-function job (reference
    driver.py:39)."""

    def __init__(self, error_message, worker_results):
        self.error_message = error_message
        self.worker_results = worker_results


class ResultsRecorder:
    """Reference driver.py:45 — threads publishing per-worker results
    are registered with ``expect`` and joined at ``get_results``."""

    def __init__(self):
        import queue
        self._error_message = None
        self._worker_results = {}
        self._worker_threads = queue.Queue()

    def expect(self, worker_thread):
        self._worker_threads.put(worker_thread)

    def set_error_message(self, error_message):
        self._error_message = error_message

    def add_result(self, key, value):
        if key not in self._worker_results:
            self._worker_results[key] = value

    def get_results(self):
        while not self._worker_threads.empty():
            self._worker_threads.get().join()
        return Results(self._error_message, self._worker_results)
