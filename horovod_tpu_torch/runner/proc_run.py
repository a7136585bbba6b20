"""Static multi-process job launch (port of
``horovod_tpu/runner/proc_run.py``; reference ``horovod/runner/gloo_run.py``
launch_gloo: rendezvous server + per-slot process spawn with env handoff
:66-103,203-292).

The launcher hosts the rendezvous/coordinator HTTP service; worker
processes get their rank, topology and the service's address through
``HOROVOD_*`` env vars (the reference handoff's names, gloo_run.py:66-103
<-> gloo_context.cc:150-216).  Process 0 also hosts the
``torch.distributed`` store at ``HOROVOD_TPU_COORDINATOR``, where every
process's ``init_process_group`` meets (basics.init).

One rank per process: rank threads across processes (the JAX package's
``ranks_per_proc > 1`` and ``"host"`` layouts) are ROADMAP.md A24.
"""

import functools
import os
import secrets as _secrets
import shlex
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

from .hosts import SlotInfo, get_host_assignments, parse_hosts
from .http.http_server import (
    RendezvousServer, coordinator_kwargs, free_port as _free_port, local_ip,
)


_LOCAL_HOSTNAMES = ("localhost", "127.0.0.1")

#: Env prefixes forwarded to remote workers (reference gloo_run.py
#: forwards the filtered launcher env plus the HOROVOD_* handoff).
_REMOTE_ENV_PREFIXES = ("HOROVOD_", "TORCH_", "CUDA_", "NCCL_", "PYTHON",
                        "PATH", "LD_LIBRARY_PATH", "VIRTUAL_ENV")


@functools.lru_cache(maxsize=256)
def is_local(hostname: str) -> bool:
    """True when ``hostname`` addresses this machine (reference
    network.get_local_host_addresses check in gloo exec_command).
    Cached: an unresolvable name costs a full resolver timeout."""
    if hostname in _LOCAL_HOSTNAMES or hostname == socket.gethostname():
        return True
    try:
        addr = socket.gethostbyname(hostname)
    except OSError:
        return False
    return addr.startswith("127.") or addr == local_ip()


def ssh_command(hostname: str, command: List[str], env: dict,
                cwd: str = None, ssh_port: int = None, extra_keys=()):
    """Build the ssh invocation that runs ``command`` on ``hostname``
    (reference runner/util/remote.py get_remote_command + gloo
    exec_command).  Returns ``(argv, stdin_payload)``.  Only builds it:
    the launcher spawns local workers (see :func:`launch_procs`).

    The worker env, ``HOROVOD_SECRET_KEY`` included, travels on **stdin**
    (sourced by the remote shell), never in argv, so it is invisible to
    ``ps``/``/proc/*/cmdline`` on either host.  Besides the standard
    prefixes, keys named in ``extra_keys`` are always forwarded."""
    extra = set(extra_keys)
    payload = "".join(
        f"export {k}={shlex.quote(str(v))}\n"
        for k, v in sorted(env.items())
        if k.startswith(_REMOTE_ENV_PREFIXES) or k in extra)
    parts = []
    if cwd:
        parts.append(f"cd {shlex.quote(cwd)}")
    # source the env handoff from stdin, then exec the worker
    parts.append(". /dev/stdin && exec "
                 + " ".join(shlex.quote(c) for c in command))
    ssh = ["ssh", "-o", "StrictHostKeyChecking=no",
           "-o", "BatchMode=yes"]
    if ssh_port:
        ssh += ["-p", str(ssh_port)]
    return ssh + [hostname, " && ".join(parts)], payload.encode()


def host_of_rank_env(slots) -> str:
    """Comma-joined host-group index, one entry per process slot: lets
    workers rebuild the local/cross topology.  Groups come from the
    launcher's own slot assignment (a new group starts at each
    local_rank 0)."""
    hosts = []
    group = -1
    for s in sorted(slots, key=lambda s: s.rank):
        if s.local_rank == 0:
            group += 1
        hosts.append(str(group))
    return ",".join(hosts)


def slot_env(slot: SlotInfo, *, rdv_addr, rdv_port, coordinator,
             secret_hex, num_procs, ranks_per_proc=1, platform=None,
             host_of_rank=None):
    """Env handoff for one worker (reference gloo_run.py:66-103): the
    JAX package's keys, but for its platform keys (``JAX_PLATFORMS``,
    ``JAX_NUM_CPU_DEVICES``) the port's device and backend:
    ``HOROVOD_CPU_OPERATIONS=gloo``, and ``HOROVOD_TORCH_PLATFORM=cpu``
    under ``platform="cpu"`` (the launcher's ``--cpu``)."""
    env = {
        "HOROVOD_RANK": str(slot.rank),
        "HOROVOD_SIZE": str(slot.size),
        "HOROVOD_LOCAL_RANK": str(slot.local_rank),
        "HOROVOD_LOCAL_SIZE": str(slot.local_size),
        "HOROVOD_CROSS_RANK": str(slot.cross_rank),
        "HOROVOD_CROSS_SIZE": str(slot.cross_size),
        "HOROVOD_HOSTNAME": slot.hostname,
        "HOROVOD_CONTROLLER": "http",
        "HOROVOD_CPU_OPERATIONS": "gloo",
        "HOROVOD_GLOO_RENDEZVOUS_ADDR": rdv_addr,
        "HOROVOD_GLOO_RENDEZVOUS_PORT": str(rdv_port),
        "HOROVOD_SECRET_KEY": secret_hex,
        "HOROVOD_TPU_PROC_INDEX": str(slot.rank),
        "HOROVOD_TPU_NUM_PROCS": str(num_procs),
        "HOROVOD_TPU_RANKS_PER_PROC": str(ranks_per_proc),
        "HOROVOD_TPU_COORDINATOR": coordinator,
    }
    if host_of_rank:
        env["HOROVOD_TPU_HOST_OF_RANK"] = host_of_rank
    if platform == "cpu":
        env["HOROVOD_TORCH_PLATFORM"] = "cpu"
    return env


class ProcessPool:
    """Tracks spawned worker processes.  Training jobs terminate all on
    one failure (the reference's launcher kills the job when a worker
    dies); ``stop_on_failure=False`` lets survivors run on."""

    def __init__(self):
        self.procs: List[subprocess.Popen] = []

    def spawn(self, command, env, stdout=None, stderr=None,
              stdin_data: bytes = None):
        p = subprocess.Popen(
            command, env=env, stdout=stdout, stderr=stderr,
            stdin=subprocess.PIPE if stdin_data is not None else None)
        if stdin_data is not None:
            # deliver the payload and close so the remote shell sees EOF
            try:
                p.stdin.write(stdin_data)
                p.stdin.close()
            except (BrokenPipeError, OSError):
                # ssh died at once: keep the dead Popen so wait()
                # reports a clean launch failure
                pass
        self.procs.append(p)
        return p

    def wait(self, timeout=None, stop_on_failure=True) -> List[int]:
        deadline = time.monotonic() + timeout if timeout else None
        codes: List[Optional[int]] = [None] * len(self.procs)
        try:
            while any(c is None for c in codes):
                for i, p in enumerate(self.procs):
                    if codes[i] is None:
                        codes[i] = p.poll()
                        if codes[i] is not None and codes[i] != 0 \
                                and stop_on_failure:
                            self.terminate()
                if deadline and time.monotonic() > deadline:
                    self.terminate()
                    raise TimeoutError("job timed out")
                time.sleep(0.05)
        except KeyboardInterrupt:
            self.terminate()
            raise
        return [c if c is not None else -1 for c in codes]

    def terminate(self):
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        t0 = time.monotonic()
        while time.monotonic() - t0 < 5:
            if all(p.poll() is not None for p in self.procs):
                return
            time.sleep(0.05)
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass


def launch_procs(command: List[str], np: int, hosts: str = None,
                 ranks_per_proc: int = 1, env: dict = None,
                 platform: str = None, verbose: bool = False,
                 fusion_threshold_bytes: int = 64 * 1024 * 1024,
                 start_timeout: float = None,
                 output_filename: str = None,
                 stop_on_failure: bool = True):
    """Launch ``command`` once per slot, one rank per process, with the
    full env handoff; blocks until all workers exit and returns their
    exit codes.  ``start_timeout`` bounds the whole job: past it every
    worker is stopped and ``TimeoutError`` raised.

    ``output_filename``: directory for per-rank output capture, worker
    stdout/stderr in ``<dir>/rank.<NNN>/{stdout,stderr}`` (reference
    ``horovodrun --output-filename``, launch.py:332).

    Only local spawning is wired (subprocess); a remote host raises (the
    ssh command :func:`ssh_command` builds is what the reference's
    exec_command runs)."""
    if ranks_per_proc != 1:
        raise NotImplementedError(
            f"ranks_per_proc={ranks_per_proc!r}: rank threads across "
            f"processes (the hybrid layout) are not ported yet "
            f"(ROADMAP.md A24)")
    hosts = hosts or f"localhost:{np}"
    host_infos = parse_hosts(hosts)
    remote = [h.hostname for h in host_infos if not is_local(h.hostname)]
    if remote:
        raise NotImplementedError(
            f"remote hosts {remote}: the launcher spawns local workers "
            f"only")
    slots = get_host_assignments(host_infos, np)

    secret_hex = _secrets.token_hex(16)
    launcher_env = dict(os.environ)
    launcher_env.update(env or {})
    server = RendezvousServer(
        secret=bytes.fromhex(secret_hex), world_size=np,
        fusion_threshold_bytes=fusion_threshold_bytes,
        **coordinator_kwargs(launcher_env))
    rdv_port = server.start()
    rdv_addr = "127.0.0.1"
    # the torch.distributed store is hosted by PROCESS 0, on this host
    coordinator = f"{rdv_addr}:{_free_port()}"

    pool = ProcessPool()
    hof = host_of_rank_env(slots)
    out_files = []
    pad = max(3, len(str(max(np - 1, 0))))
    try:
        for slot in slots:
            child_env = dict(launcher_env)
            child_env.update(slot_env(
                slot, rdv_addr=rdv_addr, rdv_port=rdv_port,
                coordinator=coordinator, secret_hex=secret_hex,
                num_procs=np, platform=platform, host_of_rank=hof))
            if verbose:
                print(f"[horovodrun] rank {slot.rank} -> {command}",
                      file=sys.stderr)
            stdout = stderr = None
            if output_filename:
                d = os.path.join(output_filename,
                                 f"rank.{slot.rank:0{pad}d}")
                os.makedirs(d, exist_ok=True)
                stdout = open(os.path.join(d, "stdout"), "wb")
                stderr = open(os.path.join(d, "stderr"), "wb")
                out_files += [stdout, stderr]
            pool.spawn(command, child_env, stdout=stdout, stderr=stderr)
        codes = pool.wait(timeout=start_timeout,
                          stop_on_failure=stop_on_failure)
    finally:
        pool.terminate()
        server.stop()
        for f in out_files:
            f.close()
    return codes
