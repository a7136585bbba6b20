"""Process-tree-safe shell execution (port of
``horovod_tpu/runner/common/util/safe_shell_exec.py``; reference
``horovod/runner/common/util/safe_shell_exec.py``).

``execute`` runs a shell command in its own session (process group) so
termination reaps the whole tree — the property the launcher depends
on when one worker's death must take down the others (proc_run.py
ProcessPool uses the same discipline for worker processes).
"""

import datetime
import os
import signal
import subprocess
import sys
import threading
import time

GRACEFUL_TERMINATION_TIME_S = 5


def terminate_executor_shell_and_children(pid):
    """SIGTERM the process group of ``pid``, escalate to SIGKILL after
    GRACEFUL_TERMINATION_TIME_S (reference safe_shell_exec.py:33)."""
    try:
        pgid = os.getpgid(pid)
    except OSError:
        return
    try:
        os.killpg(pgid, signal.SIGTERM)
    except OSError:
        return
    deadline = time.monotonic() + GRACEFUL_TERMINATION_TIME_S
    while time.monotonic() < deadline:
        try:
            # group leader still alive?
            os.kill(pid, 0)
        except OSError:
            return
        time.sleep(0.1)
    try:
        os.killpg(pgid, signal.SIGKILL)
    except OSError:
        pass


def prefix_connection(src, dst_stream, prefix, index,
                      prefix_output_with_timestamp):
    """Copy lines from file object ``src`` to ``dst_stream``, prefixed
    ``[index]<prefix>`` and optionally timestamped (reference
    safe_shell_exec.py:83 — the driver's per-rank output labelling,
    also available via the launcher's --output-filename capture)."""
    for line in iter(src.readline, b""):
        text = line.decode("utf-8", errors="replace")
        tag = f"[{index}]<{prefix}>" if index is not None else ""
        if prefix_output_with_timestamp:
            tag = datetime.datetime.now().isoformat() + tag
        dst_stream.write(f"{tag}:{text}" if tag else text)
        dst_stream.flush()


def execute(command, env=None, stdout=None, stderr=None, index=None,
            events=None, prefix_output_with_timestamp=False):
    """Run ``command`` in a shell; returns the exit code.  ``events``
    (threading.Event objects) trigger tree termination when set
    (reference safe_shell_exec.py:188)."""
    capture = stdout is not None or stderr is not None or \
        prefix_output_with_timestamp or index is not None
    proc = subprocess.Popen(
        command, shell=True, env=env,
        stdout=subprocess.PIPE if capture else None,
        stderr=subprocess.PIPE if capture else None,
        start_new_session=True)

    pumps = []
    if capture:
        for src, dst, name in ((proc.stdout, stdout or sys.stdout,
                                "stdout"),
                               (proc.stderr, stderr or sys.stderr,
                                "stderr")):
            t = threading.Thread(
                target=prefix_connection,
                args=(src, dst, name, index,
                      prefix_output_with_timestamp),
                daemon=True)
            t.start()
            pumps.append(t)

    stop_watch = threading.Event()
    watchers = []
    for event in events or []:
        def _watch(ev=event):
            while not stop_watch.is_set():
                if ev.wait(0.1):
                    terminate_executor_shell_and_children(proc.pid)
                    return
        t = threading.Thread(target=_watch, daemon=True)
        t.start()
        watchers.append(t)

    try:
        proc.wait()
    finally:
        stop_watch.set()
        for t in pumps:
            t.join(timeout=2)
    return proc.returncode
