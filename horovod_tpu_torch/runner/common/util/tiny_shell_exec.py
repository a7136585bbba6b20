"""Capture-only shell execution (port of
``horovod_tpu/runner/common/util/tiny_shell_exec.py``; reference
``horovod/runner/common/util/tiny_shell_exec.py``)."""

import subprocess


def execute(command):
    """Run ``command`` in a shell; returns ``(output, exit_code)`` or
    None on failure to spawn."""
    try:
        proc = subprocess.run(
            command, shell=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
    except OSError:
        return None
    return proc.stdout.decode("utf-8", errors="replace"), proc.returncode
