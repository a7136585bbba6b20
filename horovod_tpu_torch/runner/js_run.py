"""jsrun (LSF) launch surface (port of ``horovod_tpu/runner/js_run.py``;
reference ``horovod/runner/js_run.py``).  The port launches through its
own ``horovodrun`` only: detection is a real ``which jsrun`` probe, the
rankfile generator works from an LSF allocation's env, and ``js_run``
fails loudly with the supported launcher."""

import shutil

from .util.lsf import LSFUtils


def is_jsrun_installed():
    return shutil.which("jsrun") is not None


def generate_jsrun_rankfile(settings, path=None):
    """Explicit resource file for a jsrun launch (reference
    js_run.py:38), one line per host from the LSF allocation."""
    if not LSFUtils.using_lsf():
        raise RuntimeError(
            "generate_jsrun_rankfile requires an LSF allocation "
            "(LSB_JOBID not set)")
    import tempfile
    path = path or tempfile.mktemp(suffix=".rankfile")
    hosts = LSFUtils.get_compute_hosts()
    slots_total = settings.num_proc
    n_hosts = max(len(hosts), 1)
    base, rem = divmod(slots_total, n_hosts)
    with open(path, "w") as f:
        f.write("overlapping_rs: allow\ncpu_index_using: logical\n\n")
        rank = 0
        for i, host in enumerate(hosts):
            # first `rem` hosts carry one extra rank so every
            # requested rank lands in the file
            for _ in range(base + (1 if i < rem else 0)):
                f.write(f"rank: {rank}: {{ hostname: {host}; }}\n")
                rank += 1
    return path


def js_run(settings, nics, env, command, stdout=None, stderr=None):
    raise RuntimeError(
        "jsrun launch is not supported by horovod_tpu_torch. Use its "
        "launcher (python -m horovod_tpu_torch.runner.launch, or "
        "horovod_tpu_torch.runner.proc_run.launch_procs), which spawns "
        "workers over ssh/subprocess with the same env contract.")
