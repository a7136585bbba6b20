"""LSF scheduler detection (port of ``horovod_tpu/runner/util/lsf.py``;
reference ``horovod/runner/util/lsf.py``).  The port launches through
its own ``horovodrun`` only (runner/js_run.py refuses jsrun); the
detection predicate is real so ``horovodrun`` behaves correctly when a
script runs inside an LSF allocation anyway, and the query helpers fail
with an explicit message instead of silently returning wrong topology."""

import os


class LSFUtils:
    """LSF utilities (reference lsf.py:26)."""

    @staticmethod
    def using_lsf():
        """True when the current process was started by LSF."""
        return "LSB_JOBID" in os.environ

    @staticmethod
    def get_compute_hosts():
        """Hosts of this LSF allocation from LSB_HOSTS/LSB_MCPU_HOSTS
        (batch host excluded, duplicates collapsed in order)."""
        mcpu = os.environ.get("LSB_MCPU_HOSTS")
        if mcpu:
            toks = mcpu.split()
            return [h for h in toks[0::2]]
        hosts = os.environ.get("LSB_HOSTS", "").split()
        seen, out = set(), []
        for h in hosts:
            if h not in seen:
                seen.add(h)
                out.append(h)
        return out

    @staticmethod
    def get_num_processes():
        """Total slots in the allocation."""
        mcpu = os.environ.get("LSB_MCPU_HOSTS")
        if mcpu:
            toks = mcpu.split()
            return sum(int(n) for n in toks[1::2])
        return len(os.environ.get("LSB_HOSTS", "").split())

    @staticmethod
    def get_num_gpus():
        raise RuntimeError(
            "LSFUtils.get_num_gpus queries the IBM CSM stack, which "
            "the port does not use; a host's GPU count is "
            "torch.cuda.device_count().")

    @staticmethod
    def get_num_cores():
        return os.cpu_count() or 1

    @staticmethod
    def get_num_threads():
        return 1
