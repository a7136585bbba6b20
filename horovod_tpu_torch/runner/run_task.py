"""Run-function worker entrypoint (port of ``horovod_tpu/runner/
run_task.py``; reference ``horovod/runner/run_task.py``): fetch the pickled function from the
launcher's KV store, execute it, publish the result under this rank.
Used by ``horovod.run``'s process-per-rank function mode."""

import sys

from .common.util.env import get_env_rank_and_size
from .http.http_client import (
    put_data_into_kvstore, read_data_from_kvstore,
)


def main(addr, port):
    func = read_data_from_kvstore(addr, port, "runfunc", "func")
    try:
        ret_val = func()
    except BaseException as e:
        sys.stderr.write(f"User function raise error: {e}")
        raise
    rank, _ = get_env_rank_and_size()
    put_data_into_kvstore(addr, port, "runfunc_result", str(rank),
                          ret_val)


if __name__ == "__main__":
    _, driver_addr, run_func_server_port_str = sys.argv
    main(driver_addr, int(run_func_server_port_str))
