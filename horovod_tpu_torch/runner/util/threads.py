"""Thread helpers (port of ``horovod_tpu/runner/util/threads.py``;
reference ``horovod/runner/util/threads.py``)."""

import queue
import threading


def in_thread(target, args=(), kwargs=None, name=None, daemon=True,
              silent=False):
    """Start ``target`` in a thread and return the thread (reference
    threads.py in_thread).  ``silent`` swallows exceptions."""
    if silent:
        inner = target

        def target(*a, **kw):  # noqa: F811
            try:
                inner(*a, **kw)
            except Exception:  # noqa: BLE001 — caller opted out
                pass

    t = threading.Thread(target=target, args=args, kwargs=kwargs or {},
                         name=name, daemon=daemon)
    t.start()
    return t


def execute_function_multithreaded(fn, args_list,
                                   block_until_all_done=True,
                                   max_concurrent_executions=1000):
    """Run ``fn`` over ``args_list`` on a bounded thread pool
    (reference threads.py:20).  Returns ``{index: result}`` when
    blocking, else None."""
    result_queue = queue.Queue()
    worker_queue = queue.Queue()
    for i, arg in enumerate(args_list):
        worker_queue.put((i, list(arg)))

    def worker():
        while True:
            try:
                index, arg = worker_queue.get(block=False)
            except queue.Empty:
                return
            try:
                result_queue.put((index, False, fn(*arg)))
            except BaseException as exc:  # noqa: BLE001 — re-raised
                # at collection; a silently missing index would
                # surface as a KeyError far from the real failure
                result_queue.put((index, True, exc))

    threads = [in_thread(worker, daemon=not block_until_all_done)
               for _ in range(min(max_concurrent_executions,
                                  len(args_list)))]
    if not block_until_all_done:
        return None
    # join with timeout so signals can interrupt
    while any(t.is_alive() for t in threads):
        for t in threads:
            t.join(0.1)
    results = {}
    first_error = None
    while not result_queue.empty():
        index, is_error, res = result_queue.get()
        if is_error:
            first_error = first_error or res
        else:
            results[index] = res
    if first_error is not None:
        raise first_error
    return results


def on_event(event, target, args=(), kwargs=None, daemon=True,
             stop=None):
    """Run ``target`` when ``event`` fires; ``stop`` (a second event)
    cancels the wait (reference threads.py on_event)."""
    def waiter():
        while True:
            if event.wait(0.1):
                target(*args, **(kwargs or {}))
                return
            if stop is not None and stop.is_set():
                return

    return in_thread(waiter, daemon=daemon)
