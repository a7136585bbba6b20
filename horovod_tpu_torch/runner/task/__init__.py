"""Reference package path ``horovod.runner.task`` (port of
``horovod_tpu/runner/task``)."""
