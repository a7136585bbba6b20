"""Reference package path ``horovod.runner.util`` (port of
``horovod_tpu/runner/util``)."""
