"""Reference package path ``horovod.runner.driver`` (port of
``horovod_tpu/runner/driver``)."""
