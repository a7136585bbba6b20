"""Reference package path ``horovod.runner.common.util`` (port of
``horovod_tpu/runner/common/util``)."""
