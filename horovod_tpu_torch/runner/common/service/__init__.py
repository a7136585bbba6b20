"""Reference package path ``horovod.runner.common.service`` (port of
``horovod_tpu/runner/common/service``)."""
