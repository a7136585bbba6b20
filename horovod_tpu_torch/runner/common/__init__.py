"""Reference package path ``horovod.runner.common`` (port of
``horovod_tpu/runner/common``): shared runner utilities and the
pickled-message service framework."""
