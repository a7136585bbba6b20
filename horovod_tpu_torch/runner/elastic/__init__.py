"""Elastic launcher (port of ``horovod_tpu/runner/elastic``; reference
``horovod/runner/elastic``): host discovery, the worker state registry,
the driver's rounds and the worker notifications."""
