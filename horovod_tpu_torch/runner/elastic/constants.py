"""Elastic constants (port of ``horovod_tpu/runner/elastic/constants.py``;
reference ``horovod/runner/elastic/constants.py``)."""

RESET_LIMIT_EXCEEDED_MESSAGE = (
    "Horovod detected that the maximum number of resets in the job "
    "has been exceeded (reset_limit={reset_limit}). Shutting down "
    "the job.")
