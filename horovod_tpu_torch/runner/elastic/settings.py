"""Elastic launcher settings (port of
``horovod_tpu/runner/elastic/settings.py``; reference
``horovod/runner/elastic/settings.py``)."""

from ..common.util.settings import BaseSettings


class ElasticSettings(BaseSettings):
    def __init__(self, discovery, min_num_proc, max_num_proc,
                 elastic_timeout, reset_limit, cooldown_range=None,
                 **kwargs):
        super().__init__(elastic=True, **kwargs)
        self.discovery = discovery
        self.min_num_proc = min_num_proc
        self.max_num_proc = max_num_proc
        self.elastic_timeout = elastic_timeout
        self.reset_limit = reset_limit
        self.cooldown_range = cooldown_range
