"""Launcher parameter cache (port of ``horovod_tpu/runner/util/cache.py``;
reference ``horovod/runner/util/cache.py``): ``horovodrun`` caches the results
of expensive launch-time checks keyed by a hash of the run parameters,
invalidated by staleness or parameter change."""

import datetime
import os
import pickle
import threading


class Cache:
    def __init__(self, cache_folder,
                 cache_staleness_threshold_in_minutes, parameters_hash):
        self._cache_file = os.path.join(cache_folder, "cache.bin")
        os.makedirs(cache_folder, exist_ok=True)
        content = None
        if os.path.isfile(self._cache_file):
            try:
                with open(self._cache_file, "rb") as f:
                    content = pickle.load(f)
            except Exception:  # noqa: BLE001 — corrupt cache: rebuild
                try:
                    os.remove(self._cache_file)
                except OSError:
                    pass
        if not isinstance(content, dict) or \
                content.get("parameters_hash") != parameters_hash:
            content = {"parameters_hash": parameters_hash}
            self._dump(content)
        self._content = content
        self._staleness = datetime.timedelta(
            minutes=cache_staleness_threshold_in_minutes)
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            timestamp, val = self._content.get(key, (None, None))
        if timestamp and timestamp >= \
                datetime.datetime.now() - self._staleness:
            return val
        return None

    def put(self, key, val):
        with self._lock:
            self._content[key] = (datetime.datetime.now(), val)
            self._dump(self._content)

    def _dump(self, content):
        tmp = self._cache_file + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(content, f)
        os.replace(tmp, self._cache_file)


def use_cache():
    """Decorator factory: route a function through the active Cache
    when one is bound (reference cache.py use_cache — the launcher
    sets ``fn.cache``)."""
    def decorator(fn):
        def wrapper(*args, **kwargs):
            cache = getattr(wrapper, "cache", None)
            if cache is not None:
                key = pickle.dumps((fn.__name__, args,
                                    sorted(kwargs.items())))
                hit = cache.get(key)
                if hit is not None:
                    return hit
            result = fn(*args, **kwargs)
            if cache is not None and result is not None:
                cache.put(key, result)
            return result

        wrapper.cache = None
        wrapper.__name__ = fn.__name__
        return wrapper

    return decorator
