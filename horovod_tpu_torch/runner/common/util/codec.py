"""Base64 pickle codec (port of ``horovod_tpu/runner/common/util/codec.py``;
reference ``horovod/runner/common/util/codec.py``): passes functions and
settings through environment variables and command lines.  It uses
``cloudpickle`` where it is installed and ``pickle`` where it is not
(the GPU machines the port runs on need not have it)."""

import base64
import pickle


def _dumps(obj):
    try:
        import cloudpickle
        return cloudpickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    except ImportError:
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def dumps_base64(obj, to_ascii=True):
    serialized = base64.b64encode(_dumps(obj))
    return serialized.decode("ascii") if to_ascii else serialized


def loads_base64(encoded):
    return pickle.loads(base64.b64decode(encoded))
