"""Shared-secret helpers (port of ``horovod_tpu/runner/common/util/
secret.py``; reference ``horovod/runner/common/util/secret.py``): every
control-plane message is HMAC-signed with a per-job key, the same policy
the reference applies to its network services."""

import hmac
import hashlib
import secrets as _secrets

SECRET_LENGTH = 32
DIGEST_LENGTH = 32
HOROVOD_SECRET_KEY = "HOROVOD_SECRET_KEY"


def make_secret_key():
    return _secrets.token_bytes(SECRET_LENGTH)


def compute_digest(key, message):
    return hmac.new(key, message, hashlib.sha256).digest()


def check_digest(key, message, digest):
    return hmac.compare_digest(compute_digest(key, message), digest)
