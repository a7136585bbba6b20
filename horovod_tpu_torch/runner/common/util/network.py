"""Pickled-message TCP service framework (port of
``horovod_tpu/runner/common/util/network.py``; reference
``horovod/runner/common/util/network.py``).

Request/response objects travel HMAC-signed over a TCP stream:
``digest (32B) | length (4B) | pickle body``.  ``BasicService``
dispatches typed requests in ``_handle``; ``BasicClient`` probes the
service's advertised addresses with a ping and uses whichever
responds.  The launcher's own control plane is the HMAC-HTTP KV store
(runner/http/) — this framework exists for the reference surfaces
built directly on it (driver/task/compute services, ray NIC probe) and
is fully functional.

All RPCs must be idempotent: the client retries on connection failure.
"""

import pickle
import queue
import shutil
import socket
import socketserver
import struct

from . import secret
from ...util.network import find_port, get_local_host_addresses
from ...util.threads import in_thread


class PingRequest:
    pass


def _intf_ipv4_addresses(intf):
    """IPv4 addresses bound to a REAL interface name, or None when the
    name does not resolve to a NIC on this host (pseudo keys like this
    framework's 'all' advertisement, or a platform without the
    ioctl).  stdlib-only (psutil is not required): SIOCGIFADDR."""
    try:
        names = {name for _, name in socket.if_nameindex()}
    except OSError:
        return None
    if intf not in names:
        return None
    try:
        import fcntl

        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            packed = fcntl.ioctl(
                s.fileno(), 0x8915,        # SIOCGIFADDR
                struct.pack("256s", intf.encode()[:15]))
            return {socket.inet_ntoa(packed[20:24])}
        finally:
            s.close()
    except (OSError, ImportError):
        return None


class NoValidAddressesFound(Exception):
    pass


class PingResponse:
    def __init__(self, service_name, source_address):
        self.service_name = service_name
        self.source_address = source_address


class AckResponse:
    """Response carrying no data."""


class AckStreamResponse:
    """Marker: a utf8 text stream follows the response."""


class Wire:
    """Message framing + HMAC (reference network.py:55-97)."""

    def __init__(self, key):
        self._key = key or b""

    def write(self, obj, wfile):
        from .codec import _dumps
        message = _dumps(obj)
        wfile.write(secret.compute_digest(self._key, message))
        wfile.write(struct.pack("i", len(message)))
        wfile.write(message)
        wfile.flush()

    def stream(self, stream, wfile):
        from encodings.utf_8 import StreamWriter
        shutil.copyfileobj(stream, StreamWriter(wfile))
        wfile.flush()

    def read(self, rfile):
        digest = rfile.read(secret.DIGEST_LENGTH)
        (length,) = struct.unpack("i", rfile.read(4))
        message = rfile.read(length)
        if not secret.check_digest(self._key, message, digest):
            raise RuntimeError(
                "Security error: digest did not match the message.")
        return pickle.loads(message)


class _DrainingTCPServer(socketserver.ThreadingTCPServer):
    """shutdown() must wait for in-flight request handlers — the
    reference's services guarantee a long-running RPC completes before
    the server goes away (test_service.py:122-173 contract)."""

    daemon_threads = False
    block_on_close = True
    allow_reuse_address = True


class BasicService:
    def __init__(self, service_name, key, nics=None):
        self._service_name = service_name
        self._wire = Wire(key)
        self._nics = nics
        self._server, self._port = find_port(
            lambda addr: _DrainingTCPServer(
                addr, self._make_handler()))
        self._addresses = {
            "all": [(a, self._port)
                    for a in sorted(get_local_host_addresses())]}
        self._thread = in_thread(self._server.serve_forever)

    def _make_handler(self):
        service = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    req = service._wire.read(self.rfile)
                    resp = service._handle(req, self.client_address)
                    if resp is None:
                        raise RuntimeError(
                            "Handler did not return a response.")
                    if isinstance(resp, tuple):
                        resp, stream = resp
                        service._wire.write(resp, self.wfile)
                        service._wire.stream(stream, self.wfile)
                    else:
                        service._wire.write(resp, self.wfile)
                except (EOFError, BrokenPipeError,
                        ConnectionResetError):
                    pass
                except RuntimeError as exc:
                    # bad digest: unauthorized caller — one log line,
                    # no traceback, connection dropped
                    import logging
                    logging.getLogger(__name__).warning(
                        "%s rejected request from %s: %s",
                        service._service_name, self.client_address,
                        exc)

        return _Handler

    def _handle(self, req, client_address):
        if isinstance(req, PingRequest):
            return PingResponse(self._service_name, client_address[0])
        raise NotImplementedError(req)

    def addresses(self):
        return {intf: list(addrs)
                for intf, addrs in self._addresses.items()}

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join()

    def get_port(self):
        return self._port


class BasicClient:
    def __init__(self, service_name, addresses, key, verbose=0,
                 match_intf=False, probe_timeout=20, attempts=3):
        self._service_name = service_name
        self._wire = Wire(key)
        self._verbose = verbose
        self._match_intf = match_intf
        self._probe_timeout = probe_timeout
        self._attempts = attempts
        self._addresses = self._probe(addresses)
        if not self._addresses:
            raise NoValidAddressesFound(
                f"Unable to connect to the {service_name} on any of "
                f"the addresses: {addresses}")

    def _probe(self, addresses):
        results = queue.Queue()
        threads = [in_thread(self._probe_one, (intf, addr, results))
                   for intf, addrs in addresses.items()
                   for addr in addrs]
        for t in threads:
            t.join()
        usable = {}
        while not results.empty():
            intf, addr = results.get()
            usable.setdefault(intf, []).append(addr)
        return usable

    def _probe_one(self, intf, addr, results):
        resp = self._try_request(addr, PingRequest(),
                                 probing=True)
        if resp is None or resp.service_name != self._service_name:
            return
        if self._match_intf:
            # reference network.py _probe_one: accept the address only
            # when the server saw our probe ARRIVE from an address of
            # the interface it was advertised under — i.e. the route
            # to ``addr`` actually leaves through ``intf``
            # (PingResponse.source_address is our address as the
            # server observed it).  Names that resolve to no NIC
            # (this framework's 'all' advertisement) carry no routing
            # claim and pass through unfiltered, and a source address
            # we cannot attribute to ANY interface (SIOCGIFADDR only
            # reports primaries, not aliases) is not evidence of a
            # wrong route — reject only a POSITIVE mismatch, a source
            # that is another NIC's address.
            local = _intf_ipv4_addresses(intf)
            if local is not None and resp.source_address not in local:
                others = set()
                try:
                    for _, name in socket.if_nameindex():
                        if name != intf:
                            others |= _intf_ipv4_addresses(name) or set()
                except OSError:
                    pass
                if resp.source_address in others:
                    return
        results.put((intf, addr))

    def _try_request(self, addr, req, probing=False, stream=None):
        attempts = 1 if probing else self._attempts
        for attempt in range(attempts):
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            # probe sockets are bounded; real RPCs block — several of
            # the protocol's requests legitimately wait minutes
            # (WaitForCommandExitCode, WaitForShutdown), and a timeout
            # retry would double-deliver or duplicate streamed output
            sock.settimeout(self._probe_timeout if probing else None)
            try:
                sock.connect(tuple(addr))
                rfile = sock.makefile("rb")
                wfile = sock.makefile("wb")
                try:
                    self._wire.write(req, wfile)
                    resp = self._wire.read(rfile)
                    if isinstance(resp, AckStreamResponse) and \
                            stream is not None:
                        shutil.copyfileobj(
                            _Utf8Reader(rfile), stream)
                    return resp
                finally:
                    rfile.close()
                    wfile.close()
            except (OSError, EOFError, struct.error):
                if attempt == attempts - 1:
                    if probing:
                        return None
                    # surface the raw connection error — callers (and
                    # the reference's tests) match on the errno text
                    raise
            finally:
                sock.close()
        return None

    def _send(self, req, stream=None):
        last_error = None
        for intf, addrs in self._addresses.items():
            for addr in addrs:
                try:
                    resp = self._try_request(addr, req, stream=stream)
                except (OSError, EOFError, struct.error) as exc:
                    # fail over to the next probed address; only the
                    # LAST address's failure surfaces (callers — and
                    # the reference's tests — match on the raw errno
                    # text)
                    last_error = exc
                    continue
                if resp is not None:
                    return resp
        if last_error is not None:
            raise last_error
        raise NoValidAddressesFound(
            f"{self._service_name} stopped responding on "
            f"{self._addresses}")

    def addresses(self):
        return {intf: list(addrs)
                for intf, addrs in self._addresses.items()}


class _Utf8Reader:
    """File-like over the socket's rfile decoding utf8 for stream
    responses."""

    def __init__(self, rfile):
        self._rfile = rfile

    def read(self, n=-1):
        data = self._rfile.read(n if n and n > 0 else 65536)
        return data.decode("utf-8", errors="replace") if data else ""
