"""Metric exposition: Prometheus text format v0.0.4 + JSON snapshots,
a per-worker stdlib HTTP endpoint, and the worker→coordinator push
loop that feeds the job-wide ``/metrics`` (a copy of
``horovod_tpu/telemetry/exporter.py``).

Three consumers share one snapshot format
(:meth:`..telemetry.registry.MetricRegistry.snapshot`):

* **per-worker scrape** — :class:`MetricsServer` serves this process's
  registry at ``/metrics`` (text) and ``/metrics.json``;
* **job-wide scrape** — each worker pushes its snapshot to the
  launcher's KV store (``/telemetry/<proc>``) and the coordinator's
  HTTP service merges + renders them on ITS ``/metrics``
  (runner/http/http_server.py), so one scrape covers the whole job;
* **in-process** — ``hvd.metrics()`` returns the snapshot dict.
"""

import json
import threading

from .registry import registry

__all__ = [
    "render_prometheus", "render_json", "MetricsServer",
    "start_metrics_server", "MetricsPusher", "TELEMETRY_KV_PREFIX",
    "CONTENT_TYPE_LATEST",
]

#: KV-store key prefix worker snapshots are pushed under.
TELEMETRY_KV_PREFIX = "/telemetry/"

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

_ESCAPES = {"\\": r"\\", "\n": r"\n", '"': r"\""}


def _escape(value):
    return "".join(_ESCAPES.get(c, c) for c in str(value))


def _fmt_value(v):
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 2 ** 53 \
        else repr(f)


def _fmt_labels(labels):
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def render_prometheus(snapshot):
    """Render a registry (or merged) snapshot as Prometheus text
    exposition format v0.0.4."""
    lines = []
    for name in sorted(snapshot):
        fam = snapshot[name]
        ftype = fam.get("type", "untyped")
        help_text = fam.get("help", "")
        if help_text:
            lines.append(f"# HELP {name} "
                         + help_text.replace("\\", r"\\")
                                    .replace("\n", r"\n"))
        lines.append(f"# TYPE {name} {ftype}")
        for sample in fam.get("samples", []):
            labels = sample.get("labels", {})
            if ftype == "histogram":
                bounds = fam.get("buckets", [])
                counts = sample.get("counts", [])
                acc = 0
                for bound, count in zip(bounds, counts):
                    acc += count
                    lines.append(
                        f"{name}_bucket"
                        + _fmt_labels({**labels,
                                       "le": _fmt_value(bound)})
                        + f" {acc}")
                total = sample.get("count", 0)
                lines.append(
                    f"{name}_bucket"
                    + _fmt_labels({**labels, "le": "+Inf"})
                    + f" {total}")
                lines.append(f"{name}_sum" + _fmt_labels(labels)
                             + f" {_fmt_value(sample.get('sum', 0.0))}")
                lines.append(f"{name}_count" + _fmt_labels(labels)
                             + f" {total}")
            else:
                lines.append(
                    name + _fmt_labels(labels)
                    + f" {_fmt_value(sample.get('value', 0.0))}")
    return "\n".join(lines) + "\n"


def render_json(snapshot, **meta):
    payload = {"families": snapshot}
    payload.update(meta)
    return json.dumps(payload)


class MetricsServer:
    """Per-worker exposition endpoint: a stdlib threading HTTP server
    answering ``GET /metrics`` (Prometheus text) and
    ``GET /metrics.json`` from the process-current registry, resolved
    at scrape time (an elastic re-init swapping the registry is picked
    up automatically)."""

    def __init__(self, port=0, addr="0.0.0.0", registry_fn=None):
        self.addr = addr
        self._port = port
        self._registry_fn = registry_fn or registry
        self._httpd = None
        self._thread = None

    def start(self):
        from http.server import BaseHTTPRequestHandler
        import socketserver

        registry_fn = self._registry_fn

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # silence
                pass

            def do_GET(self):
                path = self.path.partition("?")[0]
                if path in ("/metrics", "/"):
                    body = render_prometheus(
                        registry_fn().snapshot()).encode()
                    ctype = CONTENT_TYPE_LATEST
                elif path == "/metrics.json":
                    body = render_json(
                        registry_fn().snapshot()).encode()
                    ctype = "application/json"
                else:
                    body = b"not found"
                    self.send_response(404)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        class _Server(socketserver.ThreadingMixIn,
                      socketserver.TCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._httpd = _Server((self.addr, self._port), _Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="horovod_tpu_torch-metrics", daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    @property
    def port(self):
        return self._httpd.server_address[1] if self._httpd else None

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def start_metrics_server(port=0, addr="0.0.0.0"):
    """Start a per-worker metrics endpoint; returns the server (its
    ``.port`` is the bound port — useful with ``port=0``)."""
    server = MetricsServer(port=port, addr=addr)
    server.start()
    return server


class MetricsPusher:
    """Background thread pushing this worker's snapshot to the
    launcher's KV store every ``interval`` seconds (plus one final
    push on stop, so short jobs still land in the job-wide view).
    ``client`` is the StoreController's StoreClient — the existing
    KV fabric; no new connection or protocol."""

    def __init__(self, client, proc_id, interval=5.0, meta=None):
        self.client = client
        self.proc_id = proc_id
        self.interval = max(float(interval), 0.5)
        self.meta = dict(meta or {})
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="horovod_tpu_torch-metrics-push",
            daemon=True)

    def start(self):
        self._thread.start()
        return self

    def push_now(self, final=False):
        import time

        # ts lets snapshot consumers with liveness semantics (the
        # serving autoscaler's queue-depth gauge) age out a dead
        # worker's frozen last push; the /metrics merge keeps using
        # the round/proc guards instead (counters must survive)
        payload = render_json(registry().snapshot(),
                              proc=self.proc_id, ts=time.time(),
                              **self.meta)
        try:
            # the FINAL push races teardown: the rendezvous service
            # may already be gone, and the fabric's outage-spanning
            # retry budget would wedge clean worker exit for minutes —
            # one bounded retry, then drop the snapshot with a debug
            # log (docs/fault_tolerance.md)
            self.client.put(f"{TELEMETRY_KV_PREFIX}{self.proc_id}",
                            payload.encode(),
                            budget=(2, 2.0) if final else None)
        except Exception as exc:  # noqa: BLE001 — the coordinator may
            # be gone during teardown; telemetry must never kill (or
            # hang) a worker
            if final:
                import logging
                logging.getLogger("horovod_tpu_torch").debug(
                    "final metrics push dropped (coordinator gone): "
                    "%s", exc)

    def _loop(self):
        while not self._stop.wait(self.interval):
            self.push_now()
        self.push_now(final=True)   # final snapshot at shutdown

    def stop(self, timeout=5.0):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)
