"""Merge per-worker Chrome traces into one clock-aligned job trace (port
of ``horovod_tpu/utils/trace_merge.py``, with the command line of the JAX
package's ``tools/trace_merge.py``).

Each worker writes (or flight-records) its own Chrome trace on its own
private ``perf_counter`` epoch; this module is what turns those
unrelatable files into ONE Perfetto-loadable job trace:

* **clock alignment** — every worker trace carries a ``clock_sync``
  metadata record (utils/clock_sync.py) mapping its ts domain to the
  launcher's wall clock; the merger shifts every timestamped event by
  that offset, then normalizes the whole trace back to zero so viewers
  don't render epoch-microsecond axes;
* **pid lanes** — each worker's events already carry its pid (first
  global rank); the merger keeps them apart (remapping collisions from
  legacy pid-0 traces) so the merged trace shows one lane group per
  rank;
* **flow events** — the coordinator-minted trace ids ride through
  unchanged, so the ``s``/``f`` chains connect each rank's NEGOTIATE
  span to the collective across pid lanes — the straggler arrows.

Consumed offline through ``python -m horovod_tpu_torch.utils.trace_merge``
and live by the launcher's ``GET /timeline`` (flight-recorder buffers,
runner/http/http_server.py).

Usage::

    python -m horovod_tpu_torch.utils.trace_merge -o merged.json \
        tl.json tl.proc1.json
    python -m horovod_tpu_torch.utils.trace_merge worker*.json > merged.json
"""

import argparse
import json
import sys

__all__ = ["TRACE_KV_PREFIX", "load_trace", "merge_traces"]

#: KV-store key prefix worker flight-recorder dumps are pushed under
#: (``/trace/buf/<proc>``) — the buffers ``GET /timeline`` merges.
TRACE_KV_PREFIX = "/trace/buf/"


def load_trace(path):
    """Load a Chrome trace JSON file, repairing the common
    truncated-mid-run shapes (missing ``]``, trailing comma, torn last
    event) a killed worker leaves behind."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except ValueError:
        pass
    t = text.strip()
    if not t.startswith("["):
        raise ValueError(f"{path}: not a Chrome trace JSON array")
    t = t[1:].rstrip().rstrip(",")
    try:
        return json.loads("[" + t + "]")
    except ValueError:
        # torn final event: cut back to the last complete object
        idx = t.rfind("}")
        while idx > 0:
            try:
                return json.loads("[" + t[:idx + 1].rstrip().rstrip(",")
                                  + "]")
            except ValueError:
                idx = t.rfind("}", 0, idx)
    raise ValueError(f"{path}: unrecoverable trace JSON")


def _clock_offset(events):
    """The LAST clock_sync record wins — drift re-samples supersede
    earlier ones."""
    offset = 0.0
    found = False
    for ev in events:
        if ev.get("name") == "clock_sync" and ev.get("ph") == "M":
            try:
                offset = float(ev["args"]["offset_us"])
                found = True
            except (KeyError, TypeError, ValueError):
                continue
    return offset, found


def _trace_pid(events):
    for ev in events:
        pid = ev.get("pid")
        if pid is not None:
            return int(pid)
    return None


def merge_traces(traces, align=True, normalize=True):
    """Merge per-worker event lists into one sorted job trace.

    ``traces``: iterable of Chrome-trace event lists (one per worker).
    With ``align`` each trace's timestamps are shifted by its
    ``clock_sync`` offset onto the shared reference clock; with
    ``normalize`` the merged trace is then rebased so the earliest
    event sits at ts 0.  Worker pids are preserved; collisions (two
    traces claiming the same pid, e.g. legacy pid-0 files) are remapped
    to the next free pid so lanes never interleave.
    """
    used_pids = set()
    prepared = []       # (events, offset, found)
    for i, events in enumerate(traces):
        events = [ev for ev in events if isinstance(ev, dict)]
        if not events:
            continue
        offset, found = _clock_offset(events) if align else (0.0, False)
        prepared.append((i, events, offset, found))
    # traces WITHOUT a clock_sync record (legacy pre-trace files) must
    # not mix their private perf_counter domain into the aligned
    # unix-epoch-microsecond axis — ~50 years apart.  Best effort:
    # rebase each offsetless trace so its first event coincides with
    # the earliest aligned event (no cross-trace ordering is knowable
    # without a clock record).
    if align and any(found for _, _, _, found in prepared) \
            and not all(found for _, _, _, found in prepared):
        aligned_ts = [float(ev["ts"]) + off
                      for _, evs, off, found in prepared if found
                      for ev in evs if "ts" in ev]
        if aligned_ts:      # synced traces may be metadata-only
            ref_base = min(aligned_ts)
            rebased = []
            for i, events, offset, found in prepared:
                if not found:
                    local = [float(ev["ts"]) for ev in events
                             if "ts" in ev]
                    offset = ref_base - min(local) if local else 0.0
                rebased.append((i, events, offset, found))
            prepared = rebased
    shifted = []
    for i, events, offset, _ in prepared:
        pid = _trace_pid(events)
        if pid is None:
            pid = i
        if pid in used_pids:
            pid = max(used_pids) + 1
        used_pids.add(pid)
        for ev in events:
            ev = dict(ev)
            ev["pid"] = pid
            if align and "ts" in ev:
                ev["ts"] = float(ev["ts"]) + offset
            shifted.append(ev)
    if normalize:
        stamped = [ev["ts"] for ev in shifted if "ts" in ev]
        if stamped:
            base = min(stamped)
            for ev in shifted:
                if "ts" in ev:
                    ev["ts"] -= base
    # metadata first, then strictly by aligned timestamp: one
    # monotonic event stream viewers (and tests) can rely on
    shifted.sort(key=lambda ev: (0 if ev.get("ph") == "M" else 1,
                                 ev.get("ts", 0.0)))
    return shifted


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Merge per-worker Chrome traces into one "
                    "clock-aligned job trace.")
    parser.add_argument("inputs", nargs="+",
                        help="per-worker Chrome trace JSON files "
                             "(timeline files or flight-recorder "
                             "dumps; truncated files are repaired)")
    parser.add_argument("-o", "--output", default=None,
                        help="merged trace path (default: stdout)")
    parser.add_argument("--no-align", action="store_true",
                        help="skip clock_sync alignment (raw "
                             "per-worker timestamps)")
    args = parser.parse_args(argv)

    traces = [load_trace(p) for p in args.inputs]
    merged = merge_traces(traces, align=not args.no_align)
    out = json.dumps(merged)
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
        pids = {ev.get("pid") for ev in merged}
        print(f"merged {len(args.inputs)} traces "
              f"({len(merged)} events, {len(pids)} pid lanes) "
              f"-> {args.output}", file=sys.stderr)
    else:
        sys.stdout.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
