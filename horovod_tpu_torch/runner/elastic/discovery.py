"""Host discovery for elastic jobs (port of
``horovod_tpu/runner/elastic/discovery.py``; reference
``horovod/runner/elastic/discovery.py``: HostManager :152,
HostDiscoveryScript :240, blacklist with exponential-cooldown
resurrection :33-111)."""

import logging
import random
import subprocess
import threading
import time
from collections import defaultdict

logger = logging.getLogger("horovod_tpu_torch.elastic")

# reference discovery.py cooldown constants
DEFAULT_COOLDOWN_RANGE = (1.0, 600.0)


class HostState:
    """Blacklist state for one host (reference discovery.py:33-111):
    exponential backoff between blacklist and resurrection."""

    def __init__(self, cooldown_range=None):
        self._event = threading.Event()
        self._blacklisted = False
        self._blacklist_count = 0
        self._cooldown_range = cooldown_range or DEFAULT_COOLDOWN_RANGE
        self._cooldown_ends = None

    def get_event(self):
        if self._event.is_set():
            event = threading.Event()
            self._event = event
        return self._event

    def set_event(self):
        self._event.set()

    def _in_cooldown_period(self, current_time):
        return self._cooldown_ends is not None and \
            current_time < self._cooldown_ends

    def _set_cooldown_period(self, current_time):
        self._blacklist_count += 1
        lo, hi = self._cooldown_range
        # exponential backoff with jitter, capped at the range max
        delay = min(lo * (2 ** (self._blacklist_count - 1)), hi)
        delay *= 1.0 + 0.25 * random.random()
        self._cooldown_ends = current_time + min(delay, hi)

    def blacklist(self):
        """Blacklist the host with a cooldown period."""
        self._blacklisted = True
        self._set_cooldown_period(time.monotonic())
        self.set_event()

    def whitelist(self):
        """Whitelist the host immediately (cooldown expiry)."""
        self._cooldown_ends = None
        self._blacklisted = False

    def is_blacklisted(self):
        """Cooldown expiry resurrects the host (reference
        discovery.py:97-111)."""
        if self._blacklisted and not self._in_cooldown_period(
                time.monotonic()):
            self.whitelist()
        return self._blacklisted


class HostManager:
    """Tracks current available hosts + blacklist (reference
    discovery.py:152-239)."""

    def __init__(self, discovery, cooldown_range=None):
        self._current_hosts = DiscoveredHosts(host_slots={},
                                              host_assignment_order=[])
        self._hosts_state = defaultdict(
            lambda: HostState(cooldown_range))
        self._discovery = discovery

    def update_available_hosts(self):
        """Poll discovery; returns True when membership changed."""
        def active(host):
            return not self._hosts_state[host].is_blacklisted()

        prev_hosts = self._current_hosts
        slots = self._discovery.find_available_hosts_and_slots()
        if prev_hosts.host_slots != slots:
            available = {h for h in slots if active(h)}
            prev_avail = set(prev_hosts.host_assignment_order)
            if available != prev_avail or prev_hosts.host_slots != slots:
                # preserve order of existing hosts for rank stability
                # (reference HostManager.order_available_hosts)
                order = [h for h in prev_hosts.host_assignment_order
                         if h in available]
                order += sorted(available - set(order))
                self._current_hosts = DiscoveredHosts(
                    host_slots=slots, host_assignment_order=order)
                return True
        else:
            # blacklist state may have changed without slot changes
            available = {h for h in slots if active(h)}
            if set(self._current_hosts.host_assignment_order) != available:
                order = [h for h in self._current_hosts.host_assignment_order
                         if h in available]
                order += sorted(available - set(order))
                self._current_hosts = DiscoveredHosts(
                    host_slots=slots, host_assignment_order=order)
                return True
        return False

    @property
    def current_hosts(self):
        return self._current_hosts

    def blacklist(self, host):
        if not self._hosts_state[host].is_blacklisted():
            logger.warning("blacklisting host %s", host)
        self._hosts_state[host].blacklist()

    def is_blacklisted(self, host):
        return self._hosts_state[host].is_blacklisted()

    def get_host_event(self, host):
        return self._hosts_state[host].get_event()


class DiscoveredHosts:
    """Immutable snapshot (reference discovery.py:114-149)."""

    def __init__(self, host_slots, host_assignment_order):
        self.host_slots = dict(host_slots)
        self.host_assignment_order = list(host_assignment_order)

    @property
    def available_hosts(self):
        return set(self.host_assignment_order)

    def count_available_slots(self):
        return sum(self.host_slots.get(h, 0)
                   for h in self.host_assignment_order)

    def update(self, hosts_state):
        self.host_assignment_order = [
            h for h in self.host_assignment_order
            if not hosts_state[h].is_blacklisted()]
        return self


class HostDiscovery:
    def find_available_hosts_and_slots(self) -> dict:
        """Returns {hostname: slots}."""
        raise NotImplementedError


class HostDiscoveryScript(HostDiscovery):
    """User script printing ``host:slots`` lines (reference
    discovery.py:240-273)."""

    def __init__(self, discovery_script, slots=None):
        self._discovery_script = discovery_script
        self._default_slots = slots

    def _execute_discovery_script(self):
        """Run the user's script, return its stdout (separate method
        so tests can substitute results — reference discovery.py
        contract)."""
        return subprocess.check_output(
            self._discovery_script, shell=True, timeout=60).decode()

    def find_available_hosts_and_slots(self):
        stdout = self._execute_discovery_script()
        host_slots = {}
        for line in stdout.strip().splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                host, slots = line.split(":", 1)
                host_slots[host] = int(slots)
            else:
                if self._default_slots is None:
                    raise RuntimeError(
                        f"no slots for host {line}; pass --slots-per-host "
                        f"or print host:slots lines")
                host_slots[line] = self._default_slots
        return host_slots


class FixedHosts(HostDiscovery):
    def __init__(self, available_hosts):
        self._available_hosts = dict(available_hosts)

    def find_available_hosts_and_slots(self):
        return dict(self._available_hosts)


# reference discovery.py cooldown constant names (the tuple above is
# the live configuration; these are the reference's split form)
DEFAULT_COOLDOWN_LOWER_LIMIT_SECONDS = DEFAULT_COOLDOWN_RANGE[0]
DEFAULT_COOLDOWN_UPPER_LIMIT_SECONDS = DEFAULT_COOLDOWN_RANGE[1]
