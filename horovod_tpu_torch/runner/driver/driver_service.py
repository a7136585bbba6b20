"""horovodrun's driver service + interface discovery (port of
``horovod_tpu/runner/driver/driver_service.py``; reference
``horovod/runner/driver/driver_service.py``).

The reference launches task services on every host and has them probe
each other to find the common routable NICs.  The port's launcher hands
workers an address, not an interface (``proc_run.launch_procs``: the
launcher's ``local_ip()``), so ``get_common_interfaces`` returns the
loopback set when every host is local and the configured ``--nics``
(or no constraint) otherwise."""

from ..common.service import driver_service
from ..common.util.hosts import parse_hosts
from ..util.network import filter_local_addresses, get_local_intfs


class HorovodRunDriverService(driver_service.BasicDriverService):
    NAME = "horovod driver service"

    def __init__(self, num_hosts, key, nics=None):
        super().__init__(num_hosts, HorovodRunDriverService.NAME, key,
                         nics)


class HorovodRunDriverClient(driver_service.BasicDriverClient):
    def __init__(self, driver_addresses, key, verbose=0,
                 match_intf=False):
        super().__init__(HorovodRunDriverService.NAME,
                         driver_addresses, key, verbose,
                         match_intf=match_intf)


def get_local_interfaces(settings):
    """Reference driver_service.py get_local_interfaces — the
    single-host NIC set."""
    if settings.verbose >= 2:
        print("All hosts are local, finding the interfaces "
              "with the address 127.0.0.1")
    return get_local_intfs(nic=settings.nics)


def get_common_interfaces(settings, all_host_names,
                          remote_host_names=None, fn_cache=None):
    """Reference driver_service.py:49/246 — resolve the NIC set shared
    by all hosts.  When all hosts are local this returns the loopback
    set; otherwise the workers reach the launcher at the address of the
    ssh env handoff (proc_run.launch_procs), which needs no NIC list,
    so it returns the configured NICs."""
    if remote_host_names is None:
        remote_host_names = filter_local_addresses(all_host_names)
    if len(remote_host_names) == 0:
        return get_local_interfaces(settings)
    # multi-host: the launcher's control plane is address-based
    # (HMAC-HTTP), not interface-based; honor an explicit --nics and
    # otherwise signal "no constraint"
    if settings.nics:
        return set(settings.nics) if not isinstance(settings.nics, set) \
            else settings.nics
    return set()


def _all_host_names(settings):
    if not getattr(settings, "hosts", None):
        return []
    return [h.hostname for h in parse_hosts(settings.hosts)]
