"""Task-registration driver service (port of
``horovod_tpu/runner/common/service/driver_service.py``; reference
``horovod/runner/common/service/driver_service.py``).

Tasks dial the driver, register their service addresses and host
hash; the driver groups tasks by host and answers address queries.
The launcher's own registration rides the HMAC-HTTP KV store
(runner/http/); this service is the reference-shaped surface for
tooling built on the TCP framework.
"""

import threading

from ..util import network


class RegisterTaskRequest:
    def __init__(self, index, task_addresses, host_hash):
        self.index = index
        self.task_addresses = task_addresses
        self.host_hash = host_hash


class RegisterTaskToTaskAddressesRequest:
    def __init__(self, index, task_addresses):
        self.index = index
        self.task_addresses = task_addresses


class AllTaskAddressesRequest:
    def __init__(self, index):
        self.index = index


class AllTaskAddressesResponse:
    def __init__(self, all_task_addresses):
        self.all_task_addresses = all_task_addresses


class BasicDriverService(network.BasicService):
    def __init__(self, num_proc, name, key, nics=None):
        super().__init__(name, key, nics)
        self._num_proc = num_proc
        self._all_task_addresses = {}
        self._task_addresses_for_driver = {}
        self._task_addresses_for_tasks = {}
        self._task_index_host_hash = {}
        self._task_host_hash_indices = {}
        self._wait_cond = threading.Condition()

    def _handle(self, req, client_address):
        if isinstance(req, RegisterTaskRequest):
            with self._wait_cond:
                assert 0 <= req.index < self._num_proc
                self._all_task_addresses[req.index] = req.task_addresses
                self._task_addresses_for_driver[req.index] = \
                    self._filter_by_ip(req.task_addresses,
                                       client_address[0])
                earlier = self._task_index_host_hash.get(req.index)
                if earlier is not None and earlier != req.host_hash:
                    self._task_host_hash_indices[earlier].remove(
                        req.index)
                self._task_index_host_hash[req.index] = req.host_hash
                indices = self._task_host_hash_indices.setdefault(
                    req.host_hash, [])
                if req.index not in indices:
                    indices.append(req.index)
                    indices.sort()
                self._wait_cond.notify_all()
            return network.AckResponse()

        if isinstance(req, RegisterTaskToTaskAddressesRequest):
            self.register_task_to_task_addresses(req.index,
                                                 req.task_addresses)
            return network.AckResponse()

        if isinstance(req, AllTaskAddressesRequest):
            return AllTaskAddressesResponse(
                self._all_task_addresses[req.index])

        return super()._handle(req, client_address)

    def _filter_by_ip(self, addresses, target_ip):
        for intf, intf_addresses in addresses.items():
            for ip, port in intf_addresses:
                if ip == target_ip:
                    return {intf: [(ip, port)]}
        # target behind NAT: fall back to everything it declared so the
        # client probe decides, instead of guaranteeing failure
        return dict(addresses)

    def all_task_addresses(self, index):
        with self._wait_cond:
            return dict(self._all_task_addresses[index])

    def task_addresses_for_driver(self, index):
        with self._wait_cond:
            return dict(self._task_addresses_for_driver[index])

    def task_addresses_for_tasks(self, index):
        with self._wait_cond:
            return dict(self._task_addresses_for_tasks[index])

    def register_task_to_task_addresses(self, index, task_addresses):
        with self._wait_cond:
            assert 0 <= index < self._num_proc
            self._task_addresses_for_tasks[index] = task_addresses
            self._wait_cond.notify_all()

    def task_indices(self):
        with self._wait_cond:
            return list(self._task_index_host_hash.keys())

    def task_host_hash_indices(self):
        with self._wait_cond:
            return dict(self._task_host_hash_indices)

    def task_index_host_hash(self, index):
        with self._wait_cond:
            return self._task_index_host_hash[index]

    def wait_for_initial_registration(self, timeout):
        with self._wait_cond:
            while len(self._all_task_addresses) < self._num_proc:
                self._wait_cond.wait(timeout.remaining())
                timeout.check_time_out_for("tasks to start")

    def wait_for_task_to_task_address_updates(self, timeout):
        with self._wait_cond:
            while len(self._task_addresses_for_tasks) < self._num_proc:
                self._wait_cond.wait(timeout.remaining())
                timeout.check_time_out_for(
                    "tasks to update task-to-task addresses")


class BasicDriverClient(network.BasicClient):
    def __init__(self, name, driver_addresses, key, verbose=0,
                 match_intf=False):
        super().__init__(name, driver_addresses, key, verbose,
                         match_intf=match_intf)

    def register_task(self, index, task_addresses, host_hash):
        self._send(RegisterTaskRequest(index, task_addresses,
                                       host_hash))

    def all_task_addresses(self, index):
        return self._send(
            AllTaskAddressesRequest(index)).all_task_addresses

    def register_task_to_task_addresses(self, index, task_addresses):
        self._send(RegisterTaskToTaskAddressesRequest(index,
                                                      task_addresses))
