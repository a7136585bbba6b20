"""Compute-cluster coordination service (port of
``horovod_tpu/runner/common/service/compute_service.py``; reference
``horovod/runner/common/service/compute_service.py``).

Synchronizes data-service dispatchers and their workers with the
training job: dispatchers register their addresses, workers register
per dispatcher, trainers wait for registration, and anyone can
initiate/await shutdown.  The data service that carries the batches
is ROADMAP.md A17 (``data/*``); this service is the
registration/shutdown control plane in reference shape.
"""

import threading

from ..util import network
from ..util.timeout import TimeoutException


class RegisterDispatcherRequest:
    def __init__(self, dispatcher_id, dispatcher_address):
        self.dispatcher_id = dispatcher_id
        self.dispatcher_address = dispatcher_address


class WaitForDispatcherRegistrationRequest:
    def __init__(self, dispatcher_id, timeout):
        self.dispatcher_id = dispatcher_id
        self.timeout = timeout


class WaitForDispatcherRegistrationResponse:
    def __init__(self, dispatcher_address):
        self.dispatcher_address = dispatcher_address


class RegisterDispatcherWorkerRequest:
    def __init__(self, dispatcher_id, worker_id):
        self.dispatcher_id = dispatcher_id
        self.worker_id = worker_id


class WaitForDispatcherWorkerRegistrationRequest:
    def __init__(self, dispatcher_id, timeout):
        self.dispatcher_id = dispatcher_id
        self.timeout = timeout


class ShutdownRequest:
    pass


class WaitForShutdownRequest:
    pass


class ComputeService(network.BasicService):
    NAME = "Compute service"

    def __init__(self, dispatchers, workers_per_dispatcher, key,
                 nics=None):
        if dispatchers <= 0:
            raise ValueError(
                f"The number of dispatchers must be larger than 0: "
                f"{dispatchers}")
        if workers_per_dispatcher <= 0:
            raise ValueError(
                f"The number of workers per dispatcher must be larger "
                f"than 0: {workers_per_dispatcher}")
        self._max_dispatcher_id = dispatchers - 1
        self._dispatcher_addresses = [None] * dispatchers
        self._workers_per_dispatcher = workers_per_dispatcher
        self._dispatcher_worker_ids = [set() for _ in
                                       range(dispatchers)]
        self._shutdown = False
        self._wait_cond = threading.Condition()
        super().__init__(ComputeService.NAME, key, nics)

    def _check_dispatcher(self, dispatcher_id):
        if not 0 <= dispatcher_id <= self._max_dispatcher_id:
            return IndexError(
                f"Dispatcher id must be within "
                f"[0..{self._max_dispatcher_id}]: {dispatcher_id}")
        return None

    def _handle(self, req, client_address):
        if isinstance(req, RegisterDispatcherRequest):
            with self._wait_cond:
                err = self._check_dispatcher(req.dispatcher_id)
                if err is not None:
                    return err
                current = self._dispatcher_addresses[req.dispatcher_id]
                if current is not None and \
                        current != req.dispatcher_address:
                    return ValueError(
                        f"Dispatcher with id {req.dispatcher_id} has "
                        f"already been registered under different "
                        f"address {current}: {req.dispatcher_address}")
                self._dispatcher_addresses[req.dispatcher_id] = \
                    req.dispatcher_address
                self._wait_cond.notify_all()
            return network.AckResponse()

        if isinstance(req, WaitForDispatcherRegistrationRequest):
            with self._wait_cond:
                err = self._check_dispatcher(req.dispatcher_id)
                if err is not None:
                    return err
                if not self._wait_cond.wait_for(
                        lambda: self._dispatcher_addresses[
                            req.dispatcher_id] is not None,
                        timeout=req.timeout):
                    return TimeoutException(
                        f"Timed out waiting for dispatcher "
                        f"{req.dispatcher_id} to register. Try to "
                        f"find out what takes the dispatcher so long "
                        f"to register or increase timeout. Timeout "
                        f"after {req.timeout} seconds.")
                return WaitForDispatcherRegistrationResponse(
                    self._dispatcher_addresses[req.dispatcher_id])

        if isinstance(req, RegisterDispatcherWorkerRequest):
            with self._wait_cond:
                err = self._check_dispatcher(req.dispatcher_id)
                if err is not None:
                    return err
                self._dispatcher_worker_ids[req.dispatcher_id].add(
                    req.worker_id)
                self._wait_cond.notify_all()
            return network.AckResponse()

        if isinstance(req, WaitForDispatcherWorkerRegistrationRequest):
            with self._wait_cond:
                err = self._check_dispatcher(req.dispatcher_id)
                if err is not None:
                    return err
                if not self._wait_cond.wait_for(
                        lambda: len(self._dispatcher_worker_ids[
                            req.dispatcher_id]) >=
                        self._workers_per_dispatcher,
                        timeout=req.timeout):
                    return TimeoutException(
                        f"Timed out waiting for workers for "
                        f"dispatcher {req.dispatcher_id} to register. "
                        f"Try to find out what takes the workers so "
                        f"long to register or increase timeout. "
                        f"Timeout after {req.timeout} seconds.")
            return network.AckResponse()

        if isinstance(req, ShutdownRequest):
            with self._wait_cond:
                self._shutdown = True
                self._wait_cond.notify_all()
            return network.AckResponse()

        if isinstance(req, WaitForShutdownRequest):
            with self._wait_cond:
                self._wait_cond.wait_for(lambda: self._shutdown)
            return network.AckResponse()

        return super()._handle(req, client_address)

    def shutdown(self):
        # wake parked WaitForShutdown handlers BEFORE draining the
        # server: block_on_close joins handler threads, and a handler
        # waiting on the condition would deadlock the teardown
        # (reference compute_service.py shutdown() sets the flag too)
        with self._wait_cond:
            self._shutdown = True
            self._wait_cond.notify_all()
        super().shutdown()


class ComputeClient(network.BasicClient):
    def __init__(self, addresses, key, verbose=0):
        super().__init__(ComputeService.NAME, addresses, key, verbose)

    def _send_checked(self, req):
        resp = self._send(req)
        if isinstance(resp, Exception):
            raise resp
        return resp

    def register_dispatcher(self, dispatcher_id, dispatcher_address):
        self._send_checked(RegisterDispatcherRequest(
            dispatcher_id, dispatcher_address))

    def wait_for_dispatcher_registration(self, dispatcher_id,
                                         timeout=60):
        return self._send_checked(WaitForDispatcherRegistrationRequest(
            dispatcher_id, timeout)).dispatcher_address

    def register_worker_for_dispatcher(self, dispatcher_id, worker_id):
        self._send_checked(RegisterDispatcherWorkerRequest(
            dispatcher_id, worker_id))

    def wait_for_dispatcher_worker_registration(self, dispatcher_id,
                                                timeout=60):
        self._send_checked(WaitForDispatcherWorkerRegistrationRequest(
            dispatcher_id, timeout))

    def shutdown(self):
        self._send_checked(ShutdownRequest())

    def wait_for_shutdown(self):
        self._send_checked(WaitForShutdownRequest())
