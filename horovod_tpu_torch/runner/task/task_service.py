"""horovodrun's per-host task service (port of
``horovod_tpu/runner/task/task_service.py``; reference
``horovod/runner/task/task_service.py``): the BasicTaskService plus the
task-to-task address-check handshake the NIC probe uses.  The launcher
hands workers an address and never runs the probe, but the service is
fully functional for tooling that drives it."""

from ..common.service import task_service


class TaskToTaskAddressCheckFinishedSignal:
    def __init__(self, index):
        self.index = index


class TaskToTaskAddressCheckFinishedSignalResponse:
    def __init__(self, index):
        self.index = index


class HorovodRunTaskService(task_service.BasicTaskService):
    NAME_FORMAT = "horovod task service #%d"

    def __init__(self, index, key, nics=None):
        super().__init__(HorovodRunTaskService.NAME_FORMAT % index,
                         index, key, nics)
        self.index = index
        self._task_to_task_address_check_completed = False

    def _handle(self, req, client_address):
        if isinstance(req, TaskToTaskAddressCheckFinishedSignal):
            with self._wait_cond:
                self._task_to_task_address_check_completed = True
                self._wait_cond.notify_all()
            return TaskToTaskAddressCheckFinishedSignalResponse(
                self.index)
        return super()._handle(req, client_address)

    def wait_for_task_to_task_address_check_finish_signal(self,
                                                          timeout):
        with self._wait_cond:
            while not self._task_to_task_address_check_completed:
                self._wait_cond.wait(timeout.remaining())
                timeout.check_time_out_for("Task to task address check")


class HorovodRunTaskClient(task_service.BasicTaskClient):
    def __init__(self, index, task_addresses, key, verbose=0,
                 match_intf=False, attempts=3):
        super().__init__(HorovodRunTaskService.NAME_FORMAT % index,
                         task_addresses, key, verbose,
                         match_intf=match_intf, attempts=attempts)
        self.index = index

    def task_to_task_address_check_completed(self):
        resp = self._send(TaskToTaskAddressCheckFinishedSignal(
            self.index))
        return resp.index
