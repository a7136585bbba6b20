"""Per-task command-execution service (port of
``horovod_tpu/runner/common/service/task_service.py``; reference
``horovod/runner/common/service/task_service.py``).

A task service runs on each allocated host/slot; the driver sends it
exactly one command to execute (idempotent — re-sends are ignored),
can stream the command's captured stdout/stderr, poll or block on the
exit code, and abort the process tree.  The spark/ray integration
layers drive remote workers through this protocol.
"""

import struct
import threading

from ..util import network, safe_shell_exec
from ..util.timeout import Timeout
from ...util.streams import Pipe
from ...util.threads import in_thread

WAIT_FOR_COMMAND_MIN_DELAY = 0.1


class RunCommandRequest:
    def __init__(self, command, env, capture_stdout=False,
                 capture_stderr=False,
                 prefix_output_with_timestamp=False):
        self.command = command
        self.env = env
        self.capture_stdout = capture_stdout
        self.capture_stderr = capture_stderr
        self.prefix_output_with_timestamp = prefix_output_with_timestamp


class StreamCommandOutputRequest:
    pass


class StreamCommandStdOutRequest(StreamCommandOutputRequest):
    pass


class StreamCommandStdErrRequest(StreamCommandOutputRequest):
    pass


class CommandOutputNotCaptured(Exception):
    pass


class AbortCommandRequest:
    pass


class CommandExitCodeRequest:
    pass


class CommandExitCodeResponse:
    def __init__(self, terminated, exit_code):
        self.terminated = terminated
        self.exit_code = exit_code


class WaitForCommandExitCodeRequest:
    def __init__(self, delay):
        self.delay = delay


class WaitForCommandExitCodeResponse:
    def __init__(self, exit_code):
        self.exit_code = exit_code


class NotifyInitialRegistrationCompleteRequest:
    pass


class RegisterCodeResultRequest:
    def __init__(self, result):
        self.result = result


class BasicTaskService(network.BasicService):
    def __init__(self, name, index, key, nics=None, command_env=None,
                 verbose=0):
        self._initial_registration_complete = False
        self._wait_cond = threading.Condition()
        self._service_shutdown = False
        self._index = index
        self._command_env = command_env
        self._command_thread = None
        self._command_abort = None
        self._command_stdout = None
        self._command_stderr = None
        self._command_exit_code = None
        self._fn_result = None
        self._verbose = verbose
        super().__init__(name, key, nics)

    def _run_command(self, command, env, event, stdout, stderr,
                     prefix_output_with_timestamp=False):
        self._command_exit_code = safe_shell_exec.execute(
            command, env=env, stdout=stdout, stderr=stderr,
            index=self._index, events=[event],
            prefix_output_with_timestamp=prefix_output_with_timestamp)
        with self._wait_cond:
            if stdout:
                stdout.close()
            if stderr:
                stderr.close()
            self._wait_cond.notify_all()

    def _handle(self, req, client_address):
        if isinstance(req, RunCommandRequest):
            with self._wait_cond:
                if self._command_thread is None:
                    env = dict(self._command_env or {})
                    for k, v in (req.env or {}).items():
                        if v is None:
                            env.pop(k, None)
                        else:
                            env[k] = v
                    self._command_abort = threading.Event()
                    self._command_stdout = \
                        Pipe() if req.capture_stdout else None
                    self._command_stderr = \
                        Pipe() if req.capture_stderr else None
                    self._command_thread = in_thread(
                        self._run_command,
                        (req.command, env, self._command_abort,
                         self._command_stdout, self._command_stderr,
                         req.prefix_output_with_timestamp))
                self._wait_cond.notify_all()
            return network.AckResponse()

        if isinstance(req, StreamCommandOutputRequest):
            self.wait_for_command_start()
            if self._command_thread is None:
                # service shutting down before any command started
                return CommandOutputNotCaptured()
            stream = self._command_stdout \
                if isinstance(req, StreamCommandStdOutRequest) \
                else self._command_stderr
            if stream is None:
                return CommandOutputNotCaptured()
            return network.AckStreamResponse(), stream

        if isinstance(req, AbortCommandRequest):
            with self._wait_cond:
                if self._command_thread is not None:
                    self._command_abort.set()
                for stream in (self._command_stdout,
                               self._command_stderr):
                    if stream is not None:
                        stream.close()
            return network.AckResponse()

        if isinstance(req, NotifyInitialRegistrationCompleteRequest):
            with self._wait_cond:
                self._initial_registration_complete = True
                self._wait_cond.notify_all()
            return network.AckResponse()

        if isinstance(req, CommandExitCodeRequest):
            with self._wait_cond:
                terminated = (self._command_thread is not None and
                              not self._command_thread.is_alive())
                return CommandExitCodeResponse(
                    terminated,
                    self._command_exit_code if terminated else None)

        if isinstance(req, WaitForCommandExitCodeRequest):
            with self._wait_cond:
                # a RUNNING command is waited out even through
                # shutdown (the draining contract,
                # test_service.py:143: the caller gets the real exit
                # code); only a never-started command releases on
                # shutdown so teardown cannot hang forever
                while (self._command_thread is None
                       and not self._service_shutdown) or \
                        (self._command_thread is not None
                         and self._command_thread.is_alive()):
                    self._wait_cond.wait(
                        max(req.delay, WAIT_FOR_COMMAND_MIN_DELAY))
                return WaitForCommandExitCodeResponse(
                    self._command_exit_code)

        if isinstance(req, RegisterCodeResultRequest):
            self._fn_result = req.result
            return network.AckResponse()

        return super()._handle(req, client_address)

    # -- driver-side accessors (same object when in-process) ------------------

    def fn_result(self):
        return self._fn_result

    def wait_for_initial_registration(self, timeout=None):
        with self._wait_cond:
            while not self._initial_registration_complete:
                if timeout:
                    self._wait_cond.wait(timeout.remaining())
                    timeout.check_time_out_for("tasks to start")
                else:
                    self._wait_cond.wait()

    def wait_for_command_start(self, timeout=None):
        with self._wait_cond:
            while self._command_thread is None and \
                    not self._service_shutdown:
                if timeout:
                    self._wait_cond.wait(timeout.remaining())
                    timeout.check_time_out_for("command to run")
                else:
                    self._wait_cond.wait()

    def check_for_command_start(self, seconds):
        with self._wait_cond:
            tmout = Timeout(seconds, "Timed out waiting for {activity}")
            while self._command_thread is None:
                remaining = tmout.remaining()
                if remaining == 0:
                    return False
                self._wait_cond.wait(remaining)
            return True

    def wait_for_command_termination(self):
        self._command_thread.join()

    def shutdown(self):
        # wake every parked waiter (command-start, exit-code) before
        # the draining server joins handler threads; in-flight command
        # handlers still finish (test_service.py:143 contract) —
        # running commands are not aborted, only waits are released
        with self._wait_cond:
            self._service_shutdown = True
            self._wait_cond.notify_all()
        super().shutdown()

    def command_exit_code(self):
        return self._command_exit_code


class BasicTaskClient(network.BasicClient):
    def __init__(self, service_name, task_addresses, key, verbose=0,
                 match_intf=False, attempts=3):
        super().__init__(service_name, task_addresses, key, verbose,
                         match_intf=match_intf, attempts=attempts)

    def run_command(self, command, env, capture_stdout=False,
                    capture_stderr=False,
                    prefix_output_with_timestamp=False):
        self._send(RunCommandRequest(command, env, capture_stdout,
                                     capture_stderr,
                                     prefix_output_with_timestamp))

    def stream_command_output(self, stdout=None, stderr=None):
        def send(req, stream):
            # a broken client-side stream (or dropped connection)
            # re-requests the stream and resumes from the live pipe —
            # some lines are lost, the command keeps running
            # (reference test_task_service.py reconnect contract);
            # only after the attempt budget does it abort the command
            for attempt in range(self._attempts):
                try:
                    self._send(req, stream=stream)
                    return
                except (OSError, EOFError, struct.error) as exc:
                    # connection-level failure: _send already burned
                    # its own retry budget — don't square it
                    try:
                        self.abort_command()
                    finally:
                        raise exc
                except Exception:
                    # mid-stream failure (e.g. the caller's stream
                    # object raised): re-request and resume from the
                    # live pipe, losing some lines
                    if attempt == self._attempts - 1:
                        try:
                            self.abort_command()
                        finally:
                            raise

        return (in_thread(send, (StreamCommandStdOutRequest(), stdout))
                if stdout else None,
                in_thread(send, (StreamCommandStdErrRequest(), stderr))
                if stderr else None)

    def abort_command(self):
        self._send(AbortCommandRequest())

    def notify_initial_registration_complete(self):
        self._send(NotifyInitialRegistrationCompleteRequest())

    def command_result(self):
        resp = self._send(CommandExitCodeRequest())
        return resp.terminated, resp.exit_code

    def wait_for_command_exit_code(self, delay=1.0):
        return self._send(
            WaitForCommandExitCodeRequest(delay)).exit_code

    def register_code_result(self, result):
        self._send(RegisterCodeResultRequest(result))

    def wait_for_command_termination(self, delay=1.0):
        while True:
            terminated, _ = self.command_result()
            if terminated:
                return
            import time
            time.sleep(delay)
