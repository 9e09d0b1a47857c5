"""Hang detection for long-running training jobs (the port's own copy of
``srf_tpu/utils/watchdog.py``).

Training fails in two shapes the reference has no answer for
(its recovery story is "re-run the trainer and resume at the last epoch",
tfsr/trainer_sr.py:250-259): the process DIES (covered by
``--tpu-ckpt-every-steps`` mid-epoch resume), or the process HANGS — a
stuck device call, a stuck host transfer, a deadlocked input thread. A
hang is worse than a crash: nothing restarts it.

``Watchdog`` turns hangs into crashes: the train loop ``kick()``s it
after every optimizer step; if no kick arrives within ``timeout_s``, the
monitor dumps every Python thread's stack to stderr (``faulthandler``, so
it works even if the main thread holds the GIL inside a C call) and
hard-exits with a distinct status (43) so the supervisor restarts the
job, which then resumes from the last mid-epoch checkpoint.

Enabled by ``--tpu-watchdog-secs N`` (0 = off).
"""

import faulthandler
import os
import sys
import threading
import time


class Watchdog:
    EXIT_CODE = 43

    def __init__(self, timeout_s, logger=None, exit_code=EXIT_CODE,
                 _exit=os._exit):
        self.timeout_s = float(timeout_s)
        self.logger = logger
        self.exit_code = exit_code
        self._exit = _exit  # injectable for tests
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        self._last = time.monotonic()
        self._thread = threading.Thread(
            target=self._monitor, name="srf-watchdog", daemon=True
        )
        self._thread.start()
        if self.logger:
            self.logger.info(
                "Watchdog armed: no-progress timeout %.1f s", self.timeout_s
            )
        return self

    def kick(self):
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _monitor(self):
        poll = max(0.05, min(1.0, self.timeout_s / 4.0))
        while not self._stop.wait(poll):
            stalled = time.monotonic() - self._last
            if stalled <= self.timeout_s:
                continue
            msg = (
                "WATCHDOG: no training progress for %.1f s (timeout %.1f s)"
                " — dumping all thread stacks and exiting %d for the "
                "supervisor to restart (resume is exact with "
                "--tpu-ckpt-every-steps)"
                % (stalled, self.timeout_s, self.exit_code)
            )
            print(msg, file=sys.stderr, flush=True)
            if self.logger:
                self.logger.error(msg)
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
            sys.stderr.flush()
            self._exit(self.exit_code)
            return  # only reached with an injected _exit (tests)
