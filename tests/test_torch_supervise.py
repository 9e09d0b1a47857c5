"""The port's restart supervisor (``tools/supervise.py``) and watchdog
(``utils/watchdog.py``), their own copies, in process: the
non-subprocess cases of ``tests/test_supervise.py`` and
``tests/test_watchdog.py`` (argument parsing and the restart rule, held to
``srf_tpu.tools.supervise`` too; the watchdog's kicks, its expiry with the
exit function patched, and ``stop``)."""

import time

import pytest

from srf_tpu.tools import supervise as jax_supervise
from srf_tpu_torch.tools.supervise import (
    DEFAULT_RESTART_CODES, parse_args, should_restart,
)
from srf_tpu_torch.utils.watchdog import Watchdog


def test_parse_args_defaults_and_split():
    args, command = parse_args(["--max-restarts", "3", "--", "echo", "hi"])
    assert args.max_restarts == 3 and args.backoff_secs == 0.0
    assert command == ["echo", "hi"]
    assert args.restart_codes == set(DEFAULT_RESTART_CODES)
    assert {42, 43, 137, 143} <= args.restart_codes
    args, command = parse_args(["python", "-m", "x"])  # no "--"
    assert command == ["python", "-m", "x"] and args.max_restarts == 16


def test_parse_args_custom_codes_and_any():
    args, _ = parse_args(["--restart-on", "7, 9", "--", "x"])
    assert args.restart_codes == {7, 9}
    args, _ = parse_args(["--restart-on", "any", "--", "x"])
    assert args.restart_codes is None


def test_parse_args_no_command_errors():
    with pytest.raises(SystemExit):
        parse_args(["--max-restarts", "3", "--"])


def test_should_restart_semantics_equal_jax():
    codes = {42, 43, 137, 143, -9, -15}
    assert not should_restart(0, codes)
    assert should_restart(43, codes)
    assert should_restart(-15, codes)   # raw SIGTERM == shell 143
    assert should_restart(-9, codes)    # raw SIGKILL == shell 137
    assert not should_restart(1, codes)
    assert should_restart(1, None)      # 'any' mode
    assert not should_restart(0, None)
    for restart_codes in (codes, {143}, {7}, None):
        for code in range(-20, 256):
            assert should_restart(code, restart_codes) == \
                jax_supervise.should_restart(code, restart_codes), code
    assert DEFAULT_RESTART_CODES == jax_supervise.DEFAULT_RESTART_CODES


def test_watchdog_fires_on_stall():
    fired = []
    # a 1 s timeout against kicks every 0.1 s: quiet even on a loaded
    # machine
    dog = Watchdog(1.0, _exit=lambda code: fired.append(code)).start()
    try:
        for _ in range(4):  # healthy phase: kicks keep it quiet
            time.sleep(0.1)
            dog.kick()
        assert not fired
        deadline = time.monotonic() + 5.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        dog.stop()
    assert fired == [Watchdog.EXIT_CODE] == [43]


def test_watchdog_stop_disarms():
    fired = []
    dog = Watchdog(0.2, _exit=lambda code: fired.append(code)).start()
    dog.stop()
    time.sleep(0.5)
    assert not fired and dog._thread is None
