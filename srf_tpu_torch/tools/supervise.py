"""Restart supervisor: turns restartable failures into completed jobs (the
port's own copy of ``srf_tpu/tools/supervise.py``, pure Python).

The reference's whole recovery story is "re-run the trainer by hand and it
resumes at the last epoch checkpoint" (reference: tfsr/trainer_sr.py:250-259
restores `tf.train.latest_checkpoint` on startup; nothing restarts a dead
process). This closes the loop: the trainer detects its own
failure modes and exits with a distinct restartable status —

- **43**: watchdog hang detection (``--tpu-watchdog-secs``; a stuck
  device call or host transfer is turned into a crash with stack dumps),
- **143 / SIGTERM**: cloud preemption notice (the loop saves a mid-epoch
  checkpoint at the next step boundary before exiting),
- **SIGKILL (137 / -9)**: the preemption that never got a notice,
- **42**: ``--tpu-fault-at-step`` hard-kill injection (tests),

and this supervisor relaunches the same command until it exits cleanly,
with bounded retries and linear backoff. Combined with
``--tpu-ckpt-every-steps`` mid-epoch checkpointing the restarted run
resumes where it stopped (bit-exactly on the CPU), so

    python -m srf_tpu_torch.tools.supervise -- \
        python -m srf_tpu_torch.trainer_sr ...

is a complete hang/preemption/crash-tolerant training job.

Ordinary failures (a traceback, exit 1) are NOT retried by default — a
config typo should fail fast, not loop. ``--restart-on any`` overrides.
"""

import argparse
import signal
import subprocess
import sys
import time

# exit statuses that mean "restart me": watchdog (43), SIGTERM-preempt
# (143 or raw signal -15), SIGKILL-preempt (137 or -9), fault injection (42)
DEFAULT_RESTART_CODES = (42, 43, 137, 143, -9, -15)


def parse_args(argv):
    parser = argparse.ArgumentParser(
        prog="python -m srf_tpu_torch.tools.supervise",
        description="Relaunch a training command on restartable exit codes.",
    )
    parser.add_argument(
        "--max-restarts", type=int, default=16,
        help="give up after N restarts (default 16)",
    )
    parser.add_argument(
        "--backoff-secs", type=float, default=0.0,
        help="sleep attempt*backoff seconds before each restart (default 0)",
    )
    parser.add_argument(
        "--restart-on", type=str, default=None,
        help="comma-separated exit codes to restart on, or 'any' for every "
             "nonzero exit (default: %s)"
             % ",".join(str(c) for c in DEFAULT_RESTART_CODES),
    )
    if "--" in argv:
        split = argv.index("--")
        own, command = argv[:split], argv[split + 1:]
    else:
        own, command = [], argv
    args = parser.parse_args(own)
    if not command:
        parser.error("no command given (usage: supervise [opts] -- cmd ...)")
    if args.restart_on is None:
        args.restart_codes = set(DEFAULT_RESTART_CODES)
    elif args.restart_on.strip().lower() == "any":
        args.restart_codes = None  # any nonzero
    else:
        args.restart_codes = {
            int(c) for c in args.restart_on.split(",") if c.strip()
        }
    return args, command


def should_restart(code, restart_codes):
    if code == 0:
        return False
    if restart_codes is None:
        return True
    # a child killed by signal S reports -S from subprocess and is
    # conventionally 128+S from a shell; accept either spelling
    return code in restart_codes or (code < 0 and 128 - code in restart_codes)


def supervise(command, max_restarts=16, backoff_secs=0.0,
              restart_codes=DEFAULT_RESTART_CODES, _print=print):
    """Run ``command`` until it exits 0, a non-restartable code, or the
    restart budget is exhausted. ``restart_codes=None`` retries ANY nonzero
    exit. Returns the final exit code. SIGTERM/SIGINT sent to the
    supervisor are forwarded to the child and end supervision (the child's
    own SIGTERM handler checkpoints; we must not relaunch a job the
    scheduler is tearing down)."""
    if restart_codes is not None and not isinstance(restart_codes, set):
        restart_codes = set(restart_codes)
    stopping = {"flag": False}
    child = {"proc": None}

    def forward(signum, frame):
        stopping["flag"] = True
        proc = child["proc"]
        if proc is not None and proc.poll() is None:
            proc.send_signal(signum)

    prev_term = signal.signal(signal.SIGTERM, forward)
    prev_int = signal.signal(signal.SIGINT, forward)
    try:
        attempt = 0
        while True:
            child["proc"] = subprocess.Popen(command)
            code = child["proc"].wait()
            child["proc"] = None
            if code == 0:
                if attempt:
                    _print(
                        "SUPERVISE: command succeeded after %d restart(s)"
                        % attempt, flush=True,
                    )
                return 0
            if stopping["flag"]:
                _print(
                    "SUPERVISE: not restarting (supervisor was signalled); "
                    "child exited %d" % code, flush=True,
                )
                return code
            if not should_restart(code, restart_codes):
                _print(
                    "SUPERVISE: exit %d is not restartable; giving up"
                    % code, flush=True,
                )
                return code
            attempt += 1
            if attempt > max_restarts:
                _print(
                    "SUPERVISE: restart budget exhausted (%d); last exit %d"
                    % (max_restarts, code), flush=True,
                )
                return code
            if backoff_secs > 0:
                time.sleep(backoff_secs * attempt)
            _print(
                "SUPERVISE: child exited %d; restart %d/%d"
                % (code, attempt, max_restarts), flush=True,
            )
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        signal.signal(signal.SIGINT, prev_int)


def main(argv=None):
    args, command = parse_args(sys.argv[1:] if argv is None else argv)
    code = supervise(
        command, max_restarts=args.max_restarts,
        backoff_secs=args.backoff_secs, restart_codes=args.restart_codes,
    )
    # a signal-killed child reports -S; sys.exit(-S) would be truncated
    # modulo 256 (e.g. -9 -> 247), so report the conventional 128+S
    return 128 - code if code < 0 else code


if __name__ == "__main__":
    sys.exit(main())
