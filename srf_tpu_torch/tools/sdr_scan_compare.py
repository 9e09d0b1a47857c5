"""K3/K4 against an earlier build of them, and K1/K2, on the same card, in
turns, at the SRF-TIMIT layers.

    python3 -m srf_tpu_torch.tools.sdr_scan_compare --baseline-csrc DIR

DIR is the ``srf_tpu_torch/csrc`` of another checkout (for example the
parent commit unpacked with ``git archive``) whose ``sdr_scan_fwd.cu`` and
``sdr_scan_bwd.cu`` have the C interface of the time-blocked, batch-tiled
kernels (forward: u, W, bias, out, then B, T, in_n, in_d, out_n, out_d,
iterations, mask, time block and the stream; backward: u, W, bias, vs, dvs,
du, dW, dbias, scratch, the sizes, mask, time block and the stream, with
``sdr_scan_bwd_scratch_floats``). Both builds go to
``srf_tpu_torch/_build/baseline/`` with the port's nvcc flags; the port's
own libraries are not touched. For each of the 7 routing layers of one
SRF-TIMIT forward (B=29, T'=64) and backward (T'=61) it holds the baseline
to the port's kernel (forward rtol 1e-4 / atol 1e-5; backward atol 1e-4 x
max|grad|), then times baseline, port, port, baseline with CUDA events,
and K1 or K2 beside them; prints per layer and for the 7 layers, with the
card's name, power limit and clock. One card.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

# (name, (in_n, out_n, out_d, in_d), PAD mask, layers per forward)
TIMIT_LAYERS = (("layer0", (180, 30, 8, 8), False, 1),
                ("middle", (90, 30, 8, 8), False, 5),
                ("last", (90, 63, 8, 8), True, 1))
BATCH, FWD_T, BWD_T, TIME_BLOCK = 29, 64, 61, 8


def build_baseline(csrc):
    """The baseline's K3 and K4 as ctypes libraries."""
    from srf_tpu_torch.ops import cuda_build

    out_dir = os.path.join(cuda_build.BUILD_DIR, "baseline")
    os.makedirs(out_dir, exist_ok=True)
    libs, procs = {}, []
    for name in ("sdr_scan_fwd", "sdr_scan_bwd"):
        path = os.path.join(out_dir, "lib%s.so" % name)
        procs.append((name, path, subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-I", csrc, "-o",
             path, os.path.join(csrc, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, path, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed on the baseline %s:\n%s"
                               % (name, log))
        libs[name] = ctypes.CDLL(path)
    ptr, num = ctypes.c_void_p, ctypes.c_int
    libs["sdr_scan_fwd"].sdr_scan_fwd.argtypes = [ptr] * 4 + [num] * 9 + [ptr]
    libs["sdr_scan_bwd"].sdr_scan_bwd.argtypes = [ptr] * 9 + [num] * 8 + [ptr]
    scratch = libs["sdr_scan_bwd"].sdr_scan_bwd_scratch_floats
    scratch.argtypes = [num] * 7
    scratch.restype = ctypes.c_longlong
    return libs


def event_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(torch, first, second, reps):
    """(first's ms, second's ms), each timed twice: first, second, second,
    first."""
    times = [event_ms(torch, fn, reps) for fn in (first, second, second,
                                                   first)]
    return (times[0] + times[3]) / 2, (times[1] + times[2]) / 2


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline-csrc", required=True)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sdr_scan_compare: no CUDA device", file=sys.stderr)
        return 1
    from srf_tpu_torch.device import resolve_device
    from srf_tpu_torch.ops import routing_cuda as rc

    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    base = build_baseline(os.path.abspath(args.baseline_csrc))
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.RandomState(0)
    totals = dict.fromkeys(("old_k3", "k3", "k1", "old_k4", "k4", "k2"), 0.0)
    for name, (in_n, out_n, out_d, in_d), mask, count in TIMIT_LAYERS:
        def rand(*shape, scale=1.0):
            return torch.tensor(rng.randn(*shape) * scale,
                                dtype=torch.float32, device=device)

        w = rand(in_n, out_n, out_d, in_d, scale=0.1)
        b = rand(in_n, out_n, out_d, scale=0.1)
        # forward at T'=64
        u = rand(BATCH, FWD_T, in_n, in_d)
        sizes = (BATCH, FWD_T, in_n, in_d, out_n, out_d)
        old_out = torch.empty((BATCH, FWD_T, out_n, out_d), device=device)

        def old_k3():
            err = base["sdr_scan_fwd"].sdr_scan_fwd(
                u.data_ptr(), w.data_ptr(), b.data_ptr(), old_out.data_ptr(),
                *sizes, 1, int(mask), TIME_BLOCK, stream)
            if err:
                raise RuntimeError("baseline K3 launch failed: %d" % err)

        new = rc.sequential_routing_scan_cuda(u, w, b, 1, mask, TIME_BLOCK)
        old_k3()
        torch.cuda.synchronize()
        if not torch.allclose(old_out, new, rtol=1e-4, atol=1e-5):
            raise RuntimeError("baseline K3 differs from K3 at %s" % name)
        old_ms, new_ms = in_turns(torch, old_k3, lambda: (
            rc.sequential_routing_scan_cuda(u, w, b, 1, mask, TIME_BLOCK)), 5)
        k1_ms = event_ms(torch, lambda: rc.sequential_routing_cuda(
            u, w, b, 1, mask), 20)
        # backward at T'=61
        u = rand(BATCH, BWD_T, in_n, in_d)
        dvs = rand(BATCH, BWD_T, out_n, out_d)
        vs = rc.sequential_routing_cuda(u, w, b, 1, mask)
        sizes = (BATCH, BWD_T, in_n, in_d, out_n, out_d)
        scratch = torch.empty(
            base["sdr_scan_bwd"].sdr_scan_bwd_scratch_floats(*sizes,
                                                             TIME_BLOCK),
            device=device)
        grads = [torch.empty_like(x) for x in (u, w, b)]

        def old_k4():
            err = base["sdr_scan_bwd"].sdr_scan_bwd(
                u.data_ptr(), w.data_ptr(), b.data_ptr(), vs.data_ptr(),
                dvs.data_ptr(), *(g.data_ptr() for g in grads),
                scratch.data_ptr(), *sizes, int(mask), TIME_BLOCK, stream)
            if err:
                raise RuntimeError("baseline K4 launch failed: %d" % err)

        new = rc.sequential_routing_scan_bwd_cuda(u, w, b, vs, dvs, mask,
                                                  TIME_BLOCK)
        old_k4()
        torch.cuda.synchronize()
        for label, old, now in zip(("du", "dW", "db"), grads, new):
            if not torch.allclose(old, now, rtol=1e-4,
                                  atol=1e-4 * now.abs().max().item()):
                raise RuntimeError("baseline K4 %s differs from K4 at %s"
                                   % (label, name))
        old_bwd, new_bwd = in_turns(torch, old_k4, lambda: (
            rc.sequential_routing_scan_bwd_cuda(u, w, b, vs, dvs, mask,
                                                TIME_BLOCK)), 3)
        k2_ms = event_ms(torch, lambda: rc.sequential_routing_bwd_cuda(
            u, w, b, vs, dvs, mask), 10)
        print("%s (x%d): forward K3 %.4f ms, baseline %.4f ms, K1 %.4f ms; "
              "backward K4 %.4f ms, baseline %.4f ms, K2 %.4f ms; plans %s %s"
              % (name, count, new_ms, old_ms, k1_ms, new_bwd, old_bwd, k2_ms,
                 rc.scan_plan("sdr_scan_fwd", u, w),
                 rc.scan_plan("sdr_scan_bwd", u, w)))
        for key, ms in (("old_k3", old_ms), ("k3", new_ms), ("k1", k1_ms),
                        ("old_k4", old_bwd), ("k4", new_bwd), ("k2", k2_ms)):
            totals[key] += count * ms
    print("7 layers, B=%d: forward (T'=%d) K3 %.4f ms, baseline %.4f ms, K1 "
          "%.4f ms; backward (T'=%d) K4 %.4f ms, baseline %.4f ms, K2 %.4f "
          "ms [%s]" % (BATCH, FWD_T, totals["k3"], totals["old_k3"],
                       totals["k1"], BWD_T, totals["k4"], totals["old_k4"],
                       totals["k2"], card))
    return 0


if __name__ == "__main__":
    sys.exit(main())
