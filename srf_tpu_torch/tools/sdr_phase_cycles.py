"""Where a step of the SDR kernels (K1-K4) spends its cycles, on the GPU.

    python3 -m srf_tpu_torch.tools.sdr_phase_cycles   # from a checkout

Builds an instrumented copy of each SDR kernel (``csrc/sdr_fwd.cu``,
``sdr_bwd.cu``'s reverse-time kernel, ``sdr_scan_fwd.cu``,
``sdr_scan_bwd.cu``'s scan kernel): after every ``__syncthreads()`` thread 0
reads ``clock64()`` and adds the cycles since the previous barrier to that
barrier's sum, which block 0 writes out at its end. Each barrier closes a
phase of the step, so the sums say which phase (named by the source line of
its closing barrier) takes the time. The copies go to
``srf_tpu_torch/_build/phases/`` and are built with the port's nvcc flags;
the port's own libraries are not touched. Runs each kernel once at the
SRF-TIMIT serving shape (B=29, T'=64) at its three capsule-layer geometries
and prints, per kernel and geometry, the event time of the instrumented
launch and block 0's kcycles per step by barrier. One card; the timer's
loads and adds cost a few percent of a step. ``ncu`` would say more, but
does not run on every machine.
"""

import ctypes
import os
import re
import subprocess
import sys

import numpy as np

# (library, instrumented kernel) of K1, K2's reverse-time kernel, K3, K4
KERNELS = (("sdr_fwd", "sdr_fwd_kernel"), ("sdr_bwd", "sdr_bwd_step_kernel"),
           ("sdr_scan_fwd", "sdr_scan_fwd_kernel"),
           ("sdr_scan_bwd", "sdr_scan_bwd_kernel"))
MAX_SITES = 40
# (in_n, out_n, out_d, in_d), PAD mask: the three SRF-TIMIT layers
GEOMETRIES = (((180, 30, 8, 8), False), ((90, 30, 8, 8), False),
              ((90, 63, 8, 8), True))
BATCH, SEQ_LEN = 29, 64
_MARK = ("__syncthreads(); if (threadIdx.x == 0) { long long ph_now = "
         "clock64(); ph_sum[%d] += ph_now - ph_last; ph_last = ph_now; }")


def _body_span(source, kernel):
    """(index of the opening brace, index of the closing brace) of the
    definition of ``kernel`` in ``source``."""
    match = re.search(r"\b%s\s*\([^;{]*\)\s*\{" % re.escape(kernel), source)
    if match is None:
        raise ValueError("no definition of %s" % kernel)
    open_at = match.end() - 1
    depth = 0
    for at in range(open_at, len(source)):
        depth += {"{": 1, "}": -1}.get(source[at], 0)
        if depth == 0:
            return open_at, at
    raise ValueError("unbalanced braces in %s" % kernel)


def instrument(source, kernel):
    """The source with ``kernel``'s barriers timed, and the source line of
    each barrier (site i is ``lines[i]``). Adds a ``phase_read(long long*)``
    C function that copies block 0's sums to the host."""
    open_at, close_at = _body_span(source, kernel)
    body = source[open_at + 1:close_at]
    first_line = source.count("\n", 0, open_at + 1) + 1
    lines = []

    def mark(match):
        lines.append(first_line + body.count("\n", 0, match.start()))
        if len(lines) > MAX_SITES:
            raise ValueError("%s has more than %d barriers" % (kernel,
                                                               MAX_SITES))
        return _MARK % (len(lines) - 1)

    body = re.sub(r"__syncthreads\(\);", mark, body)
    body = ("\n  long long ph_last = clock64();\n"
            "  long long ph_sum[%d];\n"
            "  for (int i = 0; i < %d; ++i) ph_sum[i] = 0;%s"
            "  if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
            "    for (int i = 0; i < %d; ++i) g_phase_cycles[i] = ph_sum[i];\n"
            "  }\n" % (MAX_SITES, MAX_SITES, body, MAX_SITES))
    out = source[:open_at + 1] + body + source[close_at:]
    out = out.replace("namespace {", "__device__ long long g_phase_cycles[%d];"
                      "\n\nnamespace {" % MAX_SITES, 1)
    out += ('\nextern "C" int phase_read(long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles, "
            "sizeof(long long) * %d);\n}\n" % MAX_SITES)
    return out, lines


def build(name, kernel):
    """Compile the instrumented copy of csrc/<name>.cu; returns (library
    path, barrier source lines)."""
    from srf_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.CSRC, name + ".cu")) as src:
        source, lines = instrument(src.read(), kernel)
    out_dir = os.path.join(cuda_build.BUILD_DIR, "phases")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name + ".cu")
    with open(path, "w") as dst:
        dst.write(source)
    library = os.path.join(out_dir, "lib%s.so" % name)
    result = subprocess.run(
        [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", library, path],
        capture_output=True, text=True)
    if result.returncode:
        raise RuntimeError("nvcc failed on %s:\n%s%s" % (
            path, result.stdout, result.stderr))
    return library, lines


def main():
    import torch

    if not torch.cuda.is_available():
        print("sdr_phase_cycles: no CUDA device", file=sys.stderr)
        return 1
    from srf_tpu_torch.device import resolve_device
    from srf_tpu_torch.ops import cuda_build, routing_cuda

    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("card: %s" % card)
    built = {name: build(name, kernel) for name, kernel in KERNELS}
    # the wrappers load the instrumented libraries from here on
    cuda_build.build = lambda names: {n: built[n][0] for n in names}
    routing_cuda._lib.cache_clear()
    rng = np.random.RandomState(0)
    for geometry, mask in GEOMETRIES:
        in_n, out_n, out_d, in_d = geometry

        def rand(*shape, scale=1.0):
            return torch.tensor(rng.randn(*shape) * scale,
                                dtype=torch.float32, device=device)

        u = rand(BATCH, SEQ_LEN, in_n, in_d)
        w = rand(in_n, out_n, out_d, in_d, scale=0.1)
        b = rand(in_n, out_n, out_d, scale=0.1)
        dvs = rand(BATCH, SEQ_LEN, out_n, out_d)
        vs = routing_cuda.sequential_routing_cuda(u, w, b, 1, mask)
        calls = {
            "sdr_fwd": lambda: routing_cuda.sequential_routing_cuda(
                u, w, b, 1, mask),
            "sdr_bwd": lambda: routing_cuda.sequential_routing_bwd_cuda(
                u, w, b, vs, dvs, mask),
            "sdr_scan_fwd": lambda: routing_cuda.sequential_routing_scan_cuda(
                u, w, b, 1, mask),
            "sdr_scan_bwd":
                lambda: routing_cuda.sequential_routing_scan_bwd_cuda(
                    u, w, b, vs, dvs, mask),
        }
        for name, call in calls.items():
            call()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
            lib = routing_cuda._lib(name)
            lib.phase_read.argtypes = [ctypes.c_void_p]
            sums = (ctypes.c_longlong * MAX_SITES)()
            err = lib.phase_read(ctypes.addressof(sums))
            if err:
                raise RuntimeError("phase_read failed: %d" % err)
            lines = built[name][1]
            per_step = [sums[i] / SEQ_LEN / 1e3 for i in range(len(lines))]
            print("%s %s B=%d T=%d: %.3f ms (instrumented launch); block 0 "
                  "%.1f kcycles per step; by barrier (%s.cu:line "
                  "kcycles/step): %s [%s]"
                  % (name, geometry, BATCH, SEQ_LEN, start.elapsed_time(end),
                     sum(per_step), name, " ".join(
                         "%d:%.1f" % (line, cyc)
                         for line, cyc in zip(lines, per_step)), card))
    return 0


if __name__ == "__main__":
    sys.exit(main())
