"""Where a step of the SDR kernels (K1-K4) spends its cycles, on the GPU.

    python3 -m srf_tpu_torch.tools.sdr_phase_cycles   # from a checkout
    python3 -m srf_tpu_torch.tools.sdr_phase_cycles sdr_scan_fwd_kernel

Builds an instrumented copy of each SDR kernel (``csrc/sdr_fwd.cu``'s and
``sdr_bwd.cu``'s recurrence kernels, ``sdr_bwd.cu``'s weight-gradient
kernel, ``sdr_scan_fwd.cu``'s and ``sdr_scan_bwd.cu``'s cluster scans), one
at a time: at every timing site, thread 0 of block 0 reads ``clock64()``
and adds the cycles since the previous site to that site's sum. The sites
are the block barriers in the kernel's body (``__syncthreads();`` and the
compute warps' ``sdr::sync_compute();``: kind "block", the work since the
previous site and the barrier), both sides of each cluster-barrier wait in
the body (``sdr::cluster_wait();``: the site before it, kind "work",
closes the work since the previous site, which includes the barrier's
arrive; the site after it, kind "cluster_wait", is the wait), and both
sides of each wait on a ring slot's mbarrier (``mbar_wait(...);``, kinds
"work" and "ring_wait") in the helpers that wait for bulk copies: the warp
passes of ``csrc/sdr_stream.cuh`` (K1, K2) and ``ring_rows`` of
``csrc/sdr_cluster.cuh`` (K3, K4). Each site is named by its file, source
line and kind, and each kernel's sums are also given by kind. The copies
go to ``srf_tpu_torch/_build/phases/`` and are built with the port's nvcc
flags (the copies first on the include path, then ``csrc``); the port's
own libraries are not touched. Runs each kernel once at the SRF-TIMIT
serving shape (B=29, T'=64) at its three capsule-layer
geometries and prints, per kernel and geometry, the event time of the
instrumented call and block 0's kcycles per step by site (per call for the
weight-gradient kernel, whose block 0 takes every 1/grid-th work item
while other blocks share its SM). One card; a site's clock read and global
add cost tens of cycles. ``ncu`` would say
more, but does not run on every machine.
"""

import ctypes
import os
import re
import subprocess
import sys

import numpy as np

# (library, instrumented kernel) of K1, K2's reverse-time and weight-gradient
# kernels, K3, K4
KERNELS = (("sdr_fwd", "sdr_fwd_kernel"), ("sdr_bwd", "sdr_bwd_step_kernel"),
           ("sdr_bwd", "sdr_bwd_wgrad_kernel"),
           ("sdr_scan_fwd", "sdr_scan_fwd_kernel"),
           ("sdr_scan_bwd", "sdr_scan_bwd_kernel"))
# kernels with no time loop: their sums are per call
PER_CALL = ("sdr_bwd_wgrad_kernel",)
# the shared headers and their functions whose ring waits are timed
HEADER = "sdr_stream.cuh"
HELPERS = ("warp_pass_lanes", "warp_pass_rows")
CLUSTER_HEADER = "sdr_cluster.cuh"
CLUSTER_HELPERS = ("ring_rows",)
KINDS = ("block", "work", "cluster_wait", "ring_wait")
MAX_SITES = 40
# (in_n, out_n, out_d, in_d), PAD mask: the three SRF-TIMIT layers
GEOMETRIES = (((180, 30, 8, 8), False), ((90, 30, 8, 8), False),
              ((90, 63, 8, 8), True))
BATCH, SEQ_LEN = 29, 64
BARRIER = re.compile(r"(?:__syncthreads|(?:sdr::)?sync_compute)\(\);")
WAIT = re.compile(r"(?:sdr::)?mbar_wait\([^;]*\);")
CLUSTER_WAIT = re.compile(r"(?:sdr::)?cluster_wait\(\);")
_MARK = ("if (threadIdx.x == 0 && blockIdx.x == 0) { long long ph_now = "
         "clock64(); g_phase_cycles[%d] += ph_now - g_phase_last; "
         "g_phase_last = ph_now; }")
_DECL = ("__device__ long long g_phase_cycles[%d];\n"
         "__device__ long long g_phase_last;\n" % MAX_SITES)


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


def _mark_body(source, function, pattern, kind, sites, file_name):
    """``source`` with each statement matching ``pattern`` in ``function``'s
    body followed by a timing site of ``kind`` (and, for a wait, preceded
    by one of kind "work"); appends (file_name, line, kind) per site to
    ``sites``."""
    open_at, close_at = _body_span(source, function)
    body = source[open_at + 1:close_at]
    first_line = source.count("\n", 0, open_at + 1) + 1

    def site(site_kind):
        if len(sites) >= MAX_SITES:
            raise ValueError("more than %d timing sites" % MAX_SITES)
        sites.append((file_name, line, site_kind))
        return _MARK % (len(sites) - 1)

    def mark(match):
        nonlocal line
        line = first_line + body.count("\n", 0, match.start())
        before = site("work") + " " if kind != "block" else ""
        return before + match.group(0) + " " + site(kind)

    line = first_line
    body = pattern.sub(mark, body)
    return source[:open_at + 1] + body + source[close_at:]


def instrument(sources, name, kernel):
    """Instrumented copies of csrc/<name>.cu and, where ``kernel`` calls the
    helpers that wait on the ring, of their header. ``sources`` maps file
    names to their text. Returns ({file name: instrumented text},
    [(file name, line, kind) per site]): the body's block barriers first,
    then its cluster waits, then the helpers' ring waits. Adds a
    ``phase_read(long long*)`` C function that copies block 0's sums to the
    host."""
    cu = name + ".cu"
    sites = []
    source = _mark_body(sources[cu], kernel, BARRIER, "block", sites, cu)
    source = _mark_body(source, kernel, CLUSTER_WAIT, "cluster_wait", sites,
                        cu)
    open_at, _ = _body_span(source, kernel)
    source = (source[:open_at + 1]
              + "\n  if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
                "    for (int i = 0; i < %d; ++i) g_phase_cycles[i] = 0;\n"
                "    g_phase_last = clock64();\n  }" % MAX_SITES
              + source[open_at + 1:])
    out = {cu: _DECL + source
           + ('\nextern "C" int phase_read(long long* out) {\n'
              "  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles, "
              "sizeof(long long) * %d);\n}\n" % MAX_SITES)}
    body = sources[cu][slice(*_body_span(sources[cu], kernel))]
    for header_name, helpers, called in (
            (HEADER, HELPERS, "warp_pass"),
            (CLUSTER_HEADER, CLUSTER_HELPERS, "ring_rows")):
        if called not in body:
            continue
        header = sources[header_name]
        for helper in helpers:
            header = _mark_body(header, helper, WAIT, "ring_wait", sites,
                                header_name)
        out[header_name] = header
    return out, sites


def build(name, kernel):
    """Compile the instrumented copy of csrc/<name>.cu; returns (library
    path, [(file, line, kind) per site])."""
    from srf_tpu_torch.ops import cuda_build

    sources = {}
    for file_name in (name + ".cu", HEADER, CLUSTER_HEADER):
        with open(os.path.join(cuda_build.CSRC, file_name)) as src:
            sources[file_name] = src.read()
    copies, sites = instrument(sources, name, kernel)
    out_dir = os.path.join(cuda_build.BUILD_DIR, "phases", kernel)
    os.makedirs(out_dir, exist_ok=True)
    for file_name, text in copies.items():
        with open(os.path.join(out_dir, file_name), "w") as dst:
            dst.write(text)
    library = os.path.join(out_dir, "lib%s.so" % name)
    result = subprocess.run(
        [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-I", out_dir, "-I",
         cuda_build.CSRC, "-o", library, os.path.join(out_dir, name + ".cu")],
        capture_output=True, text=True)
    if result.returncode:
        raise RuntimeError("nvcc failed on %s:\n%s%s" % (
            name, result.stdout, result.stderr))
    return library, sites


def main(argv=()):
    """Every kernel of KERNELS, or those whose kernel names ``argv`` lists."""
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
    kernels = [(name, kernel) for name, kernel in KERNELS
               if not argv or kernel in argv]
    built = {kernel: build(name, kernel) for name, kernel in kernels}
    real_build = cuda_build.build
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
        for name, kernel in kernels:
            # the wrappers load the instrumented library of this kernel
            cuda_build.build = lambda names: {
                n: built[kernel][0] if n == name else real_build([n])[n]
                for n in names}
            routing_cuda._lib.cache_clear()
            call = calls[name]
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
            sites = built[kernel][1]
            per = "call" if kernel in PER_CALL else "step"
            steps = 1 if kernel in PER_CALL else SEQ_LEN
            per_step = [sums[i] / steps / 1e3 for i in range(len(sites))]
            by_kind = dict.fromkeys(KINDS, 0.0)
            for (_, _, kind), cyc in zip(sites, per_step):
                by_kind[kind] += cyc
            print("%s %s B=%d T=%d: %.3f ms (instrumented call); block 0 "
                  "%.1f kcycles per %s; by kind (kcycles/%s): %s; by site "
                  "(file:line:kind:kcycles/%s): %s [%s]"
                  % (kernel, geometry, BATCH, SEQ_LEN,
                     start.elapsed_time(end), sum(per_step), per, per,
                     " ".join("%s %.1f" % kv for kv in by_kind.items()), per,
                     " ".join(
                         "%s:%d:%s:%.1f" % (file_name, line, kind, cyc)
                         for (file_name, line, kind), cyc
                         in zip(sites, per_step)),
                     card))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
