"""What two design choices of K1 and K2 buy, measured on the GPU.

    python3 -m srf_tpu_torch.tools.sdr_variants   # from a checkout

Builds a variant copy of ``csrc/sdr_fwd.cu`` and ``csrc/sdr_bwd.cu`` for
each choice (one edit each, into ``srf_tpu_torch/_build/variants/``; the
port's own libraries are not touched) and measures it against the port's
kernels in the same process, on one card:

1. **The softmax's shortcut.** The register path skips the max reduction
   of a row's softmax where every logit of the warp's rows is within
   +-kSafeLogit (``csrc/sdr_stream.cuh``). The variant sets the bound below
   0, so every row takes the max. K1 (B=29, T'=64) and K2 (B=29, T'=61) at
   the three SRF-TIMIT geometries with chip_smoke.py's weight scale, where
   no logit comes near the bound: each variant held to the port's output
   within chip_smoke's tolerances and timed in turns with it (CUDA events);
   the sums over a forward's and a train step's 7 layers.
2. **u_hat kept, or recomputed.** K2 recomputes the prediction vectors.
   The variant keeps the forward's as a residual of the autograd function
   (K1 writes it into its scratch) and hands it to a ``sdr_bwd`` that skips
   the prediction launch. Its outputs and gradients
   must be bit-equal to the port's at the three SRF-TIMIT geometries
   (B=29, T'=61); then the SRF-TIMIT train step of chip_smoke.py (its
   model, weights and 29 x 241 batch, dropout on) each way in turns:
   ms/step (host clock, ending in a synchronize) and the peak of allocated
   memory over the steps, above what the train state holds.

The main path keeps the port's choices; this tool only measures. One card,
about a minute.
"""

import functools
import os
import subprocess
import sys
import time

import numpy as np

# (file, text, replacement) of each variant: one edit, made exactly once
SOFTMAX_WITH_MAX = (("sdr_stream.cuh", "constexpr float kSafeLogit = 64.f;",
                     "constexpr float kSafeLogit = -1.f;"),)
UHAT_KEPT = (("sdr_bwd.cu",
              "  cudaError_t err = sdr::launch_predict(u, w, bias, uhat, "
              "rows_total, in_n,\n"
              "                                        in_d, g.out_no, s);",
              "  cudaError_t err = cudaSuccess;  // u_hat: the forward's"),)
STEP_ROUNDS, STEPS_PER_ROUND = 3, 8


def variant_source(sources, edits):
    """``sources`` ({file name: text}) with each (file, text, replacement)
    edit made; raises unless each text occurs exactly once."""
    out = dict(sources)
    for file_name, text, replacement in edits:
        if out[file_name].count(text) != 1:
            raise ValueError("%s: the text to edit occurs %d times"
                             % (file_name, out[file_name].count(text)))
        out[file_name] = out[file_name].replace(text, replacement)
    return out


def build(label, edits):
    """Compile copies of csrc/sdr_fwd.cu and csrc/sdr_bwd.cu with ``edits``
    made; returns {library name: path}."""
    from srf_tpu_torch.ops import cuda_build

    sources = {}
    for file_name in ("sdr_fwd.cu", "sdr_bwd.cu", "sdr_stream.cuh"):
        with open(os.path.join(cuda_build.CSRC, file_name)) as src:
            sources[file_name] = src.read()
    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants", label)
    os.makedirs(out_dir, exist_ok=True)
    for file_name, text in variant_source(sources, edits).items():
        with open(os.path.join(out_dir, file_name), "w") as dst:
            dst.write(text)
    running, paths = {}, {}
    for name in ("sdr_fwd", "sdr_bwd"):
        paths[name] = os.path.join(out_dir, "lib%s.so" % name)
        running[name] = subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-I", out_dir, "-I",
             cuda_build.CSRC, "-o", paths[name],
             os.path.join(out_dir, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in running.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed on %s (%s):\n%s"
                               % (name, label, log))
    return paths


def load(paths):
    """The wrappers' ctypes libraries for ``paths`` ({name: path})."""
    from srf_tpu_torch.ops import cuda_build, routing_cuda

    real = cuda_build.build
    cuda_build.build = lambda names: {n: paths[n] for n in names}
    try:
        return {n: routing_cuda._lib.__wrapped__(n) for n in paths}
    finally:
        cuda_build.build = real


class Libraries:
    """Points the wrappers of ``ops.routing_cuda`` at one set of libraries
    at a time (``use``), so that two builds can be timed in turns."""

    def __init__(self, **sets):
        from srf_tpu_torch.ops import routing_cuda

        self.sets = sets
        self.current = None
        routing_cuda._lib = lambda name: self.sets[self.current][name]

    def use(self, label, fn):
        def call():
            self.current = label
            return fn()
        return call


def softmax_shortcut(torch, device, cs, libs):
    """Part 1: the port (shortcut) against the variant (max always)."""
    from srf_tpu_torch.ops.routing_cuda import (sequential_routing_bwd_cuda,
                                                sequential_routing_cuda)

    rng = np.random.RandomState(cs.SEED)
    totals = {"K1": [0.0, 0.0], "K2": [0.0, 0.0]}
    for name, geometry, mask, count in cs.TIMIT_LAYERS:
        in_n, out_n, out_d, in_d = geometry

        def rand(*shape, scale=1.0):
            return torch.tensor(rng.randn(*shape) * scale,
                                dtype=torch.float32, device=device)

        w = rand(in_n, out_n, out_d, in_d, scale=0.1)
        b = rand(in_n, out_n, out_d, scale=0.1)
        for label, seq_len in (("K1", 64), ("K2", 61)):
            u = rand(29, seq_len, in_n, in_d)
            libs.current = "port"
            vs = sequential_routing_cuda(u, w, b, 1, mask)
            dvs = rand(29, seq_len, out_n, out_d)
            if label == "K1":
                fn = functools.partial(sequential_routing_cuda, u, w, b, 1,
                                       mask)
            else:
                fn = functools.partial(sequential_routing_bwd_cuda, u, w, b,
                                       vs, dvs, mask)
            port, variant = libs.use("port", fn), libs.use("max", fn)
            got, ref = variant(), port()
            torch.cuda.synchronize()
            for x, y in zip(got if label == "K2" else [got],
                            ref if label == "K2" else [ref]):
                atol = (cs.K2_ATOL_REL * y.abs().max().item()
                        if label == "K2" else cs.ATOL)
                cs.check(torch.allclose(x, y, rtol=cs.RTOL, atol=atol),
                         "%s with the max always disagrees at %s"
                         % (label, geometry))
            reps = 20 if label == "K1" else 10
            port_ms, max_ms = cs.paired_ms(torch, port, variant, reps)
            totals[label][0] += count * port_ms
            totals[label][1] += count * max_ms
            print("softmax %s %s B=29 T=%d: shortcut %.4f ms, max always "
                  "%.4f ms (%+.1f %%)" % (label, name, seq_len, port_ms,
                                         max_ms,
                                         100 * (max_ms / port_ms - 1)))
    for label, what in (("K1", "forward"), ("K2", "train step")):
        port_ms, max_ms = totals[label]
        print("softmax %s per %s (7 layers): shortcut %.4f ms, max always "
              "%.4f ms (%+.1f %%)" % (label, what, port_ms, max_ms,
                                      100 * (max_ms / port_ms - 1)))


def uhat_residual(torch, cs, libs):
    """Part 2: recompute (the port) against the residual variant, over the
    SRF-TIMIT train step."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.ops import routing, routing_cuda

    class KeptUhat(torch.autograd.Function):
        """SDRFunction with u_hat kept from the forward (CUDA, one
        iteration only)."""

        @staticmethod
        def forward(ctx, u, wgt, bias, num_iter, mask_pad_capsule):
            batch, seq_len, in_n, in_d = u.shape
            out_n, out_d = wgt.shape[1], wgt.shape[2]
            sizes = (batch, seq_len, in_n, in_d, out_n, out_d)
            # K1's scratch starts with u_hat [B, T, in_n, pitch]; it is
            # kept for K2
            u_hat = torch.empty(
                libs.sets["kept"]["sdr_fwd"].sdr_fwd_scratch_floats(*sizes),
                dtype=torch.float32, device=u.device)
            out = torch.empty((batch, seq_len, out_n, out_d),
                              dtype=torch.float32, device=u.device)
            cs.check(num_iter == 1 and libs.sets["kept"]["sdr_fwd"].sdr_fwd(
                u.data_ptr(), wgt.data_ptr(), bias.data_ptr(), None, None,
                u_hat.data_ptr(), out.data_ptr(), *sizes, 1,
                int(bool(mask_pad_capsule)),
                torch.cuda.current_stream(u.device).cuda_stream) == 0,
                "K1 launch")
            ctx.save_for_backward(u, wgt, bias, out)
            ctx.u_hat, ctx.mask, ctx.sizes = u_hat, mask_pad_capsule, sizes
            return out

        @staticmethod
        def backward(ctx, dout):
            u, wgt, bias, out = ctx.saved_tensors
            dout = dout.contiguous()
            bwd = libs.sets["kept"]["sdr_bwd"]
            scratch = torch.empty(bwd.sdr_bwd_scratch_floats(*ctx.sizes),
                                  dtype=torch.float32, device=u.device)
            du, dwgt, dbias = (torch.empty_like(x) for x in (u, wgt, bias))
            cs.check(bwd.sdr_bwd(
                u.data_ptr(), wgt.data_ptr(), bias.data_ptr(),
                out.data_ptr(), dout.data_ptr(), ctx.u_hat.data_ptr(),
                scratch.data_ptr(), du.data_ptr(), dwgt.data_ptr(),
                dbias.data_ptr(), *ctx.sizes, int(bool(ctx.mask)),
                torch.cuda.current_stream(u.device).cuda_stream) == 0,
                "K2 launch")
            ctx.u_hat = None
            return du, dwgt, dbias, None, None

    # the same function: bit-equal outputs and gradients at each SRF-TIMIT
    # geometry
    rng = np.random.RandomState(cs.SEED + 3)
    libs.current = "port"
    for name, geometry, mask, _ in cs.TIMIT_LAYERS:
        in_n, out_n, out_d, in_d = geometry
        u, w, b = (torch.tensor(rng.randn(*shape) * scale,
                                dtype=torch.float32, device="cuda")
                   for shape, scale in (((29, 61, in_n, in_d), 1.0),
                                        ((in_n, out_n, out_d, in_d), 0.1),
                                        ((in_n, out_n, out_d), 0.1)))
        dvs = torch.tensor(rng.randn(29, 61, out_n, out_d),
                           dtype=torch.float32, device="cuda")
        leaves = [x.clone().requires_grad_() for x in (u, w, b)]
        out = KeptUhat.apply(*leaves, 1, mask)
        out.backward(dvs)
        want = routing_cuda.sequential_routing_cuda(u, w, b, 1, mask)
        grads = routing_cuda.sequential_routing_bwd_cuda(u, w, b, want, dvs,
                                                         mask)
        torch.cuda.synchronize()
        cs.check(torch.equal(out.detach(), want) and all(
            torch.equal(leaf.grad, g) for leaf, g in zip(leaves, grads)),
            "u_hat kept: K1/K2 differ from the port's at %s" % name)
    print("u_hat kept: outputs and (du, dW, db) bit-equal to the port's at "
          "the 3 SRF-TIMIT geometries (B=29, T'=61)")

    functions = {"recompute": routing_cuda.SDRFunction, "kept": KeptUhat}
    logger = Logger(name="sdr_variants", level=Logger.WARN).logger
    config = cs.timit_config(logger, "cuda")
    state = cs.random_weights(build_model(config, 63)[0])
    batch = cs.train_batch(torch, "cuda")
    runs = {}
    for label, function in functions.items():
        routing.SDRFunction = function
        train_state, _, step = cs.train_setup(torch, config, state, "cuda")
        runs[label] = (train_state, step)
    step_ms = {label: [] for label in functions}
    peak = {}
    for _ in range(STEP_ROUNDS):
        for label, function in functions.items():
            routing.SDRFunction = function
            train_state, step = runs[label]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            for _ in range(STEPS_PER_ROUND):
                start = time.perf_counter()
                train_state, _ = step(train_state, batch, config.tpu_seed)
                torch.cuda.synchronize()
                step_ms[label].append(1e3 * (time.perf_counter() - start))
            peak[label] = torch.cuda.max_memory_allocated() - base
            runs[label] = (train_state, step)
    routing.SDRFunction = routing_cuda.SDRFunction
    print("u_hat train step 29 x 241: " + "; ".join(
              "%s median %.3f ms (min %.3f, max %.3f) over %d steps, peak "
              "%.1f MiB above the state" % (
                  label, float(np.median(ms)), min(ms), max(ms), len(ms),
                  peak[label] / 2 ** 20) for label, ms in step_ms.items()))


def main():
    import torch

    if not torch.cuda.is_available():
        print("sdr_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from srf_tpu_torch.device import resolve_device
    from srf_tpu_torch.ops import cuda_build

    device = resolve_device("cuda")
    card = cs.card_line()
    print("card: %s; torch %s, CUDA %s" % (card, torch.__version__,
                                          torch.version.cuda))
    start = time.perf_counter()
    libs = Libraries(port=load(cuda_build.build(["sdr_fwd", "sdr_bwd"])),
                     max=load(build("max_always", SOFTMAX_WITH_MAX)),
                     kept=load(build("uhat_kept", UHAT_KEPT)))
    print("build: %.1f s" % (time.perf_counter() - start))
    softmax_shortcut(torch, device, cs, libs)
    uhat_residual(torch, cs, libs)
    print("[%s]" % card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
