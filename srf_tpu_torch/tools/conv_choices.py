"""Measure how many of cuDNN's candidates each convolution of a model needs
timed, and write the table ``ops/conv_choice.py`` keeps.

    python3 -m srf_tpu_torch.tools.conv_choices --shapes 29x241,17x391 \
        --out srf_tpu_torch/ops/conv_choices.json [--verify] -- <flags>

``<flags>`` are the model's options as ``trainer_sr`` takes them (those of
``benchmark/configs/<config>.json``'s ``argv``). On one card:

1. **capture**: a training forward and backward of the model at each
   ``BxT`` shape records every convolution problem its ``conv2d_same``
   calls pose (forward, data gradient, weight gradient), by
   ``conv_choice.problem_key``, and how often a step poses it;
2. **time**: one child process per candidate count in ``LIMITS`` (PyTorch
   keeps its choice per process and thread) runs each problem's first call
   with ``cudnn.benchmark`` on and ``benchmark_limit`` at that count (the
   choice's seconds), then times ten calls with CUDA events (the median);
3. **table**: at each shape, every problem starts at its cheapest count;
   while the shape's problems, weighted by their calls a step, run more
   than ``TOLERANCE`` slower than under the full search (the last
   count), the problem whose next count buys back the most milliseconds a
   step for each second of choice moves to it. The table names the card
   and the cuDNN version it holds for;
4. ``--verify``: one child with the full search and one with the table
   train a step at each shape: the first step's seconds (the choice) and
   the median of the next eight.

It prints one JSON line per measurement; ``--timings FILE`` makes the
table from such lines (a capture's and the timings') without the card.
TF32 stays off (``resolve_device``).
"""

import argparse
import json
import os
import subprocess
import sys
import time

LIMITS = (1, 2, 3, 4, 6, 10)
STEADY_CALLS, STEPS = 10, 8
# a shape's problems may run this much slower than under the full search
# (about 0.55 % of a CNN-TIMIT step, whose convolutions take ~75 % of it)
TOLERANCE = 0.0075
# output classes of the model built (the projections' width: no
# convolution problem depends on it)
CLASSES = 63


def parse_shapes(text):
    return [tuple(int(v) for v in shape.split("x"))
            for shape in text.split(",")]


def choose_limits(timings, counts, tolerance):
    """{problem key: candidates} (module docstring, step 3) from
    ``timings`` ({limit: {key: (choice seconds, median ms)}}) and
    ``counts`` ({shape: {key: calls a step}}), the full search being the
    largest limit."""
    full = timings[max(timings)]
    out = {}
    for calls in counts.values():
        def slower(key, limit):
            return calls[key] * max(timings[limit][key][1] - full[key][1], 0)

        budget = tolerance * sum(n * full[key][1] for key, n in calls.items())
        chosen = {key: min(timings, key=lambda limit: timings[limit][key][0])
                  for key in calls}
        while sum(slower(key, chosen[key]) for key in calls) > budget:
            _, key, limit = max(
                ((slower(key, chosen[key]) - slower(key, limit))
                 / max(timings[limit][key][0]
                       - timings[chosen[key]][key][0], 1e-3), key, limit)
                for key in calls for limit in timings
                if slower(key, limit) < slower(key, chosen[key]))
            chosen[key] = limit
        out.update(chosen)
    return out


def capture(torch, fn):
    """({problem key: replay}, {problem key: calls}) of the convolutions
    ``fn`` runs through ``ops.conv_choice``, in first-seen order:
    ``replay`` holds the call's direction, tensors' shapes and strides,
    stride and padding."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from srf_tpu_torch.ops import conv_choice

    seen, calls = {}, {}

    def described(t):
        return {"shape": list(t.shape), "stride": list(t.stride())}

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            if name == "aten.convolution.default":
                x, w, stride, padding = args[0], args[1], args[3], args[4]
                replay = {"dir": "fwd"}
            elif name == "aten.convolution_backward.default":
                x, w, stride, padding = args[1], args[2], args[4], args[5]
                mask = args[10]
                replay = {"dir": "dgrad" if mask[0] else "wgrad",
                          "grad": described(args[0])}
            else:
                return func(*args, **(kwargs or {}))
            key = conv_choice.problem_key(replay["dir"], x, w, stride,
                                          padding)
            replay.update(x=described(x), w=described(w),
                          stride=list(stride), padding=list(padding))
            seen.setdefault(key, replay)
            calls[key] = calls.get(key, 0) + 1
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return seen, calls


def replay_call(torch, replay):
    """A function that runs ``replay``'s convolution on random tensors of
    its shapes and strides."""
    def tensor(desc):
        out = torch.empty_strided(desc["shape"], desc["stride"],
                                  device="cuda")
        return out.normal_()

    x, w = tensor(replay["x"]), tensor(replay["w"])
    stride, padding = replay["stride"], replay["padding"]
    if replay["dir"] == "fwd":
        return lambda: torch.ops.aten.convolution(
            x, w, None, stride, padding, [1, 1], False, [0, 0], 1)
    grad = tensor(replay["grad"])
    mask = [replay["dir"] == "dgrad", replay["dir"] == "wgrad", False]
    return lambda: torch.ops.aten.convolution_backward(
        grad, x, w, None, stride, padding, [1, 1], False, [0, 0], 1, mask)


def build(torch, flags):
    """(state, train step, config) of the model ``flags`` state, on the
    card."""
    from srf_tpu_torch.config import Logger, ParseOption
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.train import step as step_mod
    from srf_tpu_torch.train.optimizer import get_optimizer
    from srf_tpu_torch.train.state import TrainState

    logger = Logger(name="conv_choices", level=Logger.WARN).logger
    config = ParseOption(["conv_choices"] + flags + ["--device=cuda"],
                         logger, is_print_opts=False).args
    model, in_len_div = build_model(config, CLASSES)
    state = TrainState.create(model, None, None, device="cuda")
    state.optimizer, state.scheduler = get_optimizer(
        config, state.model.parameters())
    step = step_mod.make_train_step(step_mod.make_apply_fn(state.model),
                                    in_len_div)
    return state, step, config


def batch(torch, shape, feat_dim, seed=0):
    """A random batch of ``shape`` (B, T): lengths 0.7 T .. T, 0.12
    labels a frame."""
    gen = torch.Generator().manual_seed(seed)
    rows, frames = shape
    lengths = torch.randint(int(0.7 * frames), frames + 1, (rows,),
                            generator=gen)
    tar_len = torch.clamp((lengths * 0.12).round().long(), min=1)
    labels = torch.randint(1, CLASSES - 1, (rows, int(tar_len.max())),
                           generator=gen)
    return {"feats": torch.randn(rows, frames, feat_dim,
                                 generator=gen).cuda(),
            "labels": labels.to(torch.int32).cuda(),
            "inp_len": lengths.to(torch.int32),
            "tar_len": tar_len.to(torch.int32)}


def child_capture(torch, args):
    from srf_tpu_torch.ops import conv_choice

    # one candidate each: the capture needs the calls, not their speed
    conv_choice.kept_limit = lambda *_: 1
    state, _, config = build(torch, args.flags)
    model = state.model.train()
    problems, counts = {}, {}
    for shape in parse_shapes(args.shapes):
        data = batch(torch, shape, config.feat_dim)

        def forward_backward():
            logits = model(data["feats"], data["inp_len"].cuda(),
                           torch.Generator("cuda").manual_seed(1))
            logits.sum().backward()

        seen, calls = capture(torch, forward_backward)
        problems.update(seen)
        counts["%dx%d" % shape] = calls
    print(json.dumps({"problems": problems, "counts": counts}), flush=True)


def child_time(torch, args):
    from srf_tpu_torch.device import resolve_device

    resolve_device("cuda")
    torch.backends.cudnn.benchmark_limit = args.limit
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "cudnn": torch.backends.cudnn.version(),
                      "torch": torch.__version__}), flush=True)
    with open(args.problems) as src:
        problems = json.load(src)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for key, replay in problems.items():
        call = replay_call(torch, replay)
        torch.cuda.synchronize()
        began = time.perf_counter()
        call()
        torch.cuda.synchronize()
        first = time.perf_counter() - began
        times = []
        for _ in range(STEADY_CALLS):
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        print(json.dumps({"limit": args.limit, "key": key, "first_s": first,
                          "median_ms": times[len(times) // 2]}), flush=True)


def child_verify(torch, args):
    from srf_tpu_torch.ops import conv_choice

    # the table measured, or none (every problem searched in full)
    conv_choice.TABLE = args.table or os.devnull + ".none"
    state, step, config = build(torch, args.flags)
    for shape in parse_shapes(args.shapes):
        data = batch(torch, shape, config.feat_dim)
        torch.cuda.synchronize()
        began = time.perf_counter()
        step(state, data, 1)
        torch.cuda.synchronize()
        first = time.perf_counter() - began
        times = []
        for _ in range(STEPS):
            began = time.perf_counter()
            step(state, data, 1)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - began))
        times.sort()
        print(json.dumps({"verify": "kept" if args.table else "searched",
                          "shape": list(shape), "first_s": first,
                          "median_ms": times[len(times) // 2],
                          "choices": dict(conv_choice.conv_choices)}),
              flush=True)


def run_child(stage, args, extra=()):
    """The lines of JSON a child stage printed."""
    argv = [sys.executable, "-m", "srf_tpu_torch.tools.conv_choices",
            "--stage", stage, "--shapes", args.shapes, "--out", args.out,
            *extra, "--", *args.flags]
    done = subprocess.run(argv, check=True, stdout=subprocess.PIPE,
                          text=True)
    return [json.loads(line) for line in done.stdout.splitlines()
            if line.startswith("{")]


def measure(args):
    """The JSON lines of the capture and of every limit's timings."""
    captured = run_child("capture", args)[0]
    lines = [captured]
    path = args.out + ".problems"
    with open(path, "w") as out:
        json.dump(captured["problems"], out)
    for limit in LIMITS:
        lines += run_child("time", args, ("--limit", str(limit),
                                          "--problems", path))
    os.remove(path)
    for line in lines[1:]:
        print(json.dumps(line), flush=True)
    return lines


def make_table(lines, tolerance=TOLERANCE):
    """The table from a capture's and the timings' JSON lines."""
    timings, counts, card = {}, None, None
    for line in lines:
        if "counts" in line:
            counts = line["counts"]
        elif "limit" in line:
            timings.setdefault(line["limit"], {})[line["key"]] = (
                line["first_s"], line["median_ms"])
        elif "device" in line:
            card = line
    return dict(card, tolerance=tolerance,
                limits=choose_limits(timings, counts, tolerance))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shapes", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--verify", action="store_true")
    parser.add_argument("--timings", default=None)
    parser.add_argument("--stage", default=None)
    parser.add_argument("--limit", type=int, default=10)
    parser.add_argument("--problems", default=None)
    parser.add_argument("--table", default=None)
    parser.add_argument("flags", nargs="*")
    args = parser.parse_args(argv)
    import torch

    stages = {"capture": child_capture, "time": child_time,
              "verify": child_verify}
    if args.stage:
        return stages[args.stage](torch, args)
    if args.timings:
        with open(args.timings) as src:
            lines = [json.loads(line) for line in src
                     if line.startswith("{")]
    else:
        lines = measure(args)
    table = make_table(lines)
    with open(args.out, "w") as out:
        json.dump(table, out, indent=1, sort_keys=True)
    print(json.dumps({"table": args.out, "problems": len(table["limits"])}),
          flush=True)
    if args.verify:
        for extra in ((), ("--table", os.path.abspath(args.out))):
            for row in run_child("verify", args, extra):
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
