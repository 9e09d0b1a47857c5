"""How the port's convolutions choose cuDNN's algorithm at each problem, and
the choices it keeps (F14).

PyTorch (torch 2.11 over cuDNN 9's graph API) chooses a cuDNN execution
plan at the first call of each convolution problem (direction, shapes,
strides, memory layout, dtype) in each thread, and keeps it for that
thread's later calls, whatever the settings are then. With
``cudnn.benchmark`` it times the first ``cudnn.benchmark_limit``
candidates of cuDNN's heuristic list (10 by default: the full search) and
takes the fastest; without, it takes the heuristic's first candidate that
runs.

In float32 with TF32 off the search is what makes the maxout CNN fast (the
heuristic's first candidates run its train steps 3-13 % slower, 11x at 29
x 241) and what makes its set-up slow: ~40 s at each new train shape on an
H100, most of it spent timing slow weight-gradient candidates that rank
low in the list and never win. For each problem measured on a card and a
cuDNN version, the table ``conv_choices.json`` beside this module keeps
how many candidates to time: the fewest that keep each train shape's
convolutions within 0.75 % of their time under the full search
(``tools/conv_choices.py`` measures them: on an H100 the CNN-TIMIT train
buckets' choices take 13.5 s against the full search's 214 s, and each
step runs within 1.5 % of the fully searched one). At a problem's
first call in a thread, :class:`ChosenConv2d` turns the search on with
``cudnn.benchmark_limit`` at the kept count; at a problem the table does
not hold (another card, cuDNN version or shape) it searches in full. Either
way the call runs inside a ``srf.conv.choose`` span (``utils/profiler.py``)
keyed by the problem, and ``conv_choices`` counts it as ``"kept"`` or
``"searched"``; later calls are plain ``aten.convolution`` calls. The
backward's data and weight gradients are problems of their own, chosen in
the thread autograd runs them in.

On the CPU there is nothing to choose: the same calls run, and nothing is
counted.
"""

import functools
import json
import os
import threading

import torch

from srf_tpu_torch.utils.profiler import span

TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "conv_choices.json")
# first calls by how their algorithm was chosen
conv_choices = {"searched": 0, "kept": 0}
_local = threading.local()


def problem_key(direction, x, weight, stride, padding):
    """The problem a call of ``direction`` (``fwd``, ``dgrad``, ``wgrad``)
    poses, as text: shapes, stride, padding, the input's memory layout and
    the dtype."""
    channels_last = (x.dim() == 4 and not x.is_contiguous()
                     and x.is_contiguous(memory_format=torch.channels_last))
    return "%s x%s w%s s%s p%s %s %s" % (
        direction, "x".join(map(str, x.shape)),
        "x".join(map(str, weight.shape)), "x".join(map(str, stride)),
        "x".join(map(str, padding)), "nhwc" if channels_last else "nchw",
        str(x.dtype).replace("torch.", ""))


@functools.lru_cache(maxsize=None)
def load_table(path):
    """The kept table at ``path``: {"device": card name, "cudnn": version,
    "limits": {problem key: candidates}}; empty where there is none."""
    if not os.path.isfile(path):
        return {"limits": {}}
    with open(path) as src:
        return json.load(src)


def kept_limit(key, device_name, cudnn_version, table=None):
    """The candidates the kept table holds for ``key`` on this card and
    cuDNN version, or None (the full search)."""
    table = load_table(TABLE) if table is None else table
    if (table.get("device") != device_name
            or table.get("cudnn") != cudnn_version):
        return None
    return table["limits"].get(key)


def _chosen():
    """This thread's problems whose algorithm is chosen."""
    try:
        return _local.chosen
    except AttributeError:
        _local.chosen = set()
        return _local.chosen


def _run(key, x, call):
    """``call()``; at ``key``'s first call in this thread on a CUDA device,
    inside its choice (module docstring)."""
    chosen = _chosen()
    if not x.is_cuda or key in chosen:
        return call()
    cudnn = torch.backends.cudnn
    limit = kept_limit(key, torch.cuda.get_device_name(x.device),
                       cudnn.version())
    saved = cudnn.benchmark, cudnn.benchmark_limit
    with span("srf.conv.choose", key=key):
        cudnn.benchmark = True
        if limit is not None:
            cudnn.benchmark_limit = limit
        try:
            out = call()
        finally:
            cudnn.benchmark, cudnn.benchmark_limit = saved
    chosen.add(key)
    conv_choices["searched" if limit is None else "kept"] += 1
    return out


class ChosenConv2d(torch.autograd.Function):
    """``F.conv2d(x, weight, None, stride, padding)`` (``apply(x, weight,
    stride, padding)``, the last two tuples), each direction's algorithm
    chosen at its first call (:func:`_run`)."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.padding = stride, padding
        key = problem_key("fwd", x, weight, stride, padding)
        return _run(key, x, lambda: torch.ops.aten.convolution(
            x, weight, None, stride, padding, (1, 1), False, (0, 0), 1))

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding = ctx.stride, ctx.padding
        grads = []
        for index, direction in enumerate(("dgrad", "wgrad")):
            if not ctx.needs_input_grad[index]:
                grads.append(None)
                continue
            mask = [index == 0, index == 1, False]
            key = problem_key(direction, x, weight, stride, padding)
            grads.append(_run(key, x, lambda: torch.ops.aten.
                              convolution_backward(
                                  grad, x, weight, None, stride, padding,
                                  (1, 1), False, (0, 0), 1, mask)[index]))
        return grads[0], grads[1], None, None

