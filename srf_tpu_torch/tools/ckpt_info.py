"""Checkpoint inspection: steps, subtrees, shapes/dtypes, param counts (the
port's counterpart of ``srf_tpu/tools/ckpt_info.py``).

Reads the port's ``torch.save`` checkpoints (``<path>/<step>/state.pt``,
``utils/checkpoint.py``) onto the CPU with ``weights_only=True``: no model
build, no GPU. A checkpoint holds ``"step"``, ``"model"`` (the state_dict),
``"optimizer"``, ``"scheduler"`` and, with an EMA (``--tpu-ema-decay``),
``"ema"``; each top-level entry is reported as a subtree, as JAX's tool
reports the orbax tree's (whose EMA subtree is ``ema_params``), in the
same lines.

Run:
    python -m srf_tpu_torch.tools.ckpt_info /path/to/ckpt [--step N] [--full]
"""

import sys

import numpy as np
import torch

from srf_tpu_torch.utils.checkpoint import CheckpointManager


def _walk(tree, prefix=""):
    """Yield (path, leaf) from nested dicts, lists and tuples; every dict
    key, an optimizer's integer parameter ids included, is a path part."""
    if isinstance(tree, dict):
        for key in sorted(tree, key=str):
            yield from _walk(tree[key], prefix + "/" + str(key))
        return
    if isinstance(tree, (list, tuple)):
        for index, value in enumerate(tree):
            yield from _walk(value, prefix + "/" + str(index))
        return
    yield prefix, tree


def _describe_leaf(leaf):
    """(shape, dtype name, entries) of a tensor or a number, the dtype named
    as numpy names it; None for what holds no numbers (a string, None)."""
    if torch.is_tensor(leaf):
        return (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""),
                leaf.numel())
    if isinstance(leaf, (bool, int, float, np.generic, np.ndarray)):
        arr = np.asarray(leaf)
        return tuple(arr.shape), arr.dtype, int(arr.size)
    return None


def describe(ckpt_path, step=None, full=False, out=None):
    """Write the report of ``ckpt_path`` to ``out`` (standard output when
    None); returns the exit code."""
    out = out if out is not None else sys.stdout
    manager = CheckpointManager(ckpt_path)
    steps = manager.all_steps()
    if not steps:
        out.write("no checkpoints under %s\n" % ckpt_path)
        return 1
    step = step if step is not None else steps[-1]
    out.write("checkpoint dir: %s\n" % ckpt_path)
    out.write("steps on disk:  %s\n" % ", ".join(str(s) for s in steps))
    out.write("inspecting:     step %d\n" % step)
    tree = manager.restore(step)  # torch.load(weights_only=True), CPU
    groups = {}
    for path, leaf in _walk(tree):
        described = _describe_leaf(leaf)
        if described is None:
            continue
        top = path.split("/")[1]
        groups.setdefault(top, []).append((path, *described))
    for top in sorted(groups):
        leaves = groups[top]
        total = sum(n for _, _, _, n in leaves)
        out.write(
            "  %-16s %4d leaves, %12s params\n"
            % (top, len(leaves), format(total, ","))
        )
        if full:
            for path, shape, dtype, n in leaves:
                out.write(
                    "    %-64s %-14s %s\n"
                    % (path, "x".join(map(str, shape)) or "scalar", dtype)
                )
    has_ema = "ema" in groups
    out.write(
        "EMA weights:    %s\n" % ("present (serve with --tpu-decode-ema)"
                                  if has_ema else "absent")
    )
    manager.close()
    return 0


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    step, full, pos = None, False, []
    it = iter(argv)
    for arg in it:
        if arg == "--full":
            full = True
        elif arg == "--step" or arg.startswith("--step="):
            val = arg.split("=", 1)[1] if "=" in arg else next(it, None)
            if not val:
                raise SystemExit("--step requires a value")
            step = int(val)
        else:
            pos.append(arg)
    if len(pos) != 1:
        print("usage: python -m srf_tpu_torch.tools.ckpt_info <ckpt_dir> "
              "[--step N] [--full]")
        return 1
    return describe(pos[0], step=step, full=full)


if __name__ == "__main__":
    raise SystemExit(main())
