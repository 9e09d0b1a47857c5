"""Which ``torch.distributed`` operations a backend runs on CUDA tensors.

    python -m srf_tpu_torch.tools.dist_probe [--ranks 2] [--out FILE]

Starts ``--ranks`` processes (one ``spawn`` each, a TCP store on a free
localhost port) that share ``cuda:0`` over gloo and tries every collective
and point-to-point operation the port's parallel paths use on CUDA
tensors, and FSDP2 (``fully_shard``) on a small model; then starts the same
number of processes under NCCL on that one card (NCCL refuses a device
that two ranks share) and one NCCL process alone. Each operation is
reported as "ok" or with its error's first line; a JSON object with
every result is the last line of standard output (and ``--out``). The
operations are tried in the same order on every rank, and every error
here is raised before any data moves, so the ranks stay in step.
"""

import argparse
import datetime
import json
import multiprocessing
import socket

import torch

TIMEOUT = datetime.timedelta(seconds=60)


def free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _first_line(exc):
    return ("%s: %s" % (type(exc).__name__, exc)).splitlines()[0][:300]


def _ops(dist, rank, n, device):
    def broadcast():
        x = torch.full((4,), float(rank), device=device)
        dist.broadcast(x, 0)
        assert x.eq(0).all()

    def all_reduce():
        x = torch.ones(4, device=device)
        dist.all_reduce(x)
        assert x.eq(n).all()

    def all_gather():
        parts = [torch.empty(4, device=device) for _ in range(n)]
        dist.all_gather(parts, torch.full((4,), float(rank), device=device))
        assert all(p.eq(i).all() for i, p in enumerate(parts))

    def all_gather_into_tensor():
        out = torch.empty(4 * n, device=device)
        dist.all_gather_into_tensor(out, torch.full((4,), float(rank),
                                                    device=device))
        assert out.view(n, 4)[:, 0].tolist() == list(map(float, range(n)))

    def reduce_scatter_tensor():
        out = torch.empty(4, device=device)
        dist.reduce_scatter_tensor(out, torch.ones(4 * n, device=device))
        assert out.eq(n).all()

    def batch_isend_irecv():
        recv = torch.empty(4, device=device)
        ops = [dist.P2POp(dist.isend, torch.full((4,), float(rank),
                                                 device=device), (rank + 1) % n),
               dist.P2POp(dist.irecv, recv, (rank - 1) % n)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        assert recv.eq((rank - 1) % n).all()

    def fsdp2():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard

        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(64, 64),
                                    torch.nn.Linear(64, 8)).to(device)
        fully_shard(model, mesh=init_device_mesh(device.type, (n,)))
        optimizer = torch.optim.Adam(model.parameters())
        model(torch.randn(3, 64, device=device)).sum().backward()
        optimizer.step()

    return [broadcast, all_reduce, all_gather, all_gather_into_tensor,
            reduce_scatter_tensor, batch_isend_irecv, fsdp2]


def worker(rank, n, port, backend, queue):
    import torch.distributed as dist

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    results = {}
    try:
        kwargs = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="tcp://localhost:%d"
                                % port, world_size=n, rank=rank,
                                timeout=TIMEOUT, **kwargs)
        if backend == "nccl":
            dist.barrier()
    except Exception as exc:  # noqa: BLE001 - the probe reports it
        results["init"] = _first_line(exc)
        queue.put((rank, results))
        return
    results["init"] = "ok"
    for op in _ops(dist, rank, n, device):
        try:
            op()
            torch.cuda.synchronize()
            results[op.__name__] = "ok"
        except Exception as exc:  # noqa: BLE001 - the probe reports it
            results[op.__name__] = _first_line(exc)
    dist.destroy_process_group()
    queue.put((rank, results))


def run(n, backend):
    """{rank: {operation: "ok" or error}} of ``n`` ranks on cuda:0."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=worker, args=(r, n, port, backend, queue))
             for r in range(n)]
    for proc in procs:
        proc.start()
    results = {}
    for _ in procs:
        rank, got = queue.get(timeout=600)
        results[rank] = got
    for proc in procs:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dist_probe needs a CUDA device")
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__,
              "gloo_%d_ranks_one_card" % args.ranks: run(args.ranks, "gloo"),
              "nccl_%d_ranks_one_card" % args.ranks: run(args.ranks, "nccl"),
              "nccl_1_rank": run(1, "nccl")}
    for key, value in report.items():
        if isinstance(value, dict):
            for rank, ops in sorted(value.items()):
                for op, result in ops.items():
                    print("%s rank %d %s: %s" % (key, rank, op, result))
    line = json.dumps(report)
    if args.out:
        with open(args.out, "w") as out:
            out.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
