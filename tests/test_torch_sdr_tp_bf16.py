"""bf16 routing on a shard of the out capsules (K1-tp-bf16's and
K2-tp-bf16's plain versions: ``ops/routing.sequential_routing_tp(...,
bf16=True)`` and ``sequential_routing_tp_bwd_bf16``, reached through
``route_layer(..., bf16=True, shard=...)`` and ``SDRTPFunction``) against
JAX's bf16 SDR on the whole W and b (``sequential_routing(compute_dtype=
bfloat16)``, the materialized scan whose rounding points the port
follows), at 1 shard (this process) and at 2 and 3 (real OS processes over
gloo, ``_torch_dist_worker.py``'s ``model_axis_7c`` scenario): each rank's
output slice within 1e-3 of the output's largest entry, du (summed over
the ranks) and each rank's dW and db slices within 2.5e-2 of their largest
entry (``tests/test_torch_routing_bf16.py``'s limits: F19, F20); and the
split bf16 SDR on one shard against the unsharded bf16 SDR."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.ops import routing as jax_routing
from srf_tpu_torch.ops import routing

from _torch_dist_worker import run_scenario

torch.set_num_threads(1)

# (in_n, out_n, out_d, in_d): the out capsules split over 2 and 3 ranks
GEOMETRY = (12, 6, 8, 4)
BATCH, STEPS = 2, 3
# (iterations, PAD mask)
CASES = [(1, 1), (1, 0), (2, 1)]
FWD_REL, BWD_REL = 1e-3, 2.5e-2


def _arrays():
    in_n, out_n, out_d, in_d = GEOMETRY
    rng = np.random.RandomState(21)
    return {"u": rng.randn(BATCH, STEPS, in_n, in_d).astype(np.float32),
            "W": (0.3 * rng.randn(in_n, out_n, out_d, in_d)).astype(
                np.float32),
            "b": (0.1 * rng.randn(in_n, out_n, out_d)).astype(np.float32),
            "cot": rng.randn(BATCH, STEPS, out_n, out_d).astype(np.float32)}


def _jax(case):
    """JAX's bf16 SDR on the whole W: (out, du, dW, db)."""
    num_iter, is_last = case
    arrays = _arrays()
    cot = jnp.asarray(arrays["cot"])

    def loss(u, w, b):
        out = jax_routing.sequential_routing(
            u, w, b, num_iter, bool(is_last), compute_dtype=jnp.bfloat16)
        return jnp.sum(out * cot), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(arrays[k]) for k in ("u", "W", "b")))
    return [np.asarray(x, np.float64) for x in (out, *grads)]


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{ranks: each rank's results} at 2 and 3 ranks."""
    results = {}
    for ranks in (2, 3):
        workdir = tmp_path_factory.mktemp("sdr_tp_bf16_%d" % ranks)
        spec = {"ranks": ranks, "bf16": CASES}
        np.savez(workdir / "inputs.npz", spec=json.dumps(spec),
                 **{"route/" + k: v for k, v in _arrays().items()})
        results[ranks] = run_scenario("model_axis_7c", workdir, ranks=ranks)
    return results


def _one_shard(case):
    num_iter, is_last = case
    arrays = _arrays()
    leaves = [torch.from_numpy(arrays[k]).requires_grad_()
              for k in ("u", "W", "b")]
    out = routing.route_layer(*leaves, num_iter, True, bool(is_last),
                              bf16=True, shard=(0, GEOMETRY[1], None))
    (out * torch.from_numpy(arrays["cot"])).sum().backward()
    return {"out": out.detach().numpy(), "du": leaves[0].grad.numpy(),
            "dW": leaves[1].grad.numpy(), "db": leaves[2].grad.numpy()}


@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "iter%d-pad%d" % c)
def test_split_bf16_matches_jax_bf16_route(runs, shards, case):
    want_out, want_du, want_dw, want_db = _jax(case)
    length = GEOMETRY[1] // shards
    if shards == 1:
        ranks = [dict(_one_shard(case), index=0)]
    else:
        key = "bf16/%d%d/" % case
        ranks = [{"out": r[key + "out"], "du": r[key + "du"],
                  "dW": r[key + "dW"], "db": r[key + "db"], "index": q}
                 for q, r in enumerate(runs[shards])]
        assert all(int(r["group_size"]) == shards for r in runs[shards])
    for rank in ranks:
        part = slice(rank["index"] * length, (rank["index"] + 1) * length)
        assert _rel(rank["out"], want_out[:, :, part]) <= FWD_REL
        assert _rel(rank["du"], want_du) <= BWD_REL
        assert _rel(rank["dW"], want_dw[:, part]) <= BWD_REL
        assert _rel(rank["db"], want_db[:, part]) <= BWD_REL
        # the gradients are the bf16 cotangents of the bf16 casts
        for name in ("du", "dW", "db"):
            g = torch.from_numpy(rank[name])
            assert torch.equal(g, g.bfloat16().float()), name


@pytest.mark.parametrize("case", CASES, ids=lambda c: "iter%d-pad%d" % c)
def test_one_shard_is_the_unsharded_bf16_sdr(case):
    """With no group the split softmax is the whole one: the split bf16
    SDR equals the unsharded bf16 SDR (sequential_routing(..., bf16=True))
    up to the softmax's form (exp(b - M) / L against torch.softmax)."""
    num_iter, is_last = case
    arrays = {k: torch.from_numpy(v) for k, v in _arrays().items()}
    args = (arrays["u"], arrays["W"], arrays["b"], num_iter, bool(is_last))
    got = routing.sequential_routing_tp(*args[:4], bool(is_last), None,
                                        bf16=True)
    want = routing.sequential_routing(*args, bf16=True)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    grads = routing.sequential_routing_tp_bwd_bf16(
        arrays["u"], arrays["W"], arrays["b"], arrays["cot"], bool(is_last),
        None, num_iter)
    refs = routing.sequential_routing_bwd_bf16(
        arrays["u"], arrays["W"], arrays["b"], arrays["cot"], bool(is_last),
        num_iter)
    for g, r in zip(grads, refs):
        assert g.dtype == torch.bfloat16
        # one bf16 ulp of the largest entry: a float32 sum in another form
        # may round an entry to its other neighbour
        np.testing.assert_allclose(g.float(), r.float(), rtol=0,
                                   atol=2 ** -7 * r.float().abs().max())
