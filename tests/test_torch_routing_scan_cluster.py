"""The cluster scan's order of sums and launch plan, on the CPU (K3 and K4
themselves, ``csrc/sdr_scan_fwd.cu`` and ``csrc/sdr_scan_bwd.cu``, build and
run only on the card).

- ``sequential_routing_scan_partitioned`` and
  ``sequential_routing_scan_bwd_partitioned`` (the kernels' order: batch
  tiles, slices of rows summed apart and added in rank order, per-cluster
  partials of dW and db added in cluster order) equal ``sequential_routing``
  and ``sequential_routing_bwd`` in float64 to 1e-10, over splits where the
  cluster is in_n, does not divide in_n, and the tile does not divide B,
  with the PAD mask on and off and 1 and 2 forward iterations.
- In float32 they agree with JAX's ``sequential_routing_pallas_scan`` (the
  Pallas K3 and, for one iteration, K4 in interpret mode on the CPU) and
  with ``jax.grad`` through it: rtol 1e-4 / atol 1e-5 for outputs (the same
  float32 math, sums in another order) and atol 1e-4 x max|grad| for
  gradients (sums over B x T terms in another order).
- ``plan_scan`` (``csrc/sdr_plan.cuh``, host C++ built with g++) gives every
  one of 20,000 random capsule geometries that K1/K2 take a plan within the
  card's 227 KB of shared memory, with a cluster of at most 16 CTAs and at
  most in_n, whose slices cover every row once and whose tiles cover the
  batch; at the three SRF-TIMIT layers at B=29 with 7 clusters resident,
  K3 keeps W's slice in shared memory and every tile is resident at once.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.ops.routing_pallas import sequential_routing_pallas_scan
from srf_tpu_torch.ops import cuda_build, routing

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
GRAD_ATOL_REL = 1e-4
SMEM_BYTES = 232448


def _problem(seed=0, B=5, T=6, in_n=6, in_d=4, out_n=5, out_d=3,
             dtype=np.float64):
    """u, W, b and a cotangent dvs, from a numpy seed."""
    rng = np.random.RandomState(seed)
    u = rng.randn(B, T, in_n, in_d).astype(dtype)
    W = (rng.randn(in_n, out_n, out_d, in_d) * 0.3).astype(dtype)
    b = (rng.randn(in_n, out_n, out_d) * 0.1).astype(dtype)
    dvs = rng.randn(B, T, out_n, out_d).astype(dtype)
    return u, W, b, dvs


# (B, batch tile, in_n, cluster): the cluster equal to in_n, not dividing
# it, one CTA, and the tile not dividing B
SPLITS = [(5, 2, 6, 6), (5, 5, 6, 4), (4, 3, 7, 1), (5, 2, 20, 16)]


@pytest.mark.parametrize("num_iter", [1, 2])
@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("B,bt,in_n,cluster", SPLITS)
def test_partitioned_forward_equals_sequential_routing(B, bt, in_n, cluster,
                                                       mask, num_iter):
    u, W, b, _ = (torch.from_numpy(x) for x in _problem(
        seed=in_n + num_iter, B=B, in_n=in_n))
    want = routing.sequential_routing(u, W, b, num_iter, mask)
    got = routing.sequential_routing_scan_partitioned(u, W, b, num_iter, mask,
                                                      bt, cluster)
    assert got.dtype == torch.float64 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("B,bt,in_n,cluster", SPLITS)
def test_partitioned_backward_equals_sequential_routing_bwd(B, bt, in_n,
                                                            cluster, mask):
    u, W, b, dvs = (torch.from_numpy(x) for x in _problem(
        seed=10 + in_n, B=B, in_n=in_n))
    vs = routing.sequential_routing(u, W, b, 1, mask)
    want = routing.sequential_routing_bwd(u, W, b, vs, dvs, mask)
    got = routing.sequential_routing_scan_bwd_partitioned(u, W, b, vs, dvs,
                                                          mask, bt, cluster)
    for name, g, w in zip(("du", "dW", "db"), got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10, msg=name)


@pytest.mark.parametrize("num_iter,mask", [(1, True), (2, False)])
def test_partitioned_forward_matches_pallas_scan(num_iter, mask):
    u, W, b, _ = _problem(seed=20 + num_iter, B=3, T=11, dtype=np.float32)
    want = sequential_routing_pallas_scan(
        jnp.asarray(u), jnp.asarray(W), jnp.asarray(b), num_iter, mask, 4)
    got = routing.sequential_routing_scan_partitioned(
        *(torch.from_numpy(x) for x in (u, W, b)), num_iter, mask, 2, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("mask", [True, False])
def test_partitioned_backward_matches_jax_grad_through_pallas_scan(mask):
    u, W, b, dvs = _problem(seed=30, B=3, T=11, dtype=np.float32)

    def loss(u_, w_, b_):
        out = sequential_routing_pallas_scan(u_, w_, b_, 1, mask, 4)
        return jnp.sum(out * jnp.asarray(dvs))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(u), jnp.asarray(W), jnp.asarray(b))
    tu, tw, tb = (torch.from_numpy(x) for x in (u, W, b))
    vs = routing.sequential_routing_scan_partitioned(tu, tw, tb, 1, mask, 2,
                                                     4)
    got = routing.sequential_routing_scan_bwd_partitioned(
        tu, tw, tb, vs, torch.from_numpy(dvs), mask, 2, 4)
    for name, g, w in zip(("du", "dW", "db"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_ATOL_REL * np.abs(w).max(),
                                   err_msg=name)


# csrc/sdr_plan.cuh built with the host's C++ compiler: the cluster scan's
# plan as [ok, bt, clusters, cluster, rows, caps, ring, w_resident,
# uhat_bufs, smem bytes], the split of n items, and K1's and K2's
# recurrence plans (their shared memory, or -1 where they refuse)
_PLAN_SOURCE = r'''
#include "sdr_plan.cuh"
extern "C" void scan(int backward, int batch, int seq_len, int in_n,
                     int in_d, int out_n, int out_d, int time_block,
                     int clusters, int* out) {
  sdr::ScanPlan p;
  out[0] = sdr::plan_scan(backward, batch, seq_len, in_n, in_d, out_n, out_d,
                          time_block, clusters, &p);
  if (!out[0]) return;
  const int f[9] = {p.bt, p.clusters, p.cluster, p.rows, p.caps, p.ring,
                    p.w_resident, p.uhat_bufs, (int)sdr::scan_smem_bytes(p)};
  for (int i = 0; i < 9; ++i) out[i + 1] = f[i];
}
extern "C" int split(int n, int parts, int q) {
  return sdr::split_begin(n, parts, q);
}
extern "C" int owner(int n, int parts, int i) {
  return sdr::split_owner(n, parts, i);
}
extern "C" int fwd(int a, int b, int c, int d) {
  return sdr::fwd_smem_bytes(a, b, c, d);
}
extern "C" int bwd(int a, int b, int c, int d) {
  return sdr::bwd_smem_bytes(a, b, c, d);
}
'''
_FIELDS = ("ok", "bt", "clusters", "cluster", "rows", "caps", "ring",
           "w_resident", "uhat_bufs", "smem_bytes")
# (in_n, in_d, out_n, out_d) of the SRF-TIMIT layers
_TIMIT = ((180, 8, 30, 8), (90, 8, 30, 8), (90, 8, 63, 8))


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build csrc/sdr_plan.cuh on the host")
    out = tmp_path_factory.mktemp("scan_plan")
    (out / "plan.cpp").write_text(_PLAN_SOURCE)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    cuda_build.CSRC, "-o", str(out / "plan.so"),
                    str(out / "plan.cpp")], check=True)
    lib = ctypes.CDLL(str(out / "plan.so"))
    for fn in (lib.split, lib.owner, lib.fwd, lib.bwd):
        fn.restype = ctypes.c_int
    return lib


def _plan(lib, backward, *args):
    out = (ctypes.c_int * len(_FIELDS))()
    lib.scan(int(backward), *args, out)
    return dict(zip(_FIELDS, out))


@pytest.mark.parametrize("backward", [False, True])
def test_every_geometry_k1_k2_take_has_a_scan_plan(plans, backward):
    rng = np.random.RandomState(11 + backward)
    draws = np.exp(rng.uniform(0, np.log(2 ** 15), size=(20000, 4)))
    checked = 0
    for in_n, in_d, out_n, out_d in draws.astype(int).tolist():
        takes = plans.bwd if backward else plans.fwd
        if takes(in_n, in_d, out_n, out_d) < 0:
            continue
        batch, seq_len, time_block, clusters = (
            int(rng.randint(1, 65)), int(rng.randint(1, 300)),
            int(rng.randint(1, 17)), int(rng.randint(1, 17)))
        p = _plan(plans, backward, batch, seq_len, in_n, in_d, out_n, out_d,
                  time_block, clusters)
        where = (in_n, in_d, out_n, out_d, batch, seq_len, time_block)
        assert p["ok"], where
        assert 0 < p["smem_bytes"] <= SMEM_BYTES, where
        assert 1 <= p["cluster"] <= min(16, in_n), where
        assert 0 <= p["ring"] <= min(time_block, seq_len), where
        # the tiles cover the batch, none empty
        assert p["bt"] * p["clusters"] >= batch, where
        assert (p["clusters"] - 1) * p["bt"] < batch, where
        # the slices of rows cover every row once, each within `rows`
        begins = [plans.split(in_n, p["cluster"], q)
                  for q in range(p["cluster"] + 1)]
        assert begins[0] == 0 and begins[-1] == in_n, where
        sizes = np.diff(begins)
        assert sizes.min() >= 1 and sizes.max() <= p["rows"], where
        checked += 1
    assert checked > 2000


def test_split_owner_inverts_split_begin(plans):
    """split_owner is the inverse of split_begin, and the plain version's
    split is the kernels'."""
    for n in (1, 3, 5, 30, 63, 90, 180, 500):
        for parts in range(1, 17):
            for i in range(n):
                q = plans.owner(n, parts, i)
                assert plans.split(n, parts, q) <= i < plans.split(
                    n, parts, q + 1)
                assert plans.split(n, parts, q) == routing.split_begin(
                    n, parts, q)


@pytest.mark.parametrize("geometry", _TIMIT)
def test_timit_layers_keep_w_resident_and_every_tile_resident(plans,
                                                              geometry):
    fwd = _plan(plans, False, 29, 64, *geometry, 8, 7)
    assert fwd["ok"] and fwd["w_resident"] == 1
    assert fwd["cluster"] == 16 and fwd["clusters"] <= 7
    assert fwd["bt"] * fwd["clusters"] >= 29
    assert fwd["ring"] == 8
    bwd = _plan(plans, True, 29, 61, *geometry, 8, 7)
    assert bwd["ok"] and bwd["cluster"] == 16 and bwd["clusters"] <= 7
