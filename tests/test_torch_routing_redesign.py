"""The plain versions of the SDR kernels' parts against srf_tpu and against
the plain SDR: the prediction kernel's layout (``predict_capsules_rows``),
K1's recurrence from given prediction vectors
(``sequential_routing_from_uhat``), K2's reverse-time recurrence
(``sequential_routing_bwd_factors``) and its weight gradient from du_hat's
factors (``sdr_weight_grads``). Composed, they are ``sequential_routing``
and ``sequential_routing_bwd`` (float64, against autograd through the plain
loop to 1e-10) and agree with the Pallas K1 and K2 in interpret mode
(float32, rtol 1e-4 / atol 1e-5: the same math with sums in another
order). Also: the kernels' launch plans (``csrc/sdr_plan.cuh``, built
with the host's C++ compiler) take every capsule geometry the kernels
before them took, and a CUDA source's build path follows the headers it
includes.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from srf_tpu.ops import routing as jax_routing
from srf_tpu.ops.routing_pallas import (_pallas_sdr_bwd,
                                        sequential_routing_pallas)
from srf_tpu_torch.ops import cuda_build, routing

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _problem(seed=0, B=3, T=6, in_n=6, in_d=4, out_n=5, out_d=3,
             dtype=np.float32):
    """u, W, b, dvs; out_n * out_d = 15 is not a multiple of 4, so the
    kernels' rows carry padding."""
    rng = np.random.RandomState(seed)
    u = rng.randn(B, T, in_n, in_d)
    W = rng.randn(in_n, out_n, out_d, in_d) * 0.3
    b = rng.randn(in_n, out_n, out_d) * 0.1
    dvs = rng.randn(B, T, out_n, out_d)
    return [x.astype(dtype) for x in (u, W, b, dvs)]


def _routed_from_rows(u, W, b, num_iter, mask):
    """K1's two parts composed: u_hat in the kernels' layout, cut back to
    [B, T, in_n, out_n, out_d], then the recurrence."""
    out_n, out_d = W.shape[1], W.shape[2]
    rows = routing.predict_capsules_rows(u, W, b)
    u_hat = rows[..., :out_n * out_d].reshape(*rows.shape[:3], out_n, out_d)
    return routing.sequential_routing_from_uhat(u_hat, num_iter, mask)


def _bwd_from_parts(u, W, b, vs, dvs, mask):
    """K2's parts composed: prediction, the reverse-time factors, the weight
    gradient from them."""
    u_hat = routing.predict_capsules(u, W, b)
    c, da, ds = routing.sequential_routing_bwd_factors(u_hat, vs, dvs, mask)
    return routing.sdr_weight_grads(u, W, vs, c, da, ds)


def test_rows_layout_pads_each_row_with_zeros():
    u, W, b, _ = (torch.from_numpy(x) for x in _problem())
    rows = routing.predict_capsules_rows(u, W, b)
    assert routing.row_pitch(15) == 16 and rows.shape == (3, 6, 6, 16)
    assert torch.equal(rows[..., 15], torch.zeros(3, 6, 6))
    assert torch.equal(rows[..., :15].reshape(3, 6, 6, 5, 3),
                       routing.predict_capsules(u, W, b))
    assert routing.row_pitch(240) == 240 and routing.row_pitch(1) == 4


@pytest.mark.parametrize("num_iter,mask", [(1, True), (1, False), (2, True)])
def test_composed_forward_is_sequential_routing_float64(num_iter, mask):
    u, W, b, _ = (torch.from_numpy(x)
                  for x in _problem(seed=1, dtype=np.float64))
    got = _routed_from_rows(u, W, b, num_iter, mask)
    assert torch.equal(got, routing.sequential_routing(u, W, b, num_iter,
                                                       mask))
    # against the step-by-step loop with u_hat built inside it
    v = torch.zeros(3, 5, 3, dtype=torch.float64)
    mask_vec = routing._pad_capsule_mask(5, torch.float64, u.device)
    for t in range(u.shape[1]):
        u_hat_t = torch.einsum("noij,bnj->bnoi", W, u[:, t]) + b[None]
        v = routing._sdr_step(u_hat_t, v, num_iter,
                              mask_vec if mask else None)
        torch.testing.assert_close(got[:, t], v, rtol=0, atol=1e-12)


@pytest.mark.parametrize("mask", [True, False])
def test_composed_backward_is_autograd_of_the_plain_loop_float64(mask):
    u, W, b, dvs = (torch.from_numpy(x)
                    for x in _problem(seed=2, dtype=np.float64))
    vs = routing.sequential_routing(u, W, b, 1, mask)
    got = _bwd_from_parts(u, W, b, vs, dvs, mask)
    want = routing.sequential_routing_bwd(u, W, b, vs, dvs, mask)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    leaves = [x.clone().requires_grad_() for x in (u, W, b)]
    routing.sequential_routing(*leaves, 1, mask).backward(dvs)
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g, leaf.grad, rtol=0, atol=1e-10)


@pytest.mark.parametrize("num_iter,mask", [(1, True), (1, False), (2, True)])
def test_composed_forward_matches_pallas_k1_interpret(num_iter, mask):
    u, W, b, _ = _problem(seed=3, B=2)
    want = sequential_routing_pallas(jnp.asarray(u), jnp.asarray(W),
                                     jnp.asarray(b), num_iter, mask)
    got = _routed_from_rows(*(torch.from_numpy(x) for x in (u, W, b)),
                            num_iter, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("mask", [True, False])
def test_composed_backward_matches_pallas_k2_interpret(mask):
    u, W, b, dvs = _problem(seed=4, B=3, T=5)
    vs = jax_routing.sequential_routing(jnp.asarray(u), jnp.asarray(W),
                                        jnp.asarray(b), 1, mask)
    want = _pallas_sdr_bwd(jnp.asarray(u), jnp.asarray(W), jnp.asarray(b),
                           vs, jnp.asarray(dvs), mask, interpret=True)
    got = _bwd_from_parts(*(torch.from_numpy(x) for x in (u, W, b)),
                          torch.from_numpy(np.array(vs)),
                          torch.from_numpy(dvs), mask)
    for name, g, w in zip(("du", "dW", "db"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_weight_gradient_from_factors_equals_the_du_hat_form():
    """out_n * out_d = 15: the row pitch of the kernels' u_hat is padded."""
    u, W, b, dvs = (torch.from_numpy(x)
                    for x in _problem(seed=5, dtype=np.float64))
    vs = routing.sequential_routing(u, W, b, 1, True)
    u_hat = routing.predict_capsules_rows(u, W, b)[..., :15].reshape(
        3, 6, 6, 5, 3)
    c, da, ds = routing.sequential_routing_bwd_factors(u_hat, vs, dvs, True)
    got = routing.sdr_weight_grads(u, W, vs, c, da, ds)
    # du_hat written out step by step, and dW, db, du summed from it
    du = torch.empty_like(u)
    dW, db = torch.zeros_like(W), torch.zeros_like(b)
    for t in range(u.shape[1]):
        v_prev = vs[:, t - 1] if t > 0 else torch.zeros_like(vs[:, 0])
        du_hat = (c[:, t, :, :, None] * ds[:, t, None]
                  + da[:, t, :, :, None] * v_prev[:, None])
        dW += torch.einsum("bnoi,bnj->noij", du_hat, u[:, t])
        db += du_hat.sum(dim=0)
        du[:, t] = torch.einsum("bnoi,noij->bnj", du_hat, W)
    for g, w in zip(got, (du, dW, db)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12)


# The kernels' launch plans (csrc/sdr_plan.cuh: host C++ without CUDA's
# headers), built with the host's C++ compiler. fwd/bwd: the recurrence
# kernels' shared memory for (in_n, in_d, out_n, out_d), or -1;
# predict/wgrad: the tiles of W[n] the prediction and weight-gradient
# kernels take for (in_d, out_no), or -1 if their shared memory overflows.
_PLAN_SOURCE = r'''
#include "sdr_plan.cuh"
extern "C" int fwd(int a, int b, int c, int d) {
  return sdr::fwd_smem_bytes(a, b, c, d);
}
extern "C" int bwd(int a, int b, int c, int d) {
  return sdr::bwd_smem_bytes(a, b, c, d);
}
extern "C" int predict(int in_d, int out_no) {
  const sdr::PredictPlan p = sdr::plan_predict(in_d, out_no);
  if (sdr::predict_smem_bytes(p) > sdr::kMaxSmemBytes) return -1;
  return (out_no + p.o_tile - 1) / p.o_tile *
         ((in_d + p.j_tile - 1) / p.j_tile);
}
extern "C" int wgrad(int in_d, int out_no) {
  sdr::Wgrad p;
  sdr::plan_wgrad(1, 1, in_d, out_no, 0, &p);
  if (sdr::wgrad_smem_floats(p) * 4 > sdr::kMaxSmemBytes) return -1;
  return (out_no + p.o_tile - 1) / p.o_tile *
         ((in_d + p.j_tile - 1) / p.j_tile);
}
'''
_SMEM_FLOATS = 232448 // 4
# (in_n, in_d, out_n, out_d) of the recipes' routing layers: SRF-TIMIT's
# three, the WSJ recipe's layer 0
_RECIPE_GEOMETRIES = ((180, 8, 30, 8), (90, 8, 30, 8), (90, 8, 63, 8),
                      (300, 20, 30, 20))


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build csrc/sdr_plan.cuh on the host")
    out = tmp_path_factory.mktemp("plan")
    (out / "plan.cpp").write_text(_PLAN_SOURCE)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    cuda_build.CSRC, "-o", str(out / "plan.so"),
                    str(out / "plan.cpp")], check=True)
    lib = ctypes.CDLL(str(out / "plan.so"))
    for fn in (lib.fwd, lib.bwd, lib.predict, lib.wgrad):
        fn.restype = ctypes.c_int
    return lib


def _tiled_kernels_fit(in_n, in_d, out_n, out_d, backward):
    """Whether the kernels before the streaming redesign took a geometry:
    one block per utterance held u_t, the logits of every row, a tile of
    u_hat_t's rows and 1024 / out_no partial sums in shared memory (K2 also
    dv, ds, s and v_{t-1}), and K2's weight gradient held W[n] and dW[n]
    whole."""
    out_no = out_n * out_d
    groups = 1024 // out_no if out_no < 1024 else 1
    fixed = (in_n * in_d + (4 if backward else 2) * out_no + in_n * out_n
             + groups * out_no)
    fits = fixed + out_n + out_no <= _SMEM_FLOATS
    if backward:
        fits &= out_no * (2 * in_d + 1) + out_no + in_d <= _SMEM_FLOATS
    return fits


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_every_geometry_the_tiled_kernels_took_still_fits(plans, kernel):
    """K1 and K2 take every capsule geometry the kernels before them took
    (log-uniform draws of each dim in 1..2^15, and edge cases), with
    shared memory inside the card's 227 KB."""
    fn = getattr(plans, kernel)
    rng = np.random.RandomState(7)
    draws = np.exp(rng.uniform(0, np.log(2 ** 15), size=(20000, 4)))
    cases = [tuple(int(x) for x in row) for row in draws.astype(int)]
    cases += [(10, 64, 32, 32), (1, 30000, 2, 2), (2, 6000, 2, 2),
              (3, 16, 500, 10), (1, 1, 14000, 1), (20000, 1, 1, 1),
              (1, 1, 1, 14000), *_RECIPE_GEOMETRIES]
    took = [g for g in cases if _tiled_kernels_fit(*g, kernel == "bwd")]
    assert len(took) > 2000
    refused = [g for g in took if not 0 < fn(*g) <= 232448]
    assert not refused, refused[:10]
    for g in cases:
        assert fn(*g) <= 232448


def test_prediction_and_weight_gradient_tile_w_only_where_it_must(plans):
    """The recipes' geometries take W[n] whole (one tile); any W[n] fits
    in tiles."""
    for in_n, in_d, out_n, out_d in _RECIPE_GEOMETRIES:
        assert plans.predict(in_d, out_n * out_d) == 1
        assert plans.wgrad(in_d, out_n * out_d) == 1
    assert plans.predict(64, 1024) == 2 and plans.wgrad(64, 1024) == 4
    rng = np.random.RandomState(8)
    for in_d, out_no in np.exp(rng.uniform(0, np.log(_SMEM_FLOATS),
                                           size=(5000, 2))).astype(int):
        assert plans.predict(int(in_d), int(out_no)) >= 1
        assert plans.wgrad(int(in_d), int(out_no)) >= 1


def test_build_path_follows_the_included_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cu").write_text("int other;\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    first = cuda_build.library_path("k")
    other = cuda_build.library_path("other")
    assert cuda_build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    edited = cuda_build.library_path("k")
    assert edited != first and os.path.basename(edited).startswith("k-")
    assert cuda_build.library_path("other") == other
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n// a, edited\n')
    assert cuda_build.library_path("k") != edited
