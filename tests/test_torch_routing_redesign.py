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
# predict: the tiles of W[n] the prediction kernel takes for (in_d,
# out_no) at a large call (out tiles times tiles of in entries), or -1 if
# its shared memory overflows; predict_info: its whole plan for (rows,
# in_n, in_d, out_no, esize, slots); wgrad: the same for the
# weight gradient at (in_d, out_n, out_d) (1 on its tiled path, which holds
# W[n] whole); wgrad_bytes: the weight gradient's shared memory for (in_n,
# in_d, out_n, out_d); wgrad_tiled: 1 where it takes the tiled path;
# wgrad_threads: its block's threads.
_PLAN_SOURCE = r'''
#include "sdr_plan.cuh"
extern "C" int fwd(int a, int b, int c, int d) {
  return sdr::fwd_smem_bytes(a, b, c, d);
}
extern "C" int bwd(int a, int b, int c, int d) {
  return sdr::bwd_smem_bytes(a, b, c, d);
}
static sdr::PredictPlan predict_plan(int rows, int in_n, int in_d,
                                     int out_no, int esize, int slots) {
  sdr::PredictPlan p;
  sdr::plan_predict(rows, in_n, in_d, out_no, esize, slots, &p);
  return p;
}
extern "C" int predict(int in_d, int out_no) {
  const sdr::PredictPlan p = predict_plan(4096, 150, in_d, out_no, 4, 132);
  if (sdr::predict_smem_bytes(p) > sdr::kMaxSmemBytes) return -1;
  return p.o_tiles * ((in_d + p.j_tile - 1) / p.j_tile);
}
extern "C" void predict_info(int rows, int in_n, int in_d, int out_no,
                             int esize, int slots, long long* info) {
  const sdr::PredictPlan p =
      predict_plan(rows, in_n, in_d, out_no, esize, slots);
  const long long got[13] = {
      sdr::predict_tiled(in_d), p.jq, p.j_tile, p.o_tiles,
      p.o_quads,   p.groups,    p.n_groups,  p.tile_rows,
      p.row_tiles, p.units,     p.blocks,
      (long long)sdr::predict_smem_bytes(p), sdr::predict_threads(p)};
  for (int k = 0; k < 13; ++k) info[k] = got[k];
}
static sdr::Wgrad wgrad_plan(int in_d, int out_n, int out_d) {
  sdr::Wgrad p;
  sdr::plan_wgrad(1, 1, in_d, out_n, out_d, 0, &p);
  return p;
}
extern "C" int wgrad_bytes(int in_n, int in_d, int out_n, int out_d) {
  (void)in_n;
  const sdr::Wgrad p = wgrad_plan(in_d, out_n, out_d);
  const size_t bytes = sdr::wgrad_smem_floats(p, out_n, out_d) * 4;
  return bytes > sdr::kMaxSmemBytes ? -1 : (int)bytes;
}
extern "C" int wgrad(int in_d, int out_n, int out_d) {
  const sdr::Wgrad p = wgrad_plan(in_d, out_n, out_d);
  if (wgrad_bytes(1, in_d, out_n, out_d) < 0) return -1;
  if (p.tiled) return 1;
  const int out_no = out_n * out_d;
  return (out_no + p.o_tile - 1) / p.o_tile *
         ((in_d + p.j_tile - 1) / p.j_tile);
}
extern "C" int wgrad_tiled(int in_d, int out_n, int out_d) {
  return wgrad_plan(in_d, out_n, out_d).tiled;
}
extern "C" int wgrad_threads(int in_d, int out_n, int out_d) {
  return wgrad_plan(in_d, out_n, out_d).tiled ? sdr::kWgradThreads
                                              : sdr::kWgradGeneralThreads;
}
'''
_SMEM_FLOATS = 232448 // 4
# (in_n, in_d, out_n, out_d) of the recipes' routing layers: SRF-TIMIT's
# three, the WSJ recipe's layer 0
_RECIPE_GEOMETRIES = ((180, 8, 30, 8), (90, 8, 30, 8), (90, 8, 63, 8),
                      (300, 20, 30, 20))
# every routing layer of the recipes (SRF-TIMIT's three, SRF-WSJ's layer 0,
# layers 1-8 and the class layer), and the shards K2-tp takes of them on a
# `model` axis of 2 or 3 ranks (out_n / R, where R divides out_n)
_RECIPE_LAYERS = _RECIPE_GEOMETRIES + ((150, 20, 30, 20), (150, 20, 32, 20))
_TP_SHARDS = tuple(sorted({(in_n, in_d, out_n // ranks, out_d)
                           for in_n, in_d, out_n, out_d in _RECIPE_LAYERS
                           for ranks in (2, 3) if out_n % ranks == 0}))
# the SM's shared memory and what the card keeps of it a block (H100)
_SM_SMEM, _BLOCK_RESERVED = 233472, 1024


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
    for fn in (lib.fwd, lib.bwd, lib.predict, lib.wgrad, lib.wgrad_bytes,
               lib.wgrad_tiled, lib.wgrad_threads):
        fn.restype = ctypes.c_int
    lib.predict_info.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.predict_info.restype = None
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


@pytest.mark.parametrize("kernel", ["fwd", "bwd", "wgrad_bytes"])
def test_every_geometry_the_tiled_kernels_took_still_fits(plans, kernel):
    """K1's and K2's recurrence kernels and K2's weight gradient take every
    capsule geometry the kernels before them took (log-uniform draws of
    each dim in 1..2^15, and edge cases), with shared memory inside the
    card's 227 KB."""
    fn = getattr(plans, kernel)
    rng = np.random.RandomState(7)
    draws = np.exp(rng.uniform(0, np.log(2 ** 15), size=(20000, 4)))
    cases = [tuple(int(x) for x in row) for row in draws.astype(int)]
    cases += [(10, 64, 32, 32), (1, 30000, 2, 2), (2, 6000, 2, 2),
              (3, 16, 500, 10), (1, 1, 14000, 1), (20000, 1, 1, 1),
              (1, 1, 1, 14000), *_RECIPE_GEOMETRIES]
    took = [g for g in cases if _tiled_kernels_fit(*g, kernel != "fwd")]
    assert len(took) > 2000
    refused = [g for g in took if not 0 < fn(*g) <= 232448]
    assert not refused, refused[:10]
    for g in cases:
        assert fn(*g) <= 232448


def test_prediction_and_weight_gradient_tile_w_only_where_it_must(plans):
    """The recipes' geometries take W[n] whole (one tile); any W[n] fits
    in tiles (the prediction's in entries 20 a tile)."""
    for in_n, in_d, out_n, out_d in _RECIPE_GEOMETRIES:
        assert plans.predict(in_d, out_n * out_d) == 1
        assert plans.wgrad(in_d, out_n, out_d) == 1
    assert plans.predict(64, 1024) == 4 and plans.wgrad(64, 1024, 1) == 4
    rng = np.random.RandomState(8)
    for in_d, out_no in np.exp(rng.uniform(0, np.log(_SMEM_FLOATS),
                                           size=(5000, 2))).astype(int):
        assert plans.predict(int(in_d), int(out_no)) >= 1
        assert plans.wgrad(int(in_d), int(out_no), 1) >= 1


@pytest.mark.parametrize("geometry", _RECIPE_LAYERS + _TP_SHARDS)
def test_every_recipe_layer_takes_the_tiled_weight_gradient(plans, geometry):
    """Every routing layer of the recipes, and every K2-tp shard of one,
    takes the weight gradient's tiled path (W[n] whole, dW in registers),
    within the card's 227 KB, with at least 16 warps resident an SM."""
    in_n, in_d, out_n, out_d = geometry
    assert plans.wgrad_tiled(in_d, out_n, out_d) == 1
    smem = plans.wgrad_bytes(in_n, in_d, out_n, out_d)
    assert 0 < smem <= 232448
    blocks = _SM_SMEM // (smem + _BLOCK_RESERVED)
    assert plans.wgrad_threads(in_d, out_n, out_d) // 32 * blocks >= 16


_PREDICT_INFO = ("tiled", "jq", "j_tile", "o_tiles", "o_quads", "groups",
                 "n_groups", "tile_rows", "row_tiles", "units", "blocks",
                 "smem", "threads")
# (rows, in_n, in_d, out_no, esize, path) of each geometry class the
# prediction takes: the recipes' layers at a train bucket's B*T' (SRF-WSJ
# 24 x 248, SRF-TIMIT 29 x 61), their K1-tp shards (out_n / 2 or / 3),
# a B = 1 streaming push (T' 4) and a serving step, the bf16 instance, and
# geometries of its general path (in_d past 20)
_PREDICT_CASES = (
    ("wsj_layer0", 24 * 248, 300, 20, 600, 4, "tiled"),
    ("wsj_layer1", 24 * 248, 150, 20, 600, 4, "tiled"),
    ("wsj_classes", 24 * 248, 150, 20, 640, 4, "tiled"),
    ("timit_layer0", 29 * 61, 180, 8, 240, 4, "tiled"),
    ("timit_layer1", 29 * 61, 90, 8, 240, 4, "tiled"),
    ("timit_classes", 29 * 61, 90, 8, 504, 4, "tiled"),
    ("wsj_tp_shard", 8 * 100, 150, 20, 300, 4, "tiled"),
    ("wsj_tp_shard_bf16", 8 * 100, 150, 20, 300, 2, "tiled"),
    ("wsj_classes_tp3", 8 * 100, 150, 20, 200, 4, "tiled"),
    ("timit_tp_shard", 29 * 61, 90, 8, 120, 4, "tiled"),
    ("timit_classes_tp3", 29 * 61, 90, 8, 168, 4, "tiled"),
    ("stream_b1_timit", 1 * 4, 180, 8, 240, 4, "tiled"),
    ("stream_b1_classes", 1 * 4, 90, 8, 504, 4, "tiled"),
    ("stream_b1_wsj", 1 * 4, 150, 20, 640, 4, "tiled"),
    ("serve_b16_wsj", 16 * 8, 150, 20, 600, 4, "tiled"),
    ("wsj_layer1_bf16", 24 * 248, 150, 20, 600, 2, "tiled"),
    ("general_in_d_64", 3 * 17, 10, 64, 1024, 4, "general"),
    ("general_in_d_21", 29 * 61, 90, 21, 240, 4, "general"),
)


@pytest.mark.parametrize("case", _PREDICT_CASES,
                         ids=[case[0] for case in _PREDICT_CASES])
def test_prediction_plan_per_geometry_class(plans, case):
    """The prediction's plan at each geometry class: its path (tiled where
    in_d takes one tile of 20 in entries), shared memory within the card's
    227 KB, out tiles that cover the row's pitch, groups of in-capsules
    that cover in_n, at most 512 threads a block, and a grid of the card's
    132 SMs wherever the call has that many units (the small calls: B = 1
    pushes, shards)."""
    _, rows, in_n, in_d, out_no, esize, path = case
    info = (ctypes.c_longlong * 13)()
    plans.predict_info(rows, in_n, in_d, out_no, esize, 132, info)
    p = dict(zip(_PREDICT_INFO, info))
    assert ("tiled" if p["tiled"] else "general") == path, p
    assert (p["j_tile"] == in_d) == (path == "tiled"), p
    assert 0 < p["smem"] <= 232448
    quads = routing.row_pitch(out_no, esize) // 4
    assert p["o_tiles"] * p["o_quads"] >= quads > (
        p["o_tiles"] - 1) * p["o_quads"], p
    assert p["threads"] <= 512, p
    assert p["n_groups"] * p["groups"] >= in_n > (
        p["n_groups"] - 1) * p["groups"], p
    assert p["row_tiles"] * p["tile_rows"] >= rows, p
    assert p["units"] == p["o_tiles"] * p["n_groups"] * p["row_tiles"], p
    assert p["blocks"] == min(p["units"], 132) == 132, p


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
