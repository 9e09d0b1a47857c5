"""K2's weight-gradient kernels (``srf_tpu_torch/csrc/sdr_bwd.cu``) on the
CPU: the source built as host C++ (``tests/_sdr_tp_host.h``: a block's
threads as std::threads, its barriers std::barriers, the asynchronous and
bulk copies as copies), the kernel and its reduction launched as the
card's launch code launches them, against the plain weight gradient from
du_hat's factors (``ops/routing.py`` ``sdr_weight_grads``, in float64):
du, dW and db within 1e-5 of their largest entry.

- The tiled path (W[n] whole, dW in registers) at the recipes' capsule
  shapes on a few in-capsules and rows: SRF-WSJ's 30 and 32 capsules of
  dim 20 over in_d 20 (3 and 4 out quads a thread), SRF-TIMIT's 63 and 30
  capsules of dim 8 over in_d 8 (several rebuild and dW row groups, their
  partials added at an item's end), and a K2-tp shard.
- The general path: an out_no that is not a multiple of 4, and a W[n]
  taken in tiles.
- The bf16 instance (du_hat = bf16(bf16(c) ds + da bf16(v_{t-1})), u and
  W bf16) against the same rounding done here.
- Two calls are bit-equal.

The kernels' speed and their other launches (prediction, reverse time)
are held on the card (``chip_smoke.py`` phase 4)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from srf_tpu_torch.ops import cuda_build, routing

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
_LAUNCHER = r'''
#include "sdr_bwd.cu"

namespace {
// the plan, the weight-gradient kernel and the reduction, as launch_wgrad
// launches them; info: tiled, rows, mt, row_split, build_rows, ksplit
template <bool BF>
void run(const sdr::uhat_t<BF>* u, const sdr::uhat_t<BF>* w, const float* vs,
         const float* c, const float* da, const float* ds, float* part,
         float* du, float* dw, float* db, int batch, int seq_len, int in_n,
         int in_d, int out_n, int out_d, int slots, int* info) {
  Wgrad p;
  sdr::plan_wgrad(batch * seq_len, in_n, in_d, out_n, out_d, slots, &p);
  const size_t smem = sdr::wgrad_smem_floats(p, out_n, out_d) * 4;
  const int got[6] = {p.tiled, p.rows, p.mt, p.row_split, p.build_rows,
                      p.ksplit};
  std::memcpy(info, got, sizeof(got));
  const auto kernel = wgrad_kernel<BF>(p);
  const int items = in_n * p.chunks;
  sdr_tp_host::launch(items < slots ? items : slots, wgrad_threads(p), smem,
                      [&]() {
                        kernel(u, w, vs, c, da, ds, du, part,
                               batch * seq_len, seq_len, in_n, in_d, out_n,
                               out_d, p);
                      });
  const int dw_size = in_n * out_n * out_d * in_d;
  sdr_tp_host::launch(2, 64, 0, [&]() {
    sdr_bwd_reduce_kernel(part, dw, db, p.chunks, dw_size,
                          in_n * out_n * out_d);
  });
}
}  // namespace

extern "C" long long part_floats(int rows, int in_n, int in_d, int out_n,
                                 int out_d, int slots) {
  Wgrad p;
  sdr::plan_wgrad(rows, in_n, in_d, out_n, out_d, slots, &p);
  return (long long)p.chunks * in_n * out_n * out_d * (in_d + 1);
}

extern "C" void wgrad(int bf, const void* u, const void* w, const float* vs,
                      const float* c, const float* da, const float* ds,
                      float* part, float* du, float* dw, float* db,
                      int batch, int seq_len, int in_n, int in_d, int out_n,
                      int out_d, int slots, int* info) {
  if (bf) {
    using B = const __nv_bfloat16*;
    run<true>(static_cast<B>(u), static_cast<B>(w), vs, c, da, ds, part, du,
              dw, db, batch, seq_len, in_n, in_d, out_n, out_d, slots, info);
  } else {
    using F = const float*;
    run<false>(static_cast<F>(u), static_cast<F>(w), vs, c, da, ds, part, du,
               dw, db, batch, seq_len, in_n, in_d, out_n, out_d, slots,
               info);
  }
}
'''


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """sdr_bwd.cu's kernels built with g++ as host C++, with a launcher."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to build csrc/sdr_bwd.cu for the CPU")
    out = tmp_path_factory.mktemp("sdr_wgrad")
    (out / "launcher.cpp").write_text(_LAUNCHER)
    path = str(out / "libsdr_wgrad_host.so")
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-include", os.path.join(HERE, "_sdr_tp_host.h"), "-I",
                    cuda_build.CSRC, str(out / "launcher.cpp"), "-o", path],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(path)
    lib.part_floats.argtypes = [ctypes.c_int] * 6
    lib.part_floats.restype = ctypes.c_longlong
    lib.wgrad.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                          + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.wgrad.restype = None
    return lib


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _factors(seed, batch, steps, in_n, in_d, out_n, out_d):
    rng = np.random.RandomState(seed)
    shapes = ((batch, steps, in_n, in_d), (in_n, out_n, out_d, in_d),
              (batch, steps, out_n, out_d), (batch, steps, in_n, out_n),
              (batch, steps, in_n, out_n), (batch, steps, out_n, out_d))
    return [torch.tensor(rng.randn(*s), dtype=torch.float32) for s in shapes]


def _launch(lib, bf, u, w, vs, c, da, ds, slots):
    """(du, dW, db, plan info) of the host kernels."""
    batch, steps, in_n, in_d = u.shape
    out_n, out_d = w.shape[1], w.shape[2]
    part = torch.empty(lib.part_floats(batch * steps, in_n, in_d, out_n,
                                       out_d, slots))
    du = torch.full(u.shape, float("nan"))
    dw = torch.full(w.shape, float("nan"))
    db = torch.full(w.shape[:3], float("nan"))
    info = (ctypes.c_int * 6)()
    ins = [x.to(torch.bfloat16) if bf else x for x in (u, w)]
    lib.wgrad(int(bf), *(x.data_ptr() for x in (*ins, vs, c, da, ds, part,
                                                du, dw, db)),
              batch, steps, in_n, in_d, out_n, out_d, slots, info)
    return du, dw, db, list(info)


def _want(bf, u, w, vs, c, da, ds):
    """The plain weight gradient in float64; for bf16, du_hat rounded where
    the kernel rounds it (its fused multiply-add taken in float64)."""
    if not bf:
        return routing.sdr_weight_grads(*(x.double() for x in (u, w, vs, c,
                                                                da, ds)))
    v_prev = torch.cat([torch.zeros_like(vs[:, :1]), vs[:, :-1]], dim=1)
    c_b, vp_b = _bf16(c), _bf16(v_prev)
    second = (da[..., None] * vp_b[:, :, None]).double()
    du_hat = _bf16((c_b.double()[..., None] * ds.double()[:, :, None]
                    + second).float()).double()
    u_b, w_b = _bf16(u).double(), _bf16(w).double()
    return (torch.einsum("btnoi,noij->btnj", du_hat, w_b),
            torch.einsum("btnoi,btnj->noij", du_hat, u_b),
            du_hat.sum(dim=(0, 1)))


# (name, (B, T, in_n, in_d, out_n, out_d), slots, bf16, path: 1 tiled,
# 0 general)
CASES = [
    ("wsj_layers", (2, 13, 3, 20, 30, 20), 2, False, 1),
    ("wsj_classes", (2, 13, 3, 20, 32, 20), 3, False, 1),
    ("timit_classes", (2, 11, 3, 8, 63, 8), 2, False, 1),
    ("timit_row_groups", (3, 9, 3, 8, 30, 8), 2, False, 1),
    ("tp_shard", (1, 30, 2, 8, 15, 8), 1, False, 1),
    ("out_no_odd", (2, 7, 2, 5, 5, 3), 2, False, 0),
    ("w_in_tiles", (2, 5, 2, 64, 32, 32), 1, False, 0),
    ("wsj_layers_bf16", (2, 13, 3, 20, 30, 20), 2, True, 1),
    ("timit_classes_bf16", (2, 11, 3, 8, 63, 8), 2, True, 1),
]


@pytest.mark.parametrize("name,shape,slots,bf,path", CASES,
                         ids=[case[0] for case in CASES])
def test_weight_gradient_matches_the_plain_one(host_lib, name, shape, slots,
                                               bf, path):
    factors = _factors(len(name), *shape)
    *got, info = _launch(host_lib, bf, *factors, slots)
    assert info[0] == path, info
    for part, g, w in zip(("du", "dW", "db"), got,
                          _want(bf, *factors)):
        err = (g.double() - w).abs().max().item() / w.abs().max().item()
        assert err < 1e-5, (part, err, info)


def test_two_calls_are_bit_equal(host_lib):
    factors = _factors(3, 2, 13, 3, 20, 30, 20)
    first = _launch(host_lib, False, *factors, 2)
    again = _launch(host_lib, False, *factors, 2)
    assert all(torch.equal(x, y) for x, y in zip(first[:3], again[:3]))
