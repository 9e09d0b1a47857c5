"""The prediction kernel (``srf_tpu_torch/csrc/sdr_stream.cuh``
``sdr_predict_kernel``) on the CPU: the source built as host C++
(``tests/_sdr_tp_host.h``: a block's threads as std::threads, its barriers
std::barriers), planned and launched as ``launch_predict`` plans and
launches it for a card of ``slots`` resident blocks, against the chain it
must compute, an fmaf over the in entries in order from the bias (bf16:
from 0, then bf16(bf16(a) + bias)), entry by entry, bit for bit (-0
included), and against the plain ``predict_capsules`` in float64.

Cases: SRF-WSJ's and SRF-TIMIT's capsule shapes, K1-tp shards, a B = 1
streaming call (the plan splits the out quads to fill the slots), an in_d
that is not a multiple of 4 with padding entries, out quads past one
block's threads, the general path (in_d in tiles through u_hat), and the
bf16 instance. The kernel's speed is held on the card (``chip_smoke.py``
phase 4)."""

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
#include "sdr_stream.cuh"

namespace {
// the plan and the kernel, as launch_predict plans and launches them; info:
// tiled, jq, j_tile, o_tiles, o_quads, groups, tile_rows, units, blocks
template <bool BF>
void run(const sdr::uhat_t<BF>* u, const sdr::uhat_t<BF>* w,
         const sdr::uhat_t<BF>* b, sdr::uhat_t<BF>* uhat, int rows,
         int in_n, int in_d, int out_no, int slots, int* info) {
  sdr::PredictPlan p;
  sdr::plan_predict(rows, in_n, in_d, out_no, BF ? 2 : 4, slots, &p);
  const int got[9] = {sdr::predict_tiled(in_d), p.jq, p.j_tile, p.o_tiles,
                      p.o_quads, p.groups, p.tile_rows, (int)p.units,
                      p.blocks};
  std::memcpy(info, got, sizeof(got));
  const auto kernel = sdr::predict_kernel<BF>(p.jq);
  const int pitch = sdr::row_pitch(out_no, BF ? 2 : 4);
  sdr_tp_host::launch(p.blocks, sdr::predict_threads(p),
                      sdr::predict_smem_bytes(p), [&]() {
                        kernel(u, w, b, uhat, rows, in_n, in_d, out_no, pitch,
                               p);
                      });
}

// the chain each entry must be, one entry at a time
template <bool BF>
void chain(const sdr::uhat_t<BF>* u, const sdr::uhat_t<BF>* w,
           const sdr::uhat_t<BF>* b, sdr::uhat_t<BF>* uhat, int rows,
           int in_n, int in_d, int out_no) {
  using E = sdr::uhat_t<BF>;
  const int pitch = sdr::row_pitch(out_no, BF ? 2 : 4);
  for (long long rn = 0; rn < (long long)rows * in_n; ++rn) {
    const int n = (int)(rn % in_n);
    for (int o = 0; o < pitch; ++o) {
      float a = 0.f;
      if (o < out_no) {
        const float bias = sdr::to_f32(b[(size_t)n * out_no + o]);
        a = BF ? 0.f : bias;
        for (int j = 0; j < in_d; ++j) {
          a = std::fmaf(sdr::to_f32(w[((size_t)n * out_no + o) * in_d + j]),
                        sdr::to_f32(u[rn * in_d + j]), a);
        }
        if (BF) a = sdr::round_bf16(a) + bias;
      }
      uhat[rn * pitch + o] = sdr::from_f32<E>(a);
    }
  }
}
}  // namespace

extern "C" void predict(int bf, const void* u, const void* w, const void* b,
                        void* uhat, int rows, int in_n, int in_d, int out_no,
                        int slots, int* info) {
  if (bf) {
    using B = const __nv_bfloat16*;
    run<true>(static_cast<B>(u), static_cast<B>(w), static_cast<B>(b),
              static_cast<__nv_bfloat16*>(uhat), rows, in_n, in_d, out_no,
              slots, info);
  } else {
    using F = const float*;
    run<false>(static_cast<F>(u), static_cast<F>(w), static_cast<F>(b),
               static_cast<float*>(uhat), rows, in_n, in_d, out_no, slots,
               info);
  }
}

extern "C" void reference(int bf, const void* u, const void* w,
                          const void* b, void* uhat, int rows, int in_n,
                          int in_d, int out_no) {
  if (bf) {
    using B = const __nv_bfloat16*;
    chain<true>(static_cast<B>(u), static_cast<B>(w), static_cast<B>(b),
                static_cast<__nv_bfloat16*>(uhat), rows, in_n, in_d, out_no);
  } else {
    using F = const float*;
    chain<false>(static_cast<F>(u), static_cast<F>(w), static_cast<F>(b),
                 static_cast<float*>(uhat), rows, in_n, in_d, out_no);
  }
}
'''


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """sdr_stream.cuh's prediction kernel built with g++ as host C++, with
    a launcher and the chain it must compute."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to build csrc/sdr_stream.cuh for the CPU")
    out = tmp_path_factory.mktemp("sdr_predict")
    (out / "launcher.cpp").write_text(_LAUNCHER)
    path = str(out / "libsdr_predict_host.so")
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-include", os.path.join(HERE, "_sdr_tp_host.h"), "-I",
                    cuda_build.CSRC, str(out / "launcher.cpp"), "-o", path],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(path)
    lib.predict.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.predict.restype = None
    lib.reference.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                              + [ctypes.c_int] * 4)
    lib.reference.restype = None
    return lib


def _inputs(seed, rows, in_n, in_d, out_no, bf):
    rng = np.random.RandomState(seed)
    dtype = torch.bfloat16 if bf else torch.float32
    return [torch.tensor(rng.randn(*shape), dtype=torch.float32).to(dtype)
            for shape in ((rows, in_n, in_d), (in_n, out_no, in_d),
                          (in_n, out_no))]


def _run(lib, bf, u, w, b, slots):
    """(u_hat of the kernel, of the chain, the plan's info)."""
    rows, in_n, in_d = u.shape
    out_no = w.shape[1]
    pitch = routing.row_pitch(out_no, u.dtype.itemsize)
    got = torch.full((rows, in_n, pitch), float("nan"), dtype=u.dtype)
    want = torch.empty_like(got)
    info = (ctypes.c_int * 9)()
    lib.predict(int(bf), u.data_ptr(), w.data_ptr(), b.data_ptr(),
                got.data_ptr(), rows, in_n, in_d, out_no, slots, info)
    lib.reference(int(bf), u.data_ptr(), w.data_ptr(), b.data_ptr(),
                  want.data_ptr(), rows, in_n, in_d, out_no)
    return got, want, list(info)


def _bits(x):
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


# (name, (rows, in_n, in_d, out_no), slots, bf16, path: 1 tiled, 0 general,
# out tiles)
CASES = [
    ("wsj_layers", (26, 3, 20, 600), 4, False, 1, 1),
    ("wsj_classes", (26, 3, 20, 640), 4, False, 1, 1),
    ("timit_classes", (22, 3, 8, 504), 3, False, 1, 1),
    ("timit_layers", (27, 4, 8, 240), 5, False, 1, 1),
    ("wsj_tp_shard", (19, 2, 20, 300), 3, False, 1, 1),
    ("timit_tp_shard", (31, 3, 8, 120), 2, False, 1, 1),
    ("stream_b1", (1, 5, 8, 504), 8, False, 1, 2),
    ("in_d_odd_padding", (23, 3, 6, 15), 3, False, 1, 1),
    ("out_quads_past_a_block", (5, 2, 3, 2100), 2, False, 1, 2),
    ("general_in_tiles", (17, 2, 45, 36), 3, False, 0, 1),
    ("wsj_layers_bf16", (26, 3, 20, 600), 4, True, 1, 1),
    ("timit_classes_bf16", (22, 3, 8, 504), 3, True, 1, 1),
    ("wsj_tp_shard_bf16", (19, 2, 20, 300), 3, True, 1, 1),
]


@pytest.mark.parametrize("name,shape,slots,bf,path,o_tiles", CASES,
                         ids=[case[0] for case in CASES])
def test_prediction_is_the_chain_bit_for_bit(host_lib, name, shape, slots,
                                             bf, path, o_tiles):
    u, w, b = _inputs(len(name), *shape, bf)
    got, want, info = _run(host_lib, bf, u, w, b, slots)
    assert (info[0], info[3]) == (path, o_tiles), info
    assert info[8] == min(info[7], slots), info
    assert torch.equal(_bits(got), _bits(want)), (name, info)
    rows, in_n, in_d, out_no = shape
    plain = routing.predict_capsules(
        u.double()[None], w.double().reshape(in_n, out_no, 1, in_d),
        b.double().reshape(in_n, out_no, 1)).reshape(rows, in_n, out_no)
    tol = 2e-2 if bf else 1e-5
    assert (got[..., :out_no].double() - plain).abs().max().item() <= tol * (
        plain.abs().max().item()), (name, info)
    assert not got[..., out_no:].float().any()


def test_a_negative_zero_entry_stays_negative_zero(host_lib):
    """Where the bias is -0 and every product -0, the chain is -0: the
    padded in entries (W -0, u +0) leave it so."""
    u, w, b = _inputs(5, 9, 2, 6, 12, False)
    u = u.abs() + 0.5
    w[1, 7] = -0.0
    b[1, 7] = -0.0
    got, want, _ = _run(host_lib, False, u, w, b, 2)
    assert torch.equal(_bits(got), _bits(want))
    assert (_bits(got[:, 1, 7]) == _bits(torch.tensor(-0.0))).all()


def test_padding_entries_stay_zero_past_an_infinite_u(host_lib):
    """An infinite u entry makes its row's entries infinite or NaN, as the
    chain does, and leaves the row's padding entries 0."""
    u, w, b = _inputs(6, 7, 2, 6, 15, False)
    u[3, 1, 2] = float("inf")
    got, want, _ = _run(host_lib, False, u, w, b, 2)
    assert torch.equal(_bits(got), _bits(want))
    assert not torch.isfinite(got[3, 1, :15]).all()
    assert not got[..., 15:].any()


def test_two_calls_are_bit_equal(host_lib):
    u, w, b = _inputs(3, 26, 3, 20, 600, False)
    first, _, _ = _run(host_lib, False, u, w, b, 4)
    again, _, _ = _run(host_lib, False, u, w, b, 4)
    assert torch.equal(_bits(first), _bits(again))
