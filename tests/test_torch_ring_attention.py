"""Ring (sequence-parallel) attention in the port (``ops/ring_attention.py``)
against srf_tpu's ``ring_attention`` on conftest's virtual devices.

n = 2 and 4 ranks are real OS processes over gloo
(``_torch_dist_worker.py``): each holds the whole q, k, v and mask, takes
its T/n shard, rotates k, v and the mask around the ring with the
differentiable ``ppermute`` and gathers the output. Every rank's output
equals JAX's ring on an n-device mesh and blockwise attention within atol
2e-5, and the gradients of a fixed cotangent's dot product with it (whole
on every rank) equal JAX's within 3e-5 (``tests/test_ring_attention.py``'s
limits); with the distance penalty and a ragged padding mask.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.ops.blockwise_attention import PenaltyParams as JaxPenalty
from srf_tpu.ops.blockwise_attention import blockwise_attention
from srf_tpu.ops.ring_attention import ring_attention as jax_ring
from srf_tpu_torch.models.layers import MultiHeadAttention
from srf_tpu_torch.ops import ring_attention

from _torch_dist_worker import run_scenario

torch.set_num_threads(1)

PENALTY = (2, 4, 0.3, 5)  # zero width, stripe width, scale, stripes


def _inputs(seq=64):
    rng = np.random.RandomState(0)
    q, k, v, cot = (rng.randn(2, 2, seq, 4).astype(np.float32)
                    for _ in range(4))
    mask = np.zeros((2, 1, 1, seq), np.float32)
    mask[1, ..., 41:] = 1.0
    return {"q": q, "k": k, "v": v, "cot": cot, "mask": mask}


@pytest.mark.parametrize("ranks", [2, 4])
def test_ring_matches_jax_ring_and_blockwise(tmp_path, ranks):
    arrays = _inputs()
    np.savez(tmp_path / "inputs.npz", spec=json.dumps({"penalty": PENALTY}),
             **arrays)
    results = run_scenario("ring", tmp_path, ranks=ranks)
    mesh = jax.make_mesh((ranks,), ("seq",), devices=jax.devices()[:ranks])
    pen = JaxPenalty(*PENALTY)
    q, k, v, mask, cot = (jnp.asarray(arrays[n])
                          for n in ("q", "k", "v", "mask", "cot"))

    def loss(q, k, v):
        return jnp.sum(jax_ring(q, k, v, mesh, mask=mask, penalty=pen) * cot)

    want = np.asarray(jax_ring(q, k, v, mesh, mask=mask, penalty=pen))
    block = np.asarray(blockwise_attention(q, k, v, mask=mask, penalty=pen,
                                           block_k=16))
    with jax.set_mesh(mesh):
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    for got in results:
        np.testing.assert_allclose(got["out"], want, rtol=0, atol=2e-5)
        np.testing.assert_allclose(got["out"], block, rtol=0, atol=2e-5)
        for name, grad in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(got[name], np.asarray(grad), rtol=0,
                                       atol=3e-5, err_msg=name)


def test_indivisible_time_axis_raises(monkeypatch):
    monkeypatch.setattr(ring_attention, "world_size", lambda group: 3)
    q = torch.zeros(1, 1, 64, 4)
    with pytest.raises(ValueError, match="T=64 not divisible by 3"):
        ring_attention.ring_attention(q, q, q, group=object())


def test_ring_refuses_attention_dropout_in_training():
    mha = MultiHeadAttention(8, 2, attention_dropout=0.1, group=object())
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="does not support attention"):
        mha(x, x, x, None, None, impl="ring")
