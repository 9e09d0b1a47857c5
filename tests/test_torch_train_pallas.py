"""The port's train step against srf_tpu's with the JAX model's SDR on the
Pallas kernels K1 and K2 (interpret mode on the CPU), the path the JAX
package takes on a TPU with ``--tpu-routing-kernel=pallas``. Same check and
tolerances as ``test_torch_train.py``; its own file so that the two slow
JAX compiles run on different test workers."""

from test_torch_train import check_train_step_matches_jax


def test_train_step_matches_jax_pallas_routing(monkeypatch):
    check_train_step_matches_jax("pallas", monkeypatch)
