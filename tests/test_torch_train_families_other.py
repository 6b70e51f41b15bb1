"""The MoE, SSM, hybrid and enc-dec archs of the registry at their smoke
size: the port's training loss and every gradient against the reference's
``jax.value_and_grad`` of its ``model.loss_fn`` with the chunked kernels,
as ``tests/test_torch_train_families.py`` checks the dense and VLM ones
(its ``check_loss_and_grads``, with its tolerances).
"""
import pytest

from test_torch_train_families import OTHER_ARCHS, check_loss_and_grads


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)
