"""The port's training loss and gradients against the reference's
``jax.value_and_grad``: the second half of the ten architectures' smoke
configs (inputs and tolerances in ``test_torch_train_grads.py``).
"""
import pytest

from test_torch_train_grads import ARCHS, HALF, check_loss_and_gradients


@pytest.mark.parametrize("name", ARCHS[HALF:])
def test_loss_and_gradients_match_reference(name):
    check_loss_and_gradients(name)
