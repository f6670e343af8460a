"""xLSTM's, Hymba's and Whisper's ``loss_fn`` and gradients, the port
against the JAX package at ``smoke_config`` in fp32, by
``test_torch_train_families.check_arch`` (its bounds: the loss within 1e-5
relative, every gradient leaf within 1e-4 of its largest value, every
gradient finite). The recurrences start from -1e30 stabiliser states; their
gradients must stay finite.
"""

import pytest

from repro_torch.models import registry
from test_torch_train_families import TRANSFORMER_ARCHS, check_arch

RECURRENT_ARCHS = tuple(a for a in registry.ALL_ARCHS
                        if a not in TRANSFORMER_ARCHS)


def test_the_ten_archs_are_covered():
    assert RECURRENT_ARCHS == ("xlstm-125m", "hymba-1.5b", "whisper-large-v3")
    assert len(TRANSFORMER_ARCHS) + len(RECURRENT_ARCHS) == 10


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_loss_and_grads_match(arch):
    check_arch(arch)
