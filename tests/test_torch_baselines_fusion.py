"""One train step and the eval-mode gradients of the baseline zoo's CNN classes
against JAX, on the CPU: late and cross-attention fusion.  The checks, the
sizes and the bars are ``test_torch_baselines.py``'s (see its docstring);
the classes are split over files so that they run side by side.

The train-step check is shown to fail on Multi_ResNet once the port carries
a planted fault (``FAULTS``).
"""

import pytest

from test_torch_baselines import (  # noqa: F401 (two_torch_threads: the module's fixture)
    FAULTS,
    check_eval_gradients,
    check_planted_fault,
    check_train_step,
    two_torch_threads,
)

NAMES = ['Multi_ResNet', 'Multi_ResNet_cross']


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax(name):
    check_train_step(name)


@pytest.mark.parametrize("name", NAMES)
def test_eval_gradients_match_jax(name):
    check_eval_gradients(name)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_train_step_check_catches_a_planted_fault(fault, monkeypatch):
    check_planted_fault('Multi_ResNet', fault, monkeypatch)
