"""One train step and the eval-mode gradients of the baseline zoo's CNN classes
against JAX, on the CPU: the Res2Net-50 fundus classifiers.  The checks, the
sizes and the bars are ``test_torch_baselines.py``'s (see its docstring);
the classes are split over files so that they run side by side.

The train-step check is shown to fail on Res2Net2D once the port carries a
planted fault (``FAULTS``).
"""

import pytest

from test_torch_baselines import (  # noqa: F401 (two_torch_threads: the module's fixture)
    FAULTS,
    check_eval_gradients,
    check_planted_fault,
    check_train_step,
    two_torch_threads,
)

NAMES = ['Res2Net2D', 'Medical_base_dropout_2DNet']


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax(name):
    check_train_step(name)


@pytest.mark.parametrize("name", NAMES)
def test_eval_gradients_match_jax(name):
    check_eval_gradients(name)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_train_step_check_catches_a_planted_fault(fault, monkeypatch):
    check_planted_fault('Res2Net2D', fault, monkeypatch)
