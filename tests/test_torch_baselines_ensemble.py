"""One train step and the eval-mode gradients of the baseline zoo's CNN classes
against JAX, on the CPU: the structural ensemble members (Res2Net 14w8s with
ResNet-10, and 26w4s with ResNet-18).  The checks, the sizes and the bars
are ``test_torch_baselines.py``'s (see its docstring); the classes are split
over files so that they run side by side.
"""

import pytest

from test_torch_baselines import (  # noqa: F401 (two_torch_threads: the module's fixture)
    check_eval_gradients,
    check_train_step,
    two_torch_threads,
)

NAMES = ['Multi_ensemble_ResNet', 'Multi_ensemble_3D_ResNet']


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax(name):
    check_train_step(name)


@pytest.mark.parametrize("name", NAMES)
def test_eval_gradients_match_jax(name):
    check_eval_gradients(name)
