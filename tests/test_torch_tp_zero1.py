"""Tensor parallelism over a data axis above 1 on the CPU: a world of 4 gloo
processes as the ``(2, 2)`` mesh (``torch_parallel_worker.run_world4``), on
``torch_parallel_worker.tiny_tp``.

- The step at global batch 4 with the step's generator against one
  process's: the results and every gradient at full shape at the step's
  bars (``tests/test_torch_train.py``'s), the replicated parameters'
  gradients bit-equal over each model group.
- ZeRO-1 on each model rank's data group through a checkpoint: ``fit`` with
  ZeRO-1 for 1 epoch, then resumed from its checkpoint (consolidated over
  the data group, gathered over the model group) for a second, ends with a
  checkpoint equal, tensor by tensor, to the uninterrupted replicated
  run's, and that checkpoint restores in one process to the sharded state.

The ranks import no JAX; this module neither.
"""

import multiprocessing
import socket
import time

import numpy as np
import pytest

import torch_parallel_worker as worker
from test_torch_train import ATOL, RTOL

WORLD = 4
TIMEOUT = 240


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Start the 4 ranks and collect each rank's results, in rank order."""
    workdir = tmp_path_factory.mktemp("tp22")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    outbox = ctx.Queue()
    procs = [ctx.Process(target=worker.run_world4, args=(r, WORLD, port, outbox, str(workdir)), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    ranks = [None] * WORLD
    try:
        deadline = time.time() + TIMEOUT
        for _ in range(WORLD):
            rank, results = outbox.get(timeout=max(deadline - time.time(), 1))
            ranks[rank] = results
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    return ranks


def _results(world4, name):
    """Every rank's results of case ``name``, failing with a rank's traceback."""
    out = []
    for rank, results in enumerate(world4):
        got = results[name]
        if isinstance(got, dict) and "error" in got:
            pytest.fail(f"rank {rank}, case {name}:\n{got['error']}")
        out.append(got)
    return out


def test_tp_step_on_a_2x2_mesh_matches_one_process(world4):
    ranks = _results(world4, "tp22_step")
    one = ranks[0]["one"]
    for got in ranks:
        assert got["spread"] == 0.0
        for key, value in one["out"].items():
            np.testing.assert_allclose(got["ranks"]["out"][key], value, atol=ATOL, rtol=RTOL, err_msg=key)
    grads = ranks[0]["ranks"]["grads"]
    assert sorted(grads) == sorted(one["grads"])
    for name, want in one["grads"].items():
        np.testing.assert_allclose(grads[name], want, atol=ATOL, rtol=RTOL, err_msg=name)


def test_tp_zero1_fit_on_a_2x2_mesh_resumes_to_the_replicated_checkpoint(world4):
    ranks = _results(world4, "tp22_fit_zero1")
    for r in ranks:
        assert r["is_zero1"] and r["steps"] == 4
        assert r["train"] == ranks[0]["train"] and len(r["train"]) == 1
    got = ranks[0]
    assert got["keys"][0] == got["keys"][1] and got["moment_keys"][0] == got["moment_keys"][1]
    assert got["param_diff"] == 0.0 and got["moment_diff"] == 0.0 and got["moment_steps"] == [4.0]
    assert got["restored_diff"] == 0.0 and got["restored_step"] == 4
