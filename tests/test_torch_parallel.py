"""The port's data parallelism (``edrl_tpu_torch.parallel``) on the CPU: a world
of 2 gloo processes against one process and against the JAX package's
2-device mesh (a submesh of ``tests/conftest.py``'s 8 CPU devices, as in
``tests/test_parallel.py::TestShardedStepSmoke``).

Two worlds of two ranks (``torch_parallel_worker.py``), one for the data
mesh and one for the tensor-parallel mesh, are started once for the module
and run every case side by side; JAX's references are computed here
meanwhile, and its recorded draws are sent to the ranks for the cases that
need them.  Two ``torchrun`` chains of ``cli.train`` and ``cli.test`` with 2
processes run beside them (MedFusion on the data mesh; Trans_cross over a
model axis of 2).

Cases and bars:

- MK-MMD and Barlow on the gathered rows (``TestGlobalBatchLosses``'s
  port): values at rel 1e-4 (that test's bar) against the port's
  global-batch functions and JAX's sharded ``mk_mmd`` / ``barlow_block_loss``,
  and the gradients of each rank's rows, divided by the world as the
  average over the ranks divides them, at 1e-5.
- Both BatchNorms (DILR's, ``conv.BatchNorm``) and DILR itself on each
  rank's rows against the global batch: outputs, running statistics and
  gradients at 1e-5.
- The MedFusion step at global batch 4 on 2 ranks with ready-made views and
  JAX's recorded draws sliced to each rank's rows, against JAX's step
  jitted over the 2-device mesh: ``tests/test_torch_train.py``'s bars (loss,
  MMD, probabilities, every gradient atol 2e-4 / rtol 1e-3; running
  statistics 1e-5).
- One Multi_ResNet step at global batch 8 under the CNN rule of
  ``tests/test_torch_baselines.py``: the 2-rank f32 step held against the
  one-process f64 step within ``WITNESS`` times the one-process f32 spread
  (the batch in its order and reversed) or the bars.  JAX's Multi_ResNet
  step is held there against the same f64 step (its 2-device mesh step
  takes 36 s to compile here).
- ZeRO-1 at world 2 equal to the replicated step (``TestZero1``'s claim),
  each rank holding about half the moment bytes; its checkpoint restores in
  one process to the replicated moments.
- ``run_eval`` over 5 samples (batches of 4 and 1, the last padded to 2):
  targets, probabilities and every metric but the loss equal world 1's;
  the loss, which averages over the padded row as JAX's does, and the rest
  equal JAX's mesh ``run_eval``, at 1e-5.
- ``fit`` for 2 epochs at world 2: one CSV, one checkpoint tree, restorable
  in one process; a run resumed after epoch 1 ends bit-equal to it.
- ``Predictor(mesh=...)``, batch by batch and in chunks, equal to world 1
  (1e-6) and to JAX's mesh Predictor (1e-4, ``test_torch_predictor.py``'s
  bar); an indivisible serving batch raises ``ValueError``.
- The robustness sweep at world 2 equal to world 1 (every metric but the
  loss, as for ``run_eval``).
- ``fit`` with ZeRO-1 at world 2, stopped after epoch 1 and resumed from
  the consolidated checkpoint, bit-equal to the uninterrupted replicated
  run.
- ``cli.train`` under ``python -m torch.distributed.run --nproc_per_node 2``,
  then ``cli.test`` on its best with MC-dropout and the sweep, launched
  alike.
- The fused flags under the data mesh: one step each of B4's, B5's and
  B6's configs (widths they take) at world 2 against world 1, at the step's
  bars.

Tensor parallelism, the same two ranks as a ``(1, 2)`` mesh, on
``torch_parallel_worker.tiny_tp`` (Swin's stage 0 and ViT of 1 head on the
gathered route, Swin's stage 1 and DILR head-local, B1 and B2 on):

- the step at global batch 4 with JAX's recorded draws against JAX's step
  jitted over ``make_mesh(num_data=1, num_model=2)`` with
  ``infer_param_shardings``, at the step's bars, every gradient gathered to
  full shape; the replicated parameters' gradients and values bit-equal on
  the two ranks;
- ``run_eval`` and the sweep against one process (1e-6);
- ``Predictor(mesh=...)``: f32 against JAX's mesh ``Predictor`` (5e-5,
  ``tests/test_quantization.py``'s bar) and one process (1e-6); int8
  (dynamic scales) equal to one process's bit for bit, and against JAX's
  mesh int8 ``Predictor`` within 5e-5 or ``SPREAD_FACTOR`` times JAX's own
  distance between its mesh and one-device int8 ``Predictor``s;
- ``fit``: a resume ends bit-equal, its checkpoint (full shapes) restores
  in one process; a clipped step's gradients equal one process's; ``remat``
  and ``remat_attention`` re-run the collectives in the backward and give
  the step's gradients; B5, B6 and an export refuse by name.

The baseline zoo over the ``(1, 2)`` mesh:

- each transformer family (2D_transformer, 3D_transformer, Trans_cross,
  MLC_trans) at ``tiny_tp``'s widths: one step against JAX's step over
  ``make_mesh(num_data=1, num_model=2)`` at the step's bars, every gradient
  at full shape, the replicated gradients bit-equal on the two ranks;
- Multi_ResNet (all replicated) and Multi_ResNet_cross (its attentions
  head-local) at global batch 4 under the CNN rule against one process;
- IMDR sharded bit-equal to MedFusion; a Trans_cross ``fit`` resumed
  bit-equal, its checkpoint restored in one process; the Trans_cross
  ``Predictor``, batch by batch and in chunks of 2 (the staged route),
  against JAX's mesh ``Predictor`` at 1e-4; MC-dropout of
  Multi_dropout_ResNet and MLC_trans's sweep equal to one process;
  ``cli.train --num_model_shards 2 --model_name Trans_cross`` and
  ``cli.test --mc_samples 2 --sweep`` on its best.

``scan_batches``: ``fit`` bit-equal to the per-batch ``fit`` at world 2 on
the data axis (K = 2 and K = 64, longer than the epoch), under ZeRO-1 at
world 2, and at ``(1, 2)``.
"""

import dataclasses
import functools
import multiprocessing
import os
import shlex
import socket
import subprocess
import sys
import time

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_worker as worker
from edrl_tpu.config import tiny_test_config as jax_tiny_config
from edrl_tpu.data import BatchLoader as JaxBatchLoader
from edrl_tpu.data import SyntheticGammaDataset as JaxSyntheticGammaDataset
from edrl_tpu.ops import barlow_block_loss as jbarlow
from edrl_tpu.ops import mk_mmd as jmk_mmd
from edrl_tpu.parallel import batch_sharding, make_mesh, shard_batch
from edrl_tpu.parallel.mesh import train_state_shardings
from edrl_tpu.serve import predictor as jpredictor
from edrl_tpu.train import trainer as jtrainer
from edrl_tpu_torch.convert import flax_key_map
from edrl_tpu_torch.ops.correlation import barlow_block_loss
from edrl_tpu_torch.ops.mmd import mk_mmd
from edrl_tpu_torch.train import trainer
from test_torch_cli import _test_block
from test_torch_quantization import SPREAD_FACTOR
from test_torch_baselines import CAP, GRAD_REL, GRAD_WORST_REL, OUT_REL, STAT_REL, STAT_WORST_REL, WITNESS, to_flax
from test_torch_train import ATOL, RTOL, _leaf, record_jax_draws

WORLD = 2
TIMEOUT = 240
CLI_TEST = "=== cli.test"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _variables(jcfg, tcfg=None):
    """``tcfg``'s registry model (the tiny config's MedFusion by default) as
    ``worker.perturbed_model`` makes it, as flax trees
    (``test_torch_baselines.to_flax``, shaped by ``jax.eval_shape`` of JAX's
    init)."""
    tm = worker.perturbed_model(tcfg or worker.tiny())
    d = jcfg.data
    rngs = {k: jax.random.key(i) for i, k in enumerate(("params", "sample", "dropout"))}
    shapes = jax.eval_shape(functools.partial(jtrainer.make_model(jcfg).init, train=True), rngs,
                            jnp.zeros((2, d.fundus_size, d.fundus_size, 3)), jnp.zeros((2, *d.oct_size, 1)),
                            jnp.zeros((2,), jnp.int32))
    # to_flax's arrays are at least 1-d: EPRL's alpha is 0-d.
    variables = jax.tree_util.tree_map(lambda v, s: np.asarray(v).reshape(s.shape), to_flax(tm, dict(shapes)),
                                       flax.core.unfreeze(shapes))
    variables.setdefault("batch_stats", {})
    return variables


def _jax_mesh_step(jcfg, variables, batch, mesh2):
    """JAX's step jitted over the 2-device mesh (``make_train_step``'s
    ``state_shardings`` path, with its draws and gradients as outputs)."""
    captured = {}

    def update(grads, opt_state, params=None):
        captured["grads"] = grads
        return jax.tree_util.tree_map(jnp.zeros_like, grads), opt_state

    tx = optax.GradientTransformation(lambda params: optax.EmptyState(), update)
    state = jtrainer.TrainState(step=jnp.asarray(0, jnp.int32), params=variables["params"],
                                batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]))
    shardings = train_state_shardings(state, mesh2)
    step = jtrainer.make_train_step(jtrainer.make_model(jcfg), tx, jcfg, jit=False)

    def run(state, batch, key):
        rec = {"uniform": [], "normal": [], "dropout": []}
        with record_jax_draws(rec, convert=lambda x: x):
            new_state, out = step(state, batch, key)
        return out, captured["grads"], new_state.batch_stats, rec

    with jax.set_mesh(mesh2):
        result = jax.jit(run)(jax.device_put(state, shardings), shard_batch(batch, mesh2), jax.random.key(7))
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(result))


def _step_draws(rec):
    """JAX's recorded draws per forward, as the port's keyword arguments
    (numpy; ``test_torch_train.port_draws``' order)."""
    out = []
    for i in range(2):
        masks = rec["dropout"][6 * i: 6 * i + 6]
        out.append({"guided_uniform": (rec["uniform"][2 * i], rec["uniform"][2 * i + 1]),
                    "eprl_eps": (rec["normal"][2 * i], rec["normal"][2 * i + 1]),
                    "dropout_masks": (masks[:2], masks[3:5])})
    return out


def _eval_draws(jcfg, n):
    m = jcfg.model
    ku1, ku2 = jax.random.split(jax.random.key(1))
    return {"guided_uniform": tuple(np.asarray(jax.random.uniform(k, (n, m.num_classes, m.z_dim))) for k in (ku1, ku2)),
            "eprl_eps": np.asarray(jax.random.normal(jax.random.key(1), (m.num_classes, m.sample_num, m.z_dim)))}


def _jax_losses(mesh2):
    """JAX's MK-MMD and Barlow over the 2-device mesh on the worker's inputs:
    values and ``jax.grad`` of their sum."""
    rng = np.random.default_rng(0)
    s, t = (rng.normal(size=(16, 32)).astype(np.float32) for _ in range(2))
    z1, z2 = (rng.normal(size=(32, 16)).astype(np.float32) for _ in range(2))
    sh = batch_sharding(mesh2)
    args = [jax.device_put(a, sh) for a in (s, t, z1, z2)]

    def parts(s, t, z1, z2):
        return jmk_mmd(s, t), jbarlow(z1, z2, common_dim=8, batch_divisor=128.0)[0]

    mmd, barlow = jax.jit(parts)(*args)
    grads = jax.jit(jax.grad(lambda *a: sum(parts(*a)), argnums=(0, 1, 2, 3)))(*args)
    port = [torch.tensor(a).requires_grad_(True) for a in (s, t, z1, z2)]
    p_mmd, p_barlow = mk_mmd(port[0], port[1]), barlow_block_loss(port[2], port[3], 8, 128.0)[0]
    (p_mmd + p_barlow).backward()
    return {"jax": (float(mmd), float(barlow), [np.asarray(g) for g in grads]),
            "port": (float(p_mmd.detach()), float(p_barlow.detach()), [p.grad.numpy() for p in port])}


def _start_cli(workdir, name="dp", *extra):
    """``cli.train`` (tiny sizes) under the launcher, 2 gloo processes, then
    ``cli.test`` on its best with MC-dropout and a 2-level sweep, launched
    alike, both with the arguments ``extra``; one log, the two parts split
    at ``CLI_TEST``."""
    common = ["--dataset", "synthetic", "--batch_size", "4", "--synthetic_samples", "8", "--plot_dir", "",
              "--device", "cpu", "--name", name, "--log_dir", str(workdir / f"cli_log_{name}"), *extra]

    def launch(*argv):
        return shlex.join([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(WORLD),
                           "--master_port", str(_free_port()),
                           os.path.join(os.path.dirname(__file__), "torch_tiny_cli.py"), *argv, *common])

    train = launch("train", "--end_epochs", "1", "--checkpoint_dir", str(workdir / "cli_ckpt"))
    test = launch("test", "--checkpoint", str(workdir / "cli_ckpt" / f"synthetic_0.5_{name}" / "best"),
                  "--mc_samples", "2", "--sweep", "gaussian", "--sweep_levels", "0.0", "0.3")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))] + sys.path))
    return subprocess.Popen(["sh", "-c", f"{train} && echo {CLI_TEST} && {test}"], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


def jax_tp_references(request, box) -> None:
    """JAX's references for the tensor-parallel cases, in a process of its
    own beside the parent's (JAX on ``conftest``'s 8 CPU devices): the
    ``tiny_tp`` variables, JAX's step jitted over the ``(1, 2)`` mesh with
    its recorded draws, and JAX's mesh ``Predictor`` on ``request``, in f32
    and in int8 (with its one-device int8 ``Predictor``)."""
    import traceback

    import conftest  # noqa: F401  (JAX on 8 CPU devices, the compile cache)

    try:
        jcfg = jax_tiny_config(batch_size=worker.BATCH)
        jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, swin_heads=worker.TP_MODEL["swin_heads"],
                                                      vit3d_heads=worker.TP_MODEL["vit3d_heads"]))
        mesh12 = make_mesh(num_data=1, num_model=WORLD, devices=jax.devices()[:WORLD])
        variables = _variables(jcfg, worker.tiny_tp())
        jout, jgrads, jstats, rec = _jax_mesh_step(jcfg, variables, worker.step_batch(worker.tiny()), mesh12)
        box.put(("draws", {"variables": variables, "step_draws": _step_draws(rec)}))
        state = jtrainer.TrainState(step=jnp.asarray(0), params=variables["params"],
                                    batch_stats=variables["batch_stats"], opt_state=())
        served = jpredictor.Predictor(jcfg, state, mesh=mesh12).predict_probs(*request)
        int8 = {where: jpredictor.Predictor(jcfg, state, mesh=m, quantize_int8=True, min_dim=32).predict_probs(*request)
                for where, m in (("mesh", mesh12), ("one", None))}
        box.put(("refs", {"step": (jout, jgrads, jstats), "predictor": served, "int8": int8}))
        zoo = {}
        for name in worker.ZOO_FAMILIES:
            zcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, model_name=name))
            zvars = _variables(zcfg, worker.named(worker.tiny_tp(), name))
            zout, zgrads, _, _ = _jax_mesh_step(zcfg, zvars, worker.step_batch(worker.tiny()), mesh12)
            zoo[name] = {"variables": zvars, "out": zout, "grads": zgrads}
            if name == "Trans_cross":
                zstate = jtrainer.TrainState(step=jnp.asarray(0), params=zvars["params"], batch_stats={}, opt_state=())
                zoo["predictor"] = jpredictor.Predictor(zcfg, zstate, mesh=mesh12).predict_probs(*request)
        box.put(("zoo", zoo))
    except Exception:
        box.put(("error", traceback.format_exc()))


def _take(box, want, timeout):
    what, payload = box.get(timeout=timeout)
    if what == "error":
        pytest.fail(f"JAX's tensor-parallel references:\n{payload}")
    assert what == want, what
    return payload


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Start the ranks (a world for the data mesh and one for the
    tensor-parallel mesh), a process for the one-process CNN steps and the
    CLIs, compute JAX's references, and collect ``{"ranks": [rank 0's
    results, rank 1's], "one": ..., "jax": ..., "cli": ..., "zoo_cli":
    ...}``."""
    workdir = tmp_path_factory.mktemp("data_parallel")
    ctx = multiprocessing.get_context("spawn")
    inboxes, outbox = [ctx.Queue() for _ in range(WORLD * len(worker.WORLDS))], ctx.Queue()
    ports = {which: _free_port() for which in worker.WORLDS}
    procs = [ctx.Process(target=worker.run, args=(r, WORLD, ports[which], inboxes[i * WORLD + r], outbox,
                                                  str(workdir), which), daemon=True)
             for i, which in enumerate(worker.WORLDS) for r in range(WORLD)]
    procs.append(ctx.Process(target=worker.resnet_references, args=(outbox,), daemon=True))
    rng = np.random.default_rng(5)
    d = worker.tiny().data
    request = (rng.integers(0, 256, (7, d.fundus_size, d.fundus_size, 3), dtype=np.uint8),
               rng.integers(0, 256, (7, *d.oct_size, 1), dtype=np.uint8))
    jax_box = ctx.Queue()
    procs.append(ctx.Process(target=jax_tp_references, args=(request, jax_box), daemon=True))
    for p in procs:
        p.start()
    cli = _start_cli(workdir)
    # A zoo model over a model axis of 2 through both CLIs.
    zoo_cli = _start_cli(workdir, "zoo", "--num_model_shards", "2", "--model_name", "Trans_cross")
    ranks, one = [{} for _ in range(WORLD)], {}
    try:
        mesh2 = make_mesh(num_data=WORLD, num_model=1, devices=jax.devices()[:WORLD])
        jcfg = jax_tiny_config(batch_size=worker.BATCH)
        variables = _variables(jcfg)
        batch = worker.step_batch(worker.tiny())
        jout, jgrads, jstats, rec = _jax_mesh_step(jcfg, variables, batch, mesh2)
        d = jcfg.data
        tp_in = _take(jax_box, "draws", TIMEOUT)
        jax_in = {"variables": variables, "step_draws": _step_draws(rec), "request": request,
                  "eval_draws": {n: _eval_draws(jcfg, n) for n in (1, 2, 4)},
                  "serving_uniform": _eval_draws(jcfg, d.eval_batch_size)["guided_uniform"],
                  "tp_variables": tp_in["variables"], "tp_step_draws": tp_in["step_draws"]}
        for q in inboxes:
            q.put(jax_in)

        # JAX's mesh run_eval and Predictor while the ranks run phase 2.
        jd = dataclasses.replace(jcfg.data, device_noise=True, num_synthetic_samples=worker.NUM_VAL)
        jloader = JaxBatchLoader(JaxSyntheticGammaDataset(jd, mode="val"), worker.BATCH, shuffle=False,
                                 drop_last=False, num_workers=2, uint8_transport=True)
        jstate = jtrainer.TrainState(step=jnp.asarray(0), params=variables["params"],
                                     batch_stats=variables["batch_stats"], opt_state=())
        jstate = jax.device_put(jstate, train_state_shardings(jstate, mesh2))
        model = jtrainer.make_model(jcfg)
        jm, jt, jp = jtrainer.run_eval(jstate, jtrainer.make_eval_step(model, jcfg, mesh=mesh2), jloader,
                                       mesh=mesh2)
        jserved = jpredictor.Predictor(jcfg, jstate, mesh=mesh2).predict_probs(*request)
        tp_refs = _take(jax_box, "refs", TIMEOUT)
        jax_ref = {"step": (jout, jgrads, jstats), "run_eval": (jm.as_dict(), jt, np.asarray(jp)),
                   "predictor": jserved, "losses": _jax_losses(mesh2), "tp_step": tp_refs["step"],
                   "tp_predictor": tp_refs["predictor"], "tp_int8": tp_refs["int8"],
                   "zoo": _take(jax_box, "zoo", TIMEOUT)}

        deadline = time.time() + TIMEOUT
        for _ in range(2 * WORLD * len(worker.WORLDS) + len(worker.CNN_REFERENCES)):
            rank, what, results = outbox.get(timeout=max(deadline - time.time(), 1))
            if rank == "one":
                one[what] = results
            else:
                ranks[rank].update(results)
        for p in procs:
            p.join(timeout=30)
        log, _ = cli.communicate(timeout=max(deadline - time.time(), 30))
        zoo_log, _ = zoo_cli.communicate(timeout=max(deadline - time.time(), 30))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for c in (cli, zoo_cli):
            if c.poll() is None:
                c.kill()
    return {"ranks": ranks, "one": one, "jax": jax_ref, "cli": (cli.returncode, log, workdir),
            "zoo_cli": (zoo_cli.returncode, zoo_log, workdir), "variables": variables,
            "tp_variables": tp_in["variables"]}


def _results(world2, name):
    """Both ranks' results of case ``name``, failing with a rank's traceback."""
    out = []
    for rank, results in enumerate(world2["ranks"]):
        got = results.get(name)
        assert got is not None, f"rank {rank} posted nothing for {name}"
        if isinstance(got, dict) and "error" in got:
            pytest.fail(f"rank {rank}, case {name}:\n{got['error']}")
        out.append(got)
    return out


def test_gathered_mmd_and_barlow_match_the_global_batch(world2):
    ranks = _results(world2, "losses")
    ref = world2["jax"]["losses"]
    for want_mmd, want_barlow, want_grads in (ref["port"], ref["jax"]):
        for got in ranks:
            assert got["mmd"] == pytest.approx(want_mmd, rel=1e-4)
            assert got["barlow"] == pytest.approx(want_barlow, rel=1e-4)
        for rank, got in enumerate(ranks):
            for g, w in zip(got["grads"], want_grads):
                rows = slice(rank * g.shape[0], (rank + 1) * g.shape[0])
                np.testing.assert_allclose(g, np.asarray(w)[rows], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["dilr", "conv"])
def test_batchnorm_statistics_are_the_global_batch(world2, name):
    ranks = [r[name] for r in _results(world2, "batchnorm")]
    for rank, got in enumerate(ranks):
        want, mine = got["global"], got["ranks"]
        rows = slice(rank * mine["y"].shape[0], (rank + 1) * mine["y"].shape[0])
        np.testing.assert_allclose(mine["y"], want["y"][rows], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(mine["x_grad"], want["x_grad"][rows], atol=1e-5, rtol=1e-5)
        for g, w in zip(mine["stats"] + mine["params"], want["stats"] + want["params"]):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_dilr_on_ranks_matches_the_global_batch(world2):
    for rank, got in enumerate(_results(world2, "dilr")):
        want, mine = got["global"], got["ranks"]
        rows = slice(rank * mine["combined"].shape[0], (rank + 1) * mine["combined"].shape[0])
        np.testing.assert_allclose(mine["combined"], want["combined"][rows], atol=1e-5, rtol=1e-5)
        assert mine["loss"] == pytest.approx(want["loss"], rel=1e-5)
        for g, w in zip(mine["stats"], want["stats"]):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
        for k in want["grads"]:
            np.testing.assert_allclose(mine["grads"][k], want["grads"][k][rows], atol=1e-5, rtol=1e-5, err_msg=k)


def test_step_on_two_ranks_matches_jax_mesh_step(world2):
    jout, jgrads, jstats = world2["jax"]["step"]
    state = trainer.init_state(worker.tiny(), device="cpu", variables=world2["variables"])
    key_map = flax_key_map(state.model, world2["variables"]["params"], world2["variables"]["batch_stats"])
    for got in _results(world2, "step"):
        for key in ("loss", "mmd", "dilr_loss", "proxy_loss_fundus", "proxy_loss_oct", "ce_loss", "ib_loss"):
            np.testing.assert_allclose(got["out"][key], np.asarray(jout[key]), atol=ATOL, rtol=RTOL, err_msg=key)
        np.testing.assert_allclose(got["out"]["probs"], np.asarray(jout["probs"]), atol=ATOL, rtol=RTOL)
        assert set(got["out"]) == set(jout)
        for name, grad in got["grads"].items():
            want = _leaf(jgrads, key_map[name])
            np.testing.assert_allclose(grad, want.T if key_map[name].endswith("/kernel") else want,
                                       atol=ATOL, rtol=RTOL, err_msg=name)
        assert len(got["grads"]) == len(jax.tree_util.tree_leaves(jgrads))
        stats = [n for n in got["stats"] if n in key_map]
        assert len(stats) == 4
        for name in stats:
            np.testing.assert_allclose(got["stats"][name], _leaf(jstats, key_map[name]), atol=1e-5, rtol=1e-5)


def test_multi_resnet_step_on_two_ranks_under_the_cnn_rule(world2):
    """Each result relative to its f64 value's largest magnitude: the 2-rank
    f32 step's error within ``WITNESS`` times the one-process f32 spread or
    ``test_torch_baselines``' bars (median and worst over the step's
    gradients and statistics)."""
    one = world2["one"]["resnet"]
    if "error" in one:
        pytest.fail(one["error"])
    _hold_to_the_cnn_rule(_results(world2, "resnet"), one["f64"], one["f32"])


def _hold_to_the_cnn_rule(rank_results, f64, f32s):
    for rank_result in rank_results:
        rel = {"out": [], "grad": [], "stat": []}
        for index, kind in ((0, "out"), (1, "grad"), (2, "stat")):
            for name, want in f64[index].items():
                scale = max(float(np.abs(want).max()), 1e-30)
                err = float(np.abs(rank_result[index][name] - want).max()) / scale
                spread = max(float(np.abs(s[index][name] - want).max()) for s in f32s) / scale
                rel[kind].append((err, spread))
        assert len(rel["grad"]) > 100 and len(rel["stat"]) > 50 and len(rel["out"]) == 3
        for kind, median_bar, worst_bar in (("out", OUT_REL, OUT_REL), ("grad", GRAD_REL, GRAD_WORST_REL),
                                            ("stat", STAT_REL, STAT_WORST_REL)):
            errs, spreads = np.array(rel[kind]).T
            assert np.median(errs) <= max(median_bar, WITNESS * np.median(spreads)), kind
            assert errs.max() <= min(max(worst_bar, WITNESS * spreads.max()), CAP), kind


def test_zero1_step_equals_the_replicated_step(world2):
    ranks = _results(world2, "zero1")
    total = ranks[0]["bytes"][False]
    assert all(r["is_zero1"] for r in ranks)
    assert sum(r["bytes"][True] for r in ranks) == total
    for r in ranks:
        assert r["param_diff"] == 0.0
        assert 0.3 * total <= r["bytes"][True] <= 0.7 * total, (r["bytes"], total)
    assert ranks[0]["restored_moment_diff"] == 0.0 and ranks[0]["restored_param_diff"] == 0.0


def test_run_eval_on_two_ranks_matches_world_one_and_jax(world2):
    jm, jt, jp = world2["jax"]["run_eval"]
    ranks = _results(world2, "run_eval")
    one_m, one_t, one_p = ranks[0]["one"]
    for got in ranks:
        m, t, p = got["ranks"]
        assert t.shape == (worker.NUM_VAL,) and np.array_equal(t, one_t) and np.array_equal(t, jt)
        np.testing.assert_allclose(p, one_p, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(p, jp, atol=1e-5, rtol=1e-5)
        for key, value in m.items():
            if key != "loss":
                assert value == pytest.approx(one_m[key], abs=1e-6), key
            assert value == pytest.approx(jm[key], abs=1e-5, rel=1e-5), key


def test_fit_on_two_ranks_writes_once_and_resumes_bit_equal(world2):
    ranks = _results(world2, "fit")
    for r in ranks:
        assert r["resume_diff"] == 0.0 and r["steps"] == (4, 4)
        assert r["val"] == ranks[0]["val"] and r["train"] == ranks[0]["train"]
    assert ranks[0]["restored_diff"] == 0.0
    workdir = world2["cli"][2]
    with open(workdir / "fit_whole" / "log" / "synthetic_0.5_dp.csv") as f:
        assert len(f.read().splitlines()) == 3
    assert os.listdir(workdir / "fit_whole" / "log") == ["synthetic_0.5_dp.csv"]
    ckpt = set(os.listdir(workdir / "fit_whole" / "ckpt"))
    assert {"best", "best.json", "latest", "latest.json"} <= ckpt
    assert len([e for e in ckpt if e.startswith(".latest.v-")]) == 1


def test_predictor_on_two_ranks_matches_world_one_and_jax(world2):
    ranks = _results(world2, "predictor")
    for got in ranks:
        for key in ("ranks_1", "ranks_2"):
            assert got[key].shape == (7, 2)
            np.testing.assert_allclose(got[key], ranks[0]["one"], atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(got[key], world2["jax"]["predictor"], atol=1e-4, rtol=1e-4)
    for message in _results(world2, "predictor_refuses"):
        assert message is not None and "not divisible" in message


def test_train_cli_under_torchrun(world2):
    rc, log, workdir = world2["cli"]
    assert rc == 0, log[-3000:]
    log = log.split(CLI_TEST)[0]
    assert log.count("Train Epoch: 1") == 1 and log.count("Val   Epoch: 1") == 1, log[-3000:]
    with open(workdir / "cli_log_dp" / "synthetic_0.5_dp.csv") as f:
        assert len(f.read().splitlines()) == 2
    with open(workdir / "cli_log_dp" / "synthetic_dp_train.log") as f:
        train_log = f.read()
    assert train_log.count("Test: Acc") == 1 and train_log.count("Missing-modality [oct-only]") == 1
    assert (workdir / "cli_ckpt" / "synthetic_0.5_dp" / "best").is_dir()


def test_test_cli_under_torchrun(world2):
    """cli.test on the launched train run's best, across the ranks: its test
    block equals the train run's, rank 0 prints MC-dropout (over the whole
    set, the other ranks waiting in the evaluation's collectives) once, and
    the sweep's grid is logged once."""
    rc, log, workdir = world2["cli"]
    assert rc == 0 and CLI_TEST in log, log[-3000:]
    out = log.split(CLI_TEST)[1]
    mc = [line for line in out.splitlines() if line.startswith("MC-dropout (K=2): ")]
    assert len(mc) == 1 and mc[0].endswith("mean predictive std 0.0000"), out[-3000:]
    logs = {p: (workdir / "cli_log_dp" / f"synthetic_dp_{p}.log").read_text() for p in ("train", "test")}
    assert _test_block(logs["test"]) == _test_block(logs["train"])
    assert logs["test"].count("Robustness sweep [gaussian]:") == 1
    assert sum(f"\t{s}\t" in logs["test"] for s in ("0", "0.3")) == 2


def test_sweep_on_two_ranks_matches_world_one(world2):
    """Every cell's metrics but the loss (which averages over the padded row
    of the remainder batch, as JAX's ``run_eval`` does) equal world 1's; the
    loss is the same on both ranks."""
    ranks = _results(world2, "sweep")
    one = ranks[0]["one"]
    assert set(one) == {"both", "fundus-only", "oct-only"}
    for got in ranks:
        assert set(got["ranks"]) == set(one)
        for modality, by_level in one.items():
            assert set(got["ranks"][modality]) == set(by_level) == {0.0, 0.3}
            for level, want in by_level.items():
                cell = got["ranks"][modality][level]
                assert cell["num_samples"] == want["num_samples"] == worker.NUM_VAL
                assert cell["loss"] == ranks[0]["ranks"][modality][level]["loss"]
                for key, value in want.items():
                    if key != "loss":
                        assert cell[key] == pytest.approx(value, abs=1e-6), (modality, level, key)


def test_zero1_fit_on_two_ranks_resumes_bit_equal(world2):
    """fit with ZeRO-1 at world 2, stopped after epoch 1 and resumed from the
    consolidated checkpoint, ends bit-equal to the uninterrupted replicated
    run (parameters, moments), and its checkpoint restores in one process."""
    ranks = _results(world2, "fit_zero1")
    for r in ranks:
        assert r["is_zero1"] and r["param_diff"] == 0.0 and r["steps"] == (4, 4)
        assert r["train"] == ranks[0]["train"] and len(r["train"]) == 1
    assert ranks[0]["moment_diff"] == 0.0 and ranks[0]["restored_diff"] == 0.0


def _close(got, want, bar=1e-5):
    np.testing.assert_allclose(got, want, atol=bar, rtol=bar)


@pytest.mark.parametrize("flag", ["use_fused_ln", "use_fused_mlp", "use_fused_block_attention"])
def test_fused_flags_under_the_data_mesh_match_world_one(world2, flag):
    """B4, B5 and B6 (their plain versions here) on the data mesh: the
    step's global results and averaged gradients against world 1's at the
    step's bars."""
    ranks = [r[flag] for r in _results(world2, "fused_flags")]
    one = ranks[0]["one"]
    for got in ranks:
        for key, value in one["out"].items():
            np.testing.assert_allclose(got["ranks"]["out"][key], value, atol=ATOL, rtol=RTOL, err_msg=key)
        assert set(got["ranks"]["grads"]) == set(one["grads"])
        for name, grad in one["grads"].items():
            np.testing.assert_allclose(got["ranks"]["grads"][name], grad, atol=ATOL, rtol=RTOL, err_msg=name)


def test_tp_step_matches_jax_tp_step(world2):
    """The (1, 2) step against JAX's step over the (1, 2) mesh: results,
    every gradient at full shape, running statistics; the routes the
    attention modules took."""
    jout, jgrads, jstats = world2["jax"]["tp_step"]
    state = trainer.init_state(worker.tiny_tp(), device="cpu", variables=world2["tp_variables"])
    key_map = flax_key_map(state.model, world2["tp_variables"]["params"], world2["tp_variables"]["batch_stats"])
    ranks = _results(world2, "tp_step")
    for got in ranks:
        for key in ("loss", "mmd", "dilr_loss", "proxy_loss_fundus", "proxy_loss_oct", "ce_loss", "ib_loss",
                    "probs"):
            np.testing.assert_allclose(got["out"][key], np.asarray(jout[key]), atol=ATOL, rtol=RTOL, err_msg=key)
        for name in [n for n in got["stats"] if n in key_map]:
            np.testing.assert_allclose(got["stats"][name], _leaf(jstats, key_map[name]), atol=1e-5, rtol=1e-5)
    grads = ranks[0]["grads"]
    assert len(grads) == len(jax.tree_util.tree_leaves(jgrads))
    for name, grad in grads.items():
        want = _leaf(jgrads, key_map[name])
        np.testing.assert_allclose(grad, want.T if key_map[name].endswith("/kernel") else want,
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    assert [r["model_axis"] for r in ranks] == [(0, 2), (1, 2)]
    routes = ranks[0]["routes"]
    assert routes["transformer_2d.SwinBlock_0.WindowAttention_0"] == "gathered"
    assert routes["transformer_2d.SwinBlock_1.WindowAttention_0"] == "head_local"
    assert routes["transformer_3d.SelfAttentionBlock_0.MultiHeadAttention_0"] == "gathered"
    assert routes["dilr.cross_attn2.MultiHeadAttention_0"] == "head_local"
    assert routes["dilr.self_attn1.MultiHeadAttention_0"] == "head_local"


def test_tp_replicated_parameters_are_bit_equal_across_model_ranks(world2):
    """Every parameter the model axis does not split: the same gradient, as
    each rank computed it before the step's broadcast (nothing overwritten),
    and the same gradient and value after the step, bit for bit, on both
    ranks; the split ones are the Dense kernels the rules name."""
    a, b = _results(world2, "tp_step")
    assert a["drift"] == b["drift"] == 0.0
    assert a["split"] == b["split"] and len(a["split"]) > 40
    assert set(a["replicated"]) == set(b["replicated"]) and len(a["replicated"]) > 40
    for name in a["replicated"]:
        assert np.array_equal(a["replicated"][name], b["replicated"][name]), name
        assert np.array_equal(a["replicated_params"][name], b["replicated_params"][name]), name


def test_tp_run_eval_and_sweep_match_one_process(world2):
    for got in _results(world2, "tp_run_eval"):
        (m, t, p), (m1, t1, p1) = got["ranks"], _results(world2, "tp_run_eval")[0]["one"]
        assert np.array_equal(t, t1) and t.shape == (worker.NUM_VAL,)
        _close(p, p1, 1e-6)
        for key, value in m1.items():
            assert m[key] == pytest.approx(value, abs=1e-6), key
    one = _results(world2, "tp_sweep")[0]["one"]
    for got in _results(world2, "tp_sweep"):
        for modality, by_level in one.items():
            for level, want in by_level.items():
                for key, value in want.items():
                    assert got["ranks"][modality][level][key] == pytest.approx(value, abs=1e-6), (modality, key)


def test_tp_predictor_matches_jax_mesh_predictor(world2):
    ranks = _results(world2, "tp_predictor")
    for got in ranks:
        assert got["ranks_f32"].shape == (7, 2)
        np.testing.assert_allclose(got["ranks_f32"], world2["jax"]["tp_predictor"], atol=5e-5, rtol=0)
        np.testing.assert_allclose(got["ranks_f32"], ranks[0]["one_f32"], atol=1e-6, rtol=0)


def test_tp_int8_predictor_equals_one_process(world2):
    """int8 over the model axis: the full f32 weights quantized, then
    sliced; the row-parallel layers' per-row scales are the max over the
    ranks and their int32 partial products are summed exactly, so the
    probabilities equal one process's bit for bit.  Against JAX's mesh int8
    ``Predictor``: within 5e-5, or within ``SPREAD_FACTOR`` times JAX's own
    distance between its mesh and one-device int8 ``Predictor``s (int8
    rounding turns a float's last bits into a quantization step)."""
    ranks = _results(world2, "tp_predictor")
    jax_int8 = world2["jax"]["tp_int8"]
    spread = float(np.abs(jax_int8["mesh"] - jax_int8["one"]).max())
    for got in ranks:
        assert got["ranks_int8"].shape == (7, 2)
        assert np.array_equal(got["ranks_int8"], ranks[0]["one_int8"])
        diff = float(np.abs(got["ranks_int8"] - jax_int8["mesh"]).max())
        assert diff <= max(5e-5, SPREAD_FACTOR * spread), (diff, spread)


def test_tp_fit_resumes_bit_equal_and_restores_in_one_process(world2):
    ranks = _results(world2, "tp_fit")
    for r in ranks:
        assert r["resume_diff"] == 0.0 and r["steps"] == (4, 4)
        assert r["train"] == ranks[0]["train"]
    assert ranks[0]["restored_diff"] == 0.0 and ranks[0]["restored_keys"]


def test_tp_clipped_step_matches_one_process(world2):
    ranks = _results(world2, "tp_clip")
    one = ranks[0]["one"]
    for got in ranks:
        for name, grad in one.items():
            np.testing.assert_allclose(got["ranks"][name], grad, atol=1e-6, rtol=1e-4, err_msg=name)


def test_tp_remat_reruns_the_collectives_alike(world2):
    """``remat`` and ``remat_attention`` at (1, 2): the recomputed forwards'
    collectives run in the backward on both ranks, and the gradients equal
    the step's without rematerialisation."""
    for got in _results(world2, "tp_remat"):
        for label in ("remat", "remat_attention"):
            for name, grad in got["plain"].items():
                np.testing.assert_allclose(got[label][name], grad, atol=1e-6, rtol=1e-5, err_msg=(label, name))


def test_tp_refusals_name_what_is_not_ported(world2):
    """B5, B6 and an export refuse a model axis of 2 by name; a baseline and
    ``scan_batches`` run there, and a chunked ``Predictor`` takes the staged
    route."""
    for got in _results(world2, "tp_refusals"):
        assert got["use_fused_mlp"][0] == "ValueError" and "use_fused_mlp" in got["use_fused_mlp"][1]
        assert got["use_fused_block_attention"][0] == "ValueError"
        assert "use_fused_block_attention" in got["use_fused_block_attention"][1]
        assert got["baseline"] is None and got["scan_batches"] is None
        assert got["chunk_batches"] == "staged"
        assert "model axis of 2" in got["export"]


def _hold_to_jax_grads(grads, jgrads, key_map):
    assert len(grads) == len(jax.tree_util.tree_leaves(jgrads))
    for name, grad in grads.items():
        want = _leaf(jgrads, key_map[name])
        np.testing.assert_allclose(grad, want.T if key_map[name].endswith("/kernel") else want,
                                   atol=ATOL, rtol=RTOL, err_msg=name)


# The attention modules' routes at (1, 2) in tiny_tp (Swin's stage 0 and ViT
# of 1 head gathered, Swin's stage 1 of 4 heads and the 8-head cross
# attention head-local).
ZOO_ROUTES = {
    "2D_transformer": {"backbone.SwinBlock_0.WindowAttention_0": "gathered",
                       "backbone.SwinBlock_1.WindowAttention_0": "head_local"},
    "3D_transformer": {"backbone.SelfAttentionBlock_0.MultiHeadAttention_0": "gathered",
                       "backbone.SelfAttentionBlock_1.MultiHeadAttention_0": "gathered"},
    "Trans_cross": {"fundus_backbone.SwinBlock_0.WindowAttention_0": "gathered",
                    "fundus_backbone.SwinBlock_1.WindowAttention_0": "head_local",
                    "oct_backbone.SelfAttentionBlock_0.MultiHeadAttention_0": "gathered",
                    "oct_backbone.SelfAttentionBlock_1.MultiHeadAttention_0": "gathered", "cross": "head_local"},
    "MLC_trans": {"fundus_backbone.SwinBlock_0.WindowAttention_0": "gathered",
                  "fundus_backbone.SwinBlock_1.WindowAttention_0": "head_local",
                  "oct_backbone.SelfAttentionBlock_0.MultiHeadAttention_0": "gathered",
                  "oct_backbone.SelfAttentionBlock_1.MultiHeadAttention_0": "gathered"},
}


@pytest.mark.parametrize("name", worker.ZOO_FAMILIES)
def test_tp_zoo_step_matches_jax_tp_step(world2, name):
    """Each transformer family's (1, 2) step against JAX's step over the
    (1, 2) mesh on the same variables and batch: loss, MMD, probabilities
    and every gradient at full shape at the step's bars; the replicated
    gradients bit-equal on the two ranks, before the step's broadcast too;
    the routes."""
    ref = world2["jax"]["zoo"][name]
    ranks = [r[name] for r in _results(world2, "tp_zoo_steps")]
    for got in ranks:
        assert got["drift"] == 0.0
        assert set(got["out"]) == set(ref["out"])
        for key, value in ref["out"].items():
            np.testing.assert_allclose(got["out"][key], np.asarray(value), atol=ATOL, rtol=RTOL, err_msg=key)
        assert got["routes"] == ZOO_ROUTES[name]
    state = trainer.init_state(worker.named(worker.tiny_tp(), name), device="cpu", variables=ref["variables"])
    key_map = flax_key_map(state.model, ref["variables"]["params"], None)
    _hold_to_jax_grads(ranks[0]["grads"], ref["grads"], key_map)
    a, b = ranks
    assert a["split"] == b["split"] and len(a["split"]) > 10
    assert set(a["replicated"]) == set(b["replicated"]) and a["replicated"]
    for n in a["replicated"]:
        assert np.array_equal(a["replicated"][n], b["replicated"][n]), n


@pytest.mark.parametrize("name", worker.CNN_FAMILIES)
def test_tp_cnn_step_under_the_cnn_rule(world2, name):
    """Multi_ResNet (every parameter replicated) and Multi_ResNet_cross (its
    two attentions head-local) at (1, 2), global batch 4, each rank's step
    held against the one-process f64 step by the CNN rule
    (``test_multi_resnet_step_on_two_ranks_under_the_cnn_rule``'s); the two
    ranks' results bit-equal, and their replicated gradients before the
    step's broadcast too."""
    one = world2["one"][f"tp_{name}"]
    if "error" in one:
        pytest.fail(one["error"])
    ranks = [r[name] for r in _results(world2, "tp_cnn_steps")]
    assert all(r["drift"] == 0.0 for r in ranks)
    _hold_to_the_cnn_rule([r["step"] for r in ranks], one["f64"], one["f32"])
    for index in range(3):
        for n, v in ranks[0]["step"][index].items():
            assert np.array_equal(v, ranks[1]["step"][index][n]), n
    if name == "Multi_ResNet":
        assert ranks[0]["split"] == [] and ranks[0]["routes"] == {}
    else:
        assert len(ranks[0]["split"]) == 14 and ranks[0]["routes"] == {"cross_fo": "head_local",
                                                                       "cross_of": "head_local"}


def test_tp_replicated_gradients_are_model_rank_zeros_after_the_broadcast(world2):
    """The step's broadcast over the model group: replicated gradients that
    differ over the ranks (each rank's own draw) leave it as model rank 0's,
    bit for bit; the split ones stay each rank's own.  The broadcast counts
    once with the replicated gradients' bytes, and model rank 1 records the
    largest |difference| it overwrote (rank 0 overwrites none)."""
    a, b = _results(world2, "tp_broadcast")
    assert a["split"] == b["split"] and len(a["split"]) == 14
    replicated = [n for n in a["before"] if n not in a["split"]]
    want = max(float(np.abs(b["before"][n] - a["before"][n]).max()) for n in replicated)
    assert a["drift"] == 0.0 and b["drift"] == pytest.approx(want, rel=1e-6) and want > 0
    nbytes = sum(a["before"][n].size for n in replicated) * 4
    for got in (a, b):
        assert got["collectives"] == {"all_reduce": 0, "all_gather": 0, "broadcast": 1, "bytes": nbytes}
    for name in a["before"]:
        assert not np.array_equal(a["before"][name], b["before"][name]), name
        if name in a["split"]:
            assert np.array_equal(a["after"][name], a["before"][name]), name
            assert np.array_equal(b["after"][name], b["before"][name]), name
        else:
            assert np.array_equal(a["after"][name], a["before"][name]), name
            assert np.array_equal(b["after"][name], a["before"][name]), name


def test_tp_imdr_shards_as_medfusion(world2):
    """IMDR at (1, 2) is MedFusion at (1, 2): the same split parameters, and
    the same results and gradients bit for bit."""
    for got in _results(world2, "tp_imdr"):
        want, imdr = got["MedFusion"], got["IMDR"]
        assert imdr["split"] == want["split"] and len(want["split"]) > 40
        assert all(np.array_equal(imdr["out"][k], v) for k, v in want["out"].items())
        assert imdr["grads"].keys() == want["grads"].keys()
        assert all(np.array_equal(imdr["grads"][k], v) for k, v in want["grads"].items())


def test_tp_zoo_fit_resumes_bit_equal_and_restores_in_one_process(world2):
    ranks = _results(world2, "tp_zoo_fit")
    for r in ranks:
        assert r["resume_diff"] == 0.0 and r["steps"] == (4, 4)
        assert r["train"] == ranks[0]["train"]
    assert ranks[0]["restored_diff"] == 0.0 and ranks[0]["restored_keys"]


def test_tp_zoo_predictor_matches_jax_mesh_predictor(world2):
    """Trans_cross served at (1, 2), batch by batch and in chunks of 2 (the
    staged route, one chunk), against JAX's mesh ``Predictor`` at 1e-4; the
    two equal to each other."""
    want = world2["jax"]["zoo"]["predictor"]
    for got in _results(world2, "tp_zoo_predictor"):
        for chunk in (1, 2):
            assert got[chunk]["probs"].shape == (7, 2) and got[chunk]["route"] == "staged"
            np.testing.assert_allclose(got[chunk]["probs"], want, atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(got[1]["probs"], got[2]["probs"])
        assert got[1]["chunks"] == {"graph": 0, "staged": 0} and got[2]["chunks"] == {"graph": 0, "staged": 1}


def test_tp_zoo_mc_dropout_and_sweep_match_one_process(world2):
    """MC-dropout of Multi_dropout_ResNet and MLC_trans's sweep at (1, 2)
    equal one process's: the MC means and stds bit for bit (each rank's
    dropout draws seeded as one process's), every sweep cell at 1e-6."""
    ranks = _results(world2, "tp_zoo_eval")
    one = {**ranks[0]["one"], **ranks[1]["one"]}
    assert float(one["mc"]["predictive_std"].mean()) > 0.0
    for got in ranks:
        for k, v in one["mc"].items():
            np.testing.assert_array_equal(got["ranks"]["mc"][k], v, err_msg=k)
        for modality, by_level in one["sweep"].items():
            for level, want in by_level.items():
                for key, value in want.items():
                    assert got["ranks"]["sweep"][modality][level][key] == pytest.approx(value, abs=1e-6), (
                        modality, level, key)


@pytest.mark.parametrize("layout", ["world2_scan_2", "world2_scan_64", "world2_zero1_scan_2", "tp_1x2_scan_2"])
def test_scan_batches_fit_is_bit_equal_to_per_batch_fit(world2, layout):
    """fit with ``scan_batches`` against the per-batch fit of the same
    layout: world 2 on the data axis with K = 2 and K = 64 (longer than the
    epoch), ZeRO-1 at world 2, and (1, 2); the final parameters and moments
    bit-equal to the per-batch run's checkpoint, the train history equal."""
    if layout.startswith("tp"):
        ranks, whole = _results(world2, "tp_fit_scan"), _results(world2, "tp_fit")
    else:
        label = layout.split("_", 1)[1]
        ranks, whole = [r[label] for r in _results(world2, "fit_scan")], _results(world2, "fit")
    for rank, (got, want) in enumerate(zip(ranks, whole)):
        assert got["steps"] == 4 and got["train"] == want["train"]
        if rank == 0:
            assert got["diff"] == 0.0


def test_zoo_clis_under_a_model_axis(world2):
    """``cli.train --num_model_shards 2 --model_name Trans_cross`` under the
    launcher, then ``cli.test`` on its best with MC-dropout and the sweep:
    the test block equals the train run's, MC-dropout prints once (std 0:
    the model draws nothing in eval), the sweep's grid is logged once."""
    rc, log, workdir = world2["zoo_cli"]
    assert rc == 0 and CLI_TEST in log, log[-3000:]
    assert log.split(CLI_TEST)[0].count("Train Epoch: 1") == 1, log[-3000:]
    mc = [line for line in log.split(CLI_TEST)[1].splitlines() if line.startswith("MC-dropout (K=2): ")]
    assert len(mc) == 1 and mc[0].endswith("mean predictive std 0.0000"), log[-3000:]
    logs = {p: (workdir / "cli_log_zoo" / f"synthetic_zoo_{p}.log").read_text() for p in ("train", "test")}
    assert _test_block(logs["test"]) == _test_block(logs["train"])
    assert logs["test"].count("Robustness sweep [gaussian]:") == 1
