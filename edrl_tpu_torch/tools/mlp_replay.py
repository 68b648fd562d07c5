"""B5's (fused MLP) f32 results in a small train step, held against the plain
version on the inputs the CPU's own step gives it.

Run from the root of a checkout, on a machine with one CUDA card:

    python -m edrl_tpu_torch.tools.mlp_replay [--seeds N]

In f32 the fused MLP still rounds its activation, dy and dh to bf16, as the
TPU kernel does.  :func:`replay_step` runs one step of :func:`slice_config`
(a small model whose every LayerNorm and MLP routes to B4 and B5) on the
card, recording each B5 call's inputs and results, then the same step on the
CPU, where each B5 call returns the card's result (so that EPRL's top-k sees
the same values on both devices).  Each card result is read, relative to the
plain result's largest magnitude:

- ``same``: against the plain version on the inputs the kernel took (run on
  the card);
- ``cpu``: against the plain version on the CPU step's inputs.  These differ
  from the card's (``inputs``, the largest distance) by the step's rounding:
  B4's and the attention's sums run in other orders, and a cotangent that
  is a cancelling sum carries that at up to ~1e-3 of its largest magnitude.
  So some of the plain version's bf16 roundings land one bf16 ulp from
  where they land on the card's inputs, and each such flip moves a term of
  a sum by 2^-8 of itself;
- ``witness``: against :func:`witness`, the plain version on the CPU step's
  inputs with each of its bf16 roundings that lies one bf16 ulp from the
  card inputs' rounding of the same value taking the card inputs' one.  It
  is the ``cpu`` comparison with those flips, and only those, accounted
  for; ``flips`` counts them and ``wider`` the roundings that differ by more
  than one ulp (left as the CPU's): values near zero, where an f32 ulp of
  the inputs is many bf16 ulps of the value.

The step's B4 calls (f32) are read as well, each against its plain version
on the inputs the kernel took (``b4``).  ``main`` prints these for
``--seeds`` seeds, with the step's gradients card against CPU, and the
largest of each.  With ``--calls`` it prints every B5 call's readings and
traces both steps (:func:`traced`, :func:`first_divergence`): the first
module call of the forward whose outputs' card and CPU values differ by more
than ``DIVERGED`` of their largest magnitude and by more than ``AMPLIFIED``
times its inputs' difference, the first gradient of a module output in the
backward (in the order autograd reaches them) that differs by more than
``DIVERGED`` and by more than ``AMPLIFIED`` times every gradient reached
before it, the backward's largest difference, and each ``topk`` of the step
(EPRL's): the rows whose index sets differ between card and CPU and the
card's margin there (the gap between the k-th and the next value).  It
calls only the port's public modules and ``fused_mlp._bf16`` (the one
rounding of B5's plain versions), so copying it into an older tree of the
port measures that tree the same way.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import subprocess

import numpy as np
import torch

from edrl_tpu_torch.config import EDRLConfig, tiny_test_config
from edrl_tpu_torch.kernels import fused_mlp as fm
from edrl_tpu_torch.kernels import layer_norm as ln
from edrl_tpu_torch.tools.sublayer_dbias import rel_err
from edrl_tpu_torch.train import trainer

BATCH = 4
DIVERGED = 1e-3  # a traced tensor's card-vs-CPU difference, of its largest magnitude
AMPLIFIED = 100.0  # ... and over its inputs' difference (forward)


def slice_config() -> EDRLConfig:
    """The small f32 model: widths that route to B4 and B5 (multiples of 128)."""
    cfg = tiny_test_config(batch_size=BATCH)
    return cfg.replace(model=dataclasses.replace(
        cfg.model, use_fused_attention=True, vit_fused_attention=True, swin_embed_dim=128, swin_heads=(1, 2),
        fundus_embed_dim=256, oct_embed_dim=128, vit3d_heads=2, use_fused_ln=True, use_fused_mlp=True))


def small_draws(model, device, seed: int = 6) -> list:
    """The noise of a batch-4 step of a tiny config with ``model``'s token
    counts and widths, drawn with numpy so that card and CPU take the same."""
    r = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    out = []
    for _ in range(2):
        masks = []
        for tokens in (model.fundus_tokens, model.oct_tokens):
            masks.append([t(r.uniform(size=(BATCH, tokens, 2 * model.z_dim)) < 0.8) for _ in range(2)])
        out.append({
            "guided_uniform": tuple(t(r.uniform(size=(BATCH, model.num_classes, model.z_dim)).astype(np.float32))
                                    for _ in range(2)),
            "eprl_eps": tuple(t(r.normal(size=(model.num_classes, model.sample_num, model.z_dim)).astype(np.float32))
                              for _ in range(2)),
            "dropout_masks": tuple(masks),
        })
    return out


def one_ulp_apart(a, b):
    """Where two tensors of bf16 values lie one bf16 ulp apart (same sign)."""
    ia = a.to(torch.bfloat16).view(torch.int16).int()
    ib = b.to(torch.bfloat16).view(torch.int16).int()
    return (ia - ib).abs() == 1


@contextlib.contextmanager
def _rounding(fn):
    """B5's plain versions with ``fused_mlp._bf16`` replaced by ``fn``."""
    saved = fm._bf16
    fm._bf16 = fn
    try:
        yield
    finally:
        fm._bf16 = saved


def witness(plain, args, card_args):
    """``plain(*args)`` (a B5 plain version) with each bf16 rounding that
    lies one bf16 ulp from the same rounding in ``plain(*card_args)`` taking
    the latter's value: ``(result, flips, wider)``, the roundings so taken
    and those that differ by more than one ulp (kept)."""
    bf16, taken, counts = fm._bf16, [], {"flips": 0, "wider": 0}

    def record(x):
        taken.append(bf16(x))
        return taken[-1]

    def snap(x):
        r, k = bf16(x), next(turns, None)
        if k is None or k.shape != r.shape:
            raise RuntimeError("witness: the two calls rounded different tensors")
        near = one_ulp_apart(r, k)
        counts["flips"] += int(near.sum())
        counts["wider"] += int(((r != k) & ~near).sum())
        return torch.where(near, k, r)

    with _rounding(record):
        plain(*card_args)
    turns = iter(taken)
    with _rounding(snap):
        out = plain(*args)
    if next(turns, None) is not None:
        raise RuntimeError("witness: the two calls rounded different tensors")
    return out, counts["flips"], counts["wider"]


def grad_errors(card, state) -> list:
    """``[(error, name)]`` sorted: each parameter's gradient in ``card`` (a
    state on the card) against ``state``'s (on the CPU), relative to the
    latter's largest magnitude; gradients that are all zero on the CPU and
    the attention's key biases (whose gradient is zero but for rounding) are
    left out."""
    return sorted((rel_err(pg.grad.cpu(), pc.grad), name)
                  for (name, pg), pc in zip(card.model.named_parameters(), state.model.parameters())
                  if pc.grad.abs().max() > 0 and not name.endswith(".k.bias"))


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


def _tensors(x) -> list:
    """The floating-point tensors in ``x`` (a tensor or a nest of tuples,
    lists and dicts), in order."""
    if isinstance(x, torch.Tensor):
        return [x] if x.is_floating_point() else []
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in _tensors(item)]
    if isinstance(x, dict):
        return [t for item in x.values() for t in _tensors(item)]
    return []


@contextlib.contextmanager
def traced(model, records: list):
    """Record, in call order, into ``records``: each submodule call's tensor
    inputs and outputs (``("forward", name, call, inputs, outputs)``), the
    gradient reaching each of its outputs that needs one (``("backward",
    name[i], call, [], [grad])``), and each ``Tensor.topk``'s sorted indices and
    its margin per row (``("topk", "topk", call, [margin], [indices])``), all
    as f32 copies on the CPU."""
    calls = collections.Counter()
    handles = []

    def cpu(t):  # a copy: a CPU tensor may be a view that the step changes later (a parameter)
        return t.detach().to("cpu", torch.float32, copy=True)

    def forward_hook(name):
        def hook(module, args, kwargs, out):
            k = calls[name]
            calls[name] += 1
            outs = _tensors(out)
            records.append(("forward", name, k, [cpu(a) for a in _tensors((args, kwargs))], [cpu(o) for o in outs]))
            for i, o in enumerate(outs):
                if o.requires_grad:
                    o.register_hook(lambda g, key=f"{name}[{i}]", k=k: records.append(
                        ("backward", key, k, [], [cpu(g)])))
        return hook

    for name, module in model.named_modules():
        if name:
            handles.append(module.register_forward_hook(forward_hook(name), with_kwargs=True))
    topk = torch.Tensor.topk

    def traced_topk(self, k, dim=-1, *args, **kwargs):
        out = topk(self, k, dim, *args, **kwargs)
        if k < self.shape[dim]:
            wider = topk(self, k + 1, dim, *args, **kwargs).values
            margin = wider.narrow(dim, k - 1, 1) - wider.narrow(dim, k, 1)
        else:
            margin = torch.full_like(out.values.narrow(dim, 0, 1), float("inf"))
        n = calls["topk"]
        calls["topk"] += 1
        records.append(("topk", "topk", n, [cpu(margin)], [out.indices.sort(dim).values.cpu()]))
        return out

    torch.Tensor.topk = traced_topk
    try:
        yield records
    finally:
        torch.Tensor.topk = topk
        for h in handles:
            h.remove()


def first_divergence(card: list, cpu: list) -> dict:
    """Read two :func:`traced` records of one step (card, CPU), matched by
    (kind, name, call), differences relative to the CPU tensor's largest
    magnitude: ``forward``, the first module call (in the card's order) whose
    outputs differ by more than ``DIVERGED`` and by more than ``AMPLIFIED``
    times its inputs' difference, as ``(name, call, inputs' difference, each
    output's)``; ``backward``, the first output gradient (in the order the
    card's autograd reached them) that differs by more than ``DIVERGED`` and
    by more than ``AMPLIFIED`` times every gradient reached before it, as
    ``(name, call, difference, the largest before it)``; ``kinks``, for that
    output, the elements whose forward value has another sign on the card
    than on the CPU (where a ReLU after it passes the gradient on one and
    not the other) and the largest magnitude among them on the card,
    ``(count, magnitude)``; ``largest``, the backward's largest difference,
    ``(name, call, difference)``; ``topk``, per ``topk`` call ``(call, rows
    whose index sets differ, the card's smallest margin at those rows, its
    smallest margin at all)``."""
    theirs = {(kind, name, k): (ins, outs) for kind, name, k, ins, outs in cpu}
    out = {"forward": None, "backward": None, "kinks": None, "largest": None, "topk": []}
    forward = {(name, k): outs for kind, name, k, _, outs in card if kind == "forward"}
    before = 0.0  # the largest gradient difference reached so far

    def err(a, b):
        return max((rel_err(x, y) for x, y in zip(a, b) if x.shape == y.shape and x.numel()), default=0.0)

    for kind, name, k, ins, outs in card:
        if (kind, name, k) not in theirs:
            continue
        cins, couts = theirs[(kind, name, k)]
        if kind == "topk":
            rows = (outs[0] != couts[0]).reshape(len(outs[0]), -1).any(dim=1)
            margin = ins[0].reshape(len(ins[0]), -1).min(dim=1).values
            out["topk"].append((k, int(rows.sum()), float(margin[rows].min()) if rows.any() else None,
                                float(margin.min())))
            continue
        if kind == "forward":
            e_outs = [rel_err(x, y) for x, y in zip(outs, couts) if x.shape == y.shape and x.numel()]
            e_in = err(ins, cins)
            if out["forward"] is None and max(e_outs, default=0.0) > max(DIVERGED, AMPLIFIED * max(e_in, 1e-7)):
                out["forward"] = (name, k, e_in, e_outs)
            continue
        e_out = err(outs, couts)
        if out["backward"] is None and e_out > max(DIVERGED, AMPLIFIED * max(before, 1e-7)):
            out["backward"] = (name, k, e_out, before)
            module, i = name.rsplit("[", 1)
            i = int(i[:-1])
            if (module, k) in forward and ("forward", module, k) in theirs:
                mine, yours = forward[(module, k)][i], theirs[("forward", module, k)][1][i]
                flips = (mine > 0) != (yours > 0)
                out["kinks"] = (int(flips.sum()), float(mine[flips].abs().max()) if flips.any() else None)
        if out["largest"] is None or e_out > out["largest"][2]:
            out["largest"] = (name, k, e_out)
        before = max(before, e_out)
    return out


def replay_step(device, seed: int = 0, free: bool = True, trace: bool = False) -> dict:
    """One step of :func:`slice_config` on ``device`` (a card), then on the
    CPU with the card's B5 results replayed (and, with ``free``, once more
    without the replay).  Weights from ``seed``, the batch from seed + 5, the
    step's noise from seed + 6, labels 0, 1, 1, 0.  Returns the states
    (``card``, ``cpu``, ``free``), the steps' outputs (``card_out``,
    ``cpu_out``, ``free_out``), ``readings``: per B5 call, those of the
    module's docstring (``same``, ``cpu``, ``witness``, ``flips``, ``wider``,
    ``inputs``), ``b4``: per B4 call of the card step, its distance from
    the plain version on its own inputs, and, with ``trace``, ``divergence``:
    :func:`first_divergence` of the card step and the replayed CPU step."""
    cfg = slice_config()
    states = {name: trainer.init_state(cfg, seed=seed, device=d)
              for name, d in (("cpu", "cpu"), ("free", "cpu"), ("card", device))}
    for name in ("card", "free"):
        states[name].model.load_state_dict(states["cpu"].model.state_dict())
    batch = trainer.random_views(cfg, seed=seed + 5, device="cpu")
    batch["label"] = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    kernels = (fm.fused_mlp_fwd_kernel, fm.fused_mlp_bwd_kernel)
    plains = (fm.fused_mlp_reference, fm.fused_mlp_bwd_reference)
    ln_kernels = (ln.layer_norm_fwd_kernel, ln.layer_norm_bwd_kernel)
    ln_plains = (ln.layer_norm_reference, ln.layer_norm_bwd_reference)
    recorded, r = [], {k: [] for k in ("same", "cpu", "witness", "flips", "wider", "inputs")}
    b4 = []

    def held_ln(i):
        def call(*args):
            out = ln_kernels[i](*args)
            b4.append(max(rel_err(g, w) for g, w in zip(_flat(out), _flat(ln_plains[i](*args)))))
            return out
        return call

    def recording(i):
        def call(*args):
            out = kernels[i](*args)
            recorded.append((tuple(a.cpu() for a in args), tuple(t.cpu() for t in _flat(out))))
            r["same"].append(max(rel_err(g, w) for g, w in zip(_flat(out), _flat(plains[i](*args)))))
            return out
        return call

    def replayed(i):
        def call(*args):
            turn = next(turns, None)
            if turn is None:
                raise RuntimeError("replay_step: the CPU step made more B5 calls than the card's")
            card_args, got = turn
            want, flips, wider = witness(plains[i], args, card_args)
            r["cpu"].append(max(rel_err(g, w) for g, w in zip(got, _flat(plains[i](*args)))))
            r["witness"].append(max(rel_err(g, w) for g, w in zip(got, _flat(want))))
            r["flips"].append(flips)
            r["wider"].append(wider)
            r["inputs"].append(max(rel_err(a, k) for a, k in zip(args, card_args)))
            return got if i else got[0]
        return call

    traces = {"card": [], "cpu": []}

    def tracing(name):
        return traced(states[name].model, traces[name]) if trace else contextlib.nullcontext()

    fm.fused_mlp_fwd_kernel, fm.fused_mlp_bwd_kernel = recording(0), recording(1)
    ln.layer_norm_fwd_kernel, ln.layer_norm_bwd_kernel = held_ln(0), held_ln(1)
    try:
        with tracing("card"):
            card_out = trainer.make_train_step(cfg)(states["card"], batch,
                                                    torch.Generator(device=device).manual_seed(seed + 4),
                                                    draws=small_draws(cfg.model, device, seed + 6))
    finally:
        fm.fused_mlp_fwd_kernel, fm.fused_mlp_bwd_kernel = kernels
        ln.layer_norm_fwd_kernel, ln.layer_norm_bwd_kernel = ln_kernels
    turns = iter(recorded)
    fm.fused_mlp_reference, fm.fused_mlp_bwd_reference = replayed(0), replayed(1)
    try:
        with tracing("cpu"):
            cpu_out = trainer.make_train_step(cfg)(states["cpu"], batch, torch.Generator(),
                                                   draws=small_draws(cfg.model, "cpu", seed + 6))
    finally:
        fm.fused_mlp_reference, fm.fused_mlp_bwd_reference = plains
    if next(turns, None) is not None or len(r["cpu"]) != len(recorded):
        raise RuntimeError("replay_step: the CPU step made fewer B5 calls than the card's")
    free_out = None
    if free:
        free_out = trainer.make_train_step(cfg)(states["free"], batch, torch.Generator(),
                                                draws=small_draws(cfg.model, "cpu", seed + 6))
    return {**states, "card_out": card_out, "cpu_out": cpu_out, "free_out": free_out, "calls": len(recorded),
            "readings": r, "b4": b4,
            "divergence": first_divergence(traces["card"], traces["cpu"]) if trace else None}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--calls", action="store_true",
                        help="print every B5 call's readings, and trace both steps for where they diverge")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mlp_replay: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"B5 f32 results of a small train step, relative to the plain result's largest magnitude [{card}]")
    worst = {"same": 0.0, "cpu": 0.0, "witness": 0.0, "inputs": 0.0, "b4": 0.0}
    for seed in range(args.seeds):
        r = replay_step("cuda", seed, free=False, trace=args.calls)
        rd, rows = r["readings"], grad_errors(r["card"], r["cpu"])
        print(f"seed {seed}: gradients card vs CPU median {rows[len(rows) // 2][0]:.3e}, worst {rows[-1][0]:.3e} "
              f"({rows[-1][1]}); {r['calls']} B5 calls, largest same {max(rd['same']):.3e}, cpu {max(rd['cpu']):.3e}, "
              f"witness {max(rd['witness']):.3e}, inputs {max(rd['inputs']):.3e}; one-ulp flips {sum(rd['flips'])}, "
              f"wider {sum(rd['wider'])}; loss card {r['card_out']['loss'].item():.7g} cpu "
              f"{r['cpu_out']['loss'].item():.7g}; {len(r['b4'])} B4 calls, largest {max(r['b4']):.3e}", flush=True)
        if args.calls:
            for i in range(r["calls"]):
                print(f"  call {i}: " + ", ".join(f"{k} {v[i]:.3e}" if isinstance(v[i], float) else f"{k} {v[i]}"
                                                  for k, v in rd.items()), flush=True)
            dv = r["divergence"]
            print(f"  first divergence (over {DIVERGED:g} and x{AMPLIFIED:g} what came before): forward (name, call, "
                  f"inputs, each output) {dv['forward']}; backward (name, call, difference, the largest before) "
                  f"{dv['backward']}, its forward values of another sign on the card (count, largest) "
                  f"{dv['kinks']}; the backward's largest {dv['largest']}; topk (call, rows with other index "
                  f"sets, the card's smallest margin there, its smallest margin) {dv['topk']}", flush=True)
        for k in worst:
            worst[k] = max(worst[k], max(r[k] if k == "b4" else rd[k]))
        del r
        torch.cuda.empty_cache()
    print(f"over {args.seeds} seeds: largest " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()
