"""The port's ablation study tool (``edrl_tpu_torch/tools/ablation_study.py``)
against ``scripts/ablation_study.py``.

(a) Each variant's config, as a dict of every field, and the protocol key
equal the script's for the same arguments.  The script runs in a subprocess
(``JAX_PLATFORMS=cpu``), so its compile-cache settings stay out of this
process.  The port's key selects every row of the JAX package's shipped
default table.  (b) A tiny run (the tiny config's model, two variants, one
seed, one epoch) on the CPU writes rows with the JAX rows' keys and renders.
(c) Resume and the report: a second call runs nothing, a row of another
protocol moves to ``.stale`` and runs again, and the parity section
computes the bar and the paired advantage of hand-written rows to the
digits worked out below.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from edrl_tpu_torch import config as tconfig
from edrl_tpu_torch.tools import ablation_study as ab

REPO = Path(__file__).resolve().parents[1]
JAX_TABLE = REPO / "ABLATION_FUSION_DEFAULT.md.jsonl"
SHIPPED = ["--protocol", "fusion", "--epochs", "75", "--warmup_steps", "100", "--train_samples", "256",
           "--val_samples", "128", "--batch_size", "16", "--lr", "3e-5", "--fundus_size", "384", "--oct_size", "96",
           "--sigmas", "0", "0.25", "0.5"]
ARGVS = {"default": [], "warmup": ["--warmup_steps", "100"], "shipped": SHIPPED}

# Runs in a subprocess: the script's parser (its main, stopped right after
# parse_args), then its base_config, variant and protocol_of.
_JAX_SIDE = r"""
import argparse, dataclasses, importlib.util, json, sys
spec = importlib.util.spec_from_file_location("ablation_study", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)

class Parsed(Exception):
    pass

parse = argparse.ArgumentParser.parse_args

def grab(self, args=None, namespace=None):
    raise Parsed(parse(self, args, namespace))

argparse.ArgumentParser.parse_args = grab
out = {}
for key, argv in json.loads(sys.argv[2]).items():
    try:
        mod.main(argv)
    except Parsed as e:
        args = e.args[0]
    args.sigmas = tuple(args.sigmas)
    cfg = mod.base_config(args)
    out[key] = {"args": vars(args), "protocol": mod.protocol_of(args),
                "variants": {n: dataclasses.asdict(mod.variant(cfg, n)) for n in mod.VARIANTS}}
print(json.dumps(out))
"""


def _json(obj):
    return json.loads(json.dumps(obj))


def test_study_imports_nothing_of_jax_or_the_scripts():
    """No line imports JAX, the JAX package or ``scripts/``, and importing the
    study tool loads none of them."""
    source = Path(ab.__file__).read_text()
    assert not re.findall(r"^\s*(?:import|from) (?:jax|edrl_tpu[. ]|scripts)", source, re.M)
    code = ("import sys, edrl_tpu_torch.tools.ablation_study\n"
            "print(sorted({n.split('.')[0] for n in sys.modules} & {'jax', 'jaxlib', 'flax', 'edrl_tpu', 'scripts'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr[-2000:]
    assert ab.build_parser().parse_args([]).device == "cuda"


def test_configs_and_protocol_equal_the_scripts():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(REPO / "scripts" / "ablation_study.py"),
                           json.dumps(ARGVS)], capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    theirs = json.loads(proc.stdout.strip().splitlines()[-1])
    for key, argv in ARGVS.items():
        args = ab.build_parser().parse_args(argv)
        args.sigmas = tuple(args.sigmas)
        cfg = ab.base_config(args)
        assert ab.VARIANTS == tuple(theirs[key]["variants"])
        for name in ab.VARIANTS:
            assert _json(dataclasses.asdict(ab.variant(cfg, name))) == theirs[key]["variants"][name], (key, name)
        assert _json(ab.protocol_of(args)) == theirs[key]["protocol"], key
        # Every setting the configs and the key read has the script's default.
        for field in ("epochs", "train_samples", "val_samples", "batch_size", "lr", "warmup_steps", "fundus_size",
                      "oct_size", "sigmas", "seeds", "scan_batches", "variants", "protocol"):
            assert _json(getattr(args, field)) == theirs[key]["args"][field], (key, field)
    # The shipped command's key is the JAX table's: all 14 rows, 4 + 2 + 2 + 2 + 4.
    args = ab.build_parser().parse_args(SHIPPED)
    rows = ab.read_rows(str(JAX_TABLE), ab.protocol_of(args))
    counts = {n: sum(r["name"] == n for r in rows) for n in ab.VARIANTS}
    assert counts == dict(zip(ab.VARIANTS, (4, 2, 2, 2, 4)))
    # Held against itself, each headline row passes with a zero difference.
    table = ab.parity(rows, rows)
    assert all(table[n]["best_val_acc"]["ok"] and table[n]["best_val_acc"]["diff"] == 0.0 for n in ab.HEADLINE)
    assert table[ab.FULL]["advantage"]["port"][0] == pytest.approx(0.171875, abs=5e-4)  # 0.172 in its analysis


TINY = ["--protocol", "fusion", "--epochs", "1", "--train_samples", "16", "--val_samples", "8", "--batch_size", "4",
        "--fundus_size", "64", "--oct_size", "32", "--sigmas", "0", "0.5", "--seeds", "0", "--device", "cpu",
        "--variants", ab.FULL, "MedFusion -MMD"]


@pytest.fixture
def tiny_study(monkeypatch):
    """The study with the tiny config's model in f32 (the sizes come from
    the arguments); ``calls`` counts the runs it trains."""
    real, calls = ab.base_config, []

    def tiny(args):
        return real(args).replace(model=dataclasses.replace(tconfig.tiny_test_config().model, use_bfloat16=False))

    run = ab.run_variant

    def counted(name, seed, cfg, args, card):
        calls.append((name, seed))
        return run(name, seed, cfg, args, card)

    monkeypatch.setattr(ab, "base_config", tiny)
    monkeypatch.setattr(ab, "run_variant", counted)
    return calls


def test_tiny_run_writes_rows_resumes_and_archives_stale(tiny_study, tmp_path, capsys):
    out = tmp_path / "STUDY.md"
    jsonl = Path(str(out) + ".jsonl")
    argv = TINY + ["--output", str(out)]
    assert ab.main(argv) == 0
    assert tiny_study == [(ab.FULL, 0), ("MedFusion -MMD", 0)]
    lines = jsonl.read_text().splitlines()
    rows = [json.loads(line) for line in lines]
    jax_keys = set(json.loads(JAX_TABLE.read_text().splitlines()[0]))
    for r in rows:
        assert jax_keys <= set(r), jax_keys - set(r)
        assert r["card"] == "cpu" and r["card_processes"] == []
        assert len(r["train_loss_history"]) == len(r["val_acc_history"]) == 1
        assert r["final_train_loss"] == r["train_loss_history"][-1] and r["step_ms"] > 0
        assert r["protocol"] == ab.protocol_of(ab.build_parser().parse_args(argv))
        assert sorted(r["sweep"]) == sorted(ab.MODALITIES)
        assert all(sorted(cells) == ["0.0", "0.5"] and cells["0.0"]["num_samples"] == 8
                   for cells in r["sweep"].values())
        # The eval step is rebuilt per sigma: the low view's noise differs.
        assert r["sweep"]["both"]["0.0"]["loss"] != r["sweep"]["both"]["0.5"]["loss"]
        # No kernel on the CPU: the plain versions run, and count nothing.
        assert r["launches"]["fit"]["forward"] == {"wgmma": 0, "fma": 0}
    md = out.read_text()
    for heading in ("## ACCURACY per cell", "## AUC per cell", "## Per-seed best val accuracy",
                    "## Fusion advantage", "## Paired per seed", "## Runs"):
        assert heading in md, heading
    assert "Parity" not in md

    # A second call runs nothing.
    capsys.readouterr()
    assert ab.main(argv) == 0
    assert len(tiny_study) == 2 and jsonl.read_text().splitlines() == lines
    assert capsys.readouterr().out.count("(cached)") == 2

    # A row of another protocol leaves the live file and is run again.
    other = dict(rows[1], protocol=dict(rows[1]["protocol"], epochs=2))
    jsonl.write_text(lines[0] + "\n" + json.dumps(other) + "\n")
    assert ab.main(argv) == 0
    assert tiny_study[2:] == [("MedFusion -MMD", 0)]
    stale = Path(str(jsonl) + ".stale").read_text().splitlines()
    assert [json.loads(line)["protocol"]["epochs"] for line in stale] == [2]
    live = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [(r["name"], r["protocol"]["epochs"]) for r in live] == [(ab.FULL, 1), ("MedFusion -MMD", 1)]


def _row(name, seed, acc, loss, both, fundus, oct_):
    return {"name": name, "seed": seed, "protocol": {"p": 1}, "best_val_acc": acc, "final_train_loss": loss,
            "train_time_s": 1.0,
            "sweep": {m: {"0.0": {"accuracy": a, "auc": a}} for m, a in
                      (("both", both), ("fundus-only", fundus), ("oct-only", oct_))}}


def test_parity_bar_and_paired_advantage(tmp_path):
    late = ab.LATE
    ref = [_row(ab.FULL, s, a, 1.8, 0.7, 0.5, 0.5) for s, a in enumerate((0.70, 0.74, 0.74, 0.78))]
    ref += [_row(late, s, a, 0.05, 0.6, 0.5, 0.7) for s, a in enumerate((0.70, 0.70, 0.74, 0.74))]
    ref += [_row("MedFusion -MMD", s, 0.74, 1.4, 0.6, 0.5, 0.5) for s in (0, 1)]
    # Full EDRL's advantage per seed: 0.9 - 0.7, 0.8 - 0.7, 1.0 - 0.7, 0.9 - 0.7.
    ours = [_row(ab.FULL, s, a, 1.9, b, 0.6, 0.7)
            for s, a, b in zip(range(4), (0.72, 0.72, 0.76, 0.76), (0.9, 0.8, 1.0, 0.9))]
    ours += [_row(late, s, 0.64, 0.04, 0.7, 0.5, 0.75) for s in range(4)]
    ours += [_row("MedFusion -MMD", s, a, 1.5, 0.6, 0.5, 0.5) for s, a in ((0, 0.70), (1, 0.74))]
    for path, rows in (("ref.jsonl", ref), ("ours.jsonl", ours)):
        (tmp_path / path).write_text("".join(json.dumps(r) + "\n" for r in rows))
    ref, ours = (ab.read_rows(str(tmp_path / p), {"p": 1}) for p in ("ref.jsonl", "ours.jsonl"))
    assert ab.read_rows(str(tmp_path / "ref.jsonl"), {"p": 2}) == []

    table = ab.parity(ours, ref)
    full, lf, mmd = (table[n] for n in (ab.FULL, late, "MedFusion -MMD"))
    # Full EDRL: ref 0.74±0.03266 (var 0.0032/3), port 0.74±0.02309 (var
    # 0.0016/3): limit 2·√(0.0016/12 + 0.0032/12) = 2·√0.0004 = 0.04, Δ 0.
    assert full["best_val_acc"]["ref"] == pytest.approx((0.74, (0.0032 / 3) ** 0.5, 4))
    assert full["best_val_acc"]["port"] == pytest.approx((0.74, (0.0016 / 3) ** 0.5, 4))
    assert full["best_val_acc"]["limit"] == pytest.approx(0.04)
    assert full["best_val_acc"]["diff"] == pytest.approx(0.0, abs=1e-12) and full["best_val_acc"]["ok"]
    # Late fusion: ref 0.72±0.02309, port 0.64±0: limit 2·√(0.0016/12) =
    # 0.023094, Δ -0.08: fails.
    assert lf["best_val_acc"]["limit"] == pytest.approx(0.0230940, abs=1e-7)
    assert lf["best_val_acc"]["diff"] == pytest.approx(-0.08) and lf["best_val_acc"]["ok"] is False
    # Advantage, paired per seed: full 0.2±0.08165 (per seed 0.2, 0.1, 0.3,
    # 0.2), late 0.7 - 0.75 = -0.05: full > 0 and > late's.
    assert full["advantage"]["port"] == pytest.approx((0.2, (0.02 / 3) ** 0.5, 4))
    assert lf["advantage"]["port"] == pytest.approx((-0.05, 0.0, 4), abs=1e-12)
    assert full["advantage"]["ok"] and lf["advantage"]["ok"]
    assert full["final_train_loss"]["diff"] == pytest.approx(0.1)
    # The ablated variant: statistics, no bar.
    assert mmd["best_val_acc"]["port"][2] == 2 and mmd["best_val_acc"]["limit"] is None
    assert mmd["best_val_acc"]["ok"] is None and mmd["advantage"]["ok"] is None

    # Late fusion's advantage above full EDRL's (1.0 - 0.5 = 0.5) fails the bar for both.
    above = [dict(r, sweep={**r["sweep"], "both": {0.0: {"accuracy": 1.0, "auc": 1.0}}}) if r["name"] == late else r
             for r in ours]
    table = ab.parity(above, ref)
    assert table[ab.FULL]["advantage"]["ok"] is False and table[late]["advantage"]["ok"] is False

    md = ab.to_markdown(ours, (0.0,), protocol="fusion", ref_rows=ref, ref_path="ref.jsonl")
    assert "\\|Δ\\| ≤ 0.0400 | pass |" in md and "\\|Δ\\| ≤ 0.0231 | **FAIL** |" in md
    assert "| 0.2000±0.0816 (n=4) |" in md
    assert (f"Outcome: {ab.FULL} best val acc: pass; {ab.FULL} fusion advantage: pass; {late} best val acc: "
            f"**FAIL**; {late} fusion advantage: pass.") in md
    assert "| MedFusion -MMD | best val acc | 0.7400±0.0000 (n=2) | 0.7200±0.0283 (n=2) | -0.0200 | — | — |" in md
    assert "s0:+0.200 s1:+0.100 s2:+0.300 s3:+0.200" in md
