"""The port's preflight verifier and dataset tools against the JAX package's.

Every case of ``tests/test_verify_dataset.py`` runs on the same tree through
``edrl_tpu.data.verify.verify_tree`` (cv2, pandas) and
``edrl_tpu_torch.data.verify.verify_tree`` (the port's readers): the
findings (severity, sample, message), the counts and the summary are equal.
The deep check writes the resize caches, so those the JAX run wrote are
removed before the port's run.  ``tools.verify_dataset`` and
``tools.build_cache`` are held to ``scripts/verify_dataset.py`` and
``scripts/build_cache.py``: the same output and exit codes, and the same
caches.
"""

import os
import shutil
import struct
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from edrl_tpu.config import DataConfig as JaxDataConfig
from edrl_tpu.data.nifti import write_nifti
from edrl_tpu.data.verify import verify_tree as jax_verify_tree
from edrl_tpu_torch.config import DataConfig
from edrl_tpu_torch.data.verify import verify_tree
from edrl_tpu_torch.tools import build_cache, verify_dataset
from test_verify_dataset import _write_png, tree  # noqa: F401 - the JAX tests' tree fixture

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def _kw(root, label_file, **kw):
    return dict(dataset="dr2", data_path=str(root), label_file=str(label_file), fundus_size=64,
                oct_size=(16, 16, 16), **kw)


def _drop_caches(root):
    for p in Path(root).rglob("_edrl_cache8_*.npz"):
        p.unlink()


def _both(kw, **verify_kw):
    """(port report, JAX report) on one tree, each deep check decoding anew."""
    if os.path.isdir(kw["data_path"]):
        _drop_caches(kw["data_path"])
    theirs = jax_verify_tree(JaxDataConfig(**kw), **verify_kw)
    if os.path.isdir(kw["data_path"]):
        _drop_caches(kw["data_path"])
    return verify_tree(DataConfig(**kw), **verify_kw), theirs


def _same(ours, theirs):
    assert [(f.severity, f.sample, f.message) for f in ours.findings] == [
        (f.severity, f.sample, f.message) for f in theirs.findings]
    for name in ("dataset", "n_listed", "n_labeled", "n_joined", "n_checked", "ok"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.summary() == theirs.summary()


def _unlink(path):
    os.unlink(path)


def _scale(path, slope, inter):
    raw = bytearray(path.read_bytes())
    struct.pack_into("<f", raw, 112, slope)
    struct.pack_into("<f", raw, 116, inter)
    path.write_bytes(bytes(raw))


def _halve(path):
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])


def _other_labels(root, labels, tmp_path):
    other = tmp_path / "other_labels.csv"
    pd.DataFrame([{"data": "99999", "class_0": 1, "class_1": 0}]).to_csv(other, index=False)
    return other


def _unlabeled_and_missing(root, labels, tmp_path):
    (root / "77").mkdir()
    df = pd.read_csv(labels, dtype={"data": str})
    pd.concat([df, pd.DataFrame([{"data": "00088", "class_0": 1, "class_1": 0}])]).to_csv(labels, index=False)


def _edit_label_line(index, last_cell):
    def edit(root, labels, tmp_path):
        lines = labels.read_text().splitlines()
        lines[index] = lines[index].rsplit(",", 1)[0] + "," + last_cell
        labels.write_text("\n".join(lines))
    return edit


def _bad_crc(root, labels, tmp_path):
    path = root / "2" / "data_2_fundus.png"
    raw = bytearray(path.read_bytes())
    raw[raw.index(b"IDAT") + 6] ^= 1
    path.write_bytes(bytes(raw))


# name -> (edit of the healthy tree returning another label file or None, verify_tree's arguments)
CASES = {
    "healthy_tree_is_ready": (None, dict(deep=True)),
    "missing_fundus_is_an_error": (lambda r, l, t: _unlink(r / "2" / "data_2_fundus.png"), {}),
    "missing_nifti_names_both_candidates": (lambda r, l, t: _unlink(r / "3" / "data_3.nii"), {}),
    "processed_fallback_accepted": (
        lambda r, l, t: os.rename(r / "3" / "data_3.nii", r / "3" / "processed_data_3.nii"), dict(deep=True)),
    "truncated_nifti_is_an_error": (
        lambda r, l, t: _halve(r / "1" / "data_1.nii"), {}),
    "non_nifti_garbage_is_an_error": (
        lambda r, l, t: (r / "1" / "data_1.nii").write_bytes(b"DICM" + b"\x00" * 400), {}),
    "4d_volume_is_an_error": (
        lambda r, l, t: write_nifti(str(r / "1" / "data_1.nii"),
                                    np.random.default_rng(1).uniform(size=(8, 8, 8, 2)).astype(np.float32) * 255),
        {}),
    "scaled_nifti_is_a_warning_not_error": (lambda r, l, t: _scale(r / "1" / "data_1.nii", 2.5, -10.0), {}),
    "intercept_only_scaling_warns": (lambda r, l, t: _scale(r / "1" / "data_1.nii", 1.0, -1024.0), {}),
    "zero_join_is_an_error_with_examples": (_other_labels, {}),
    "unlabeled_dirs_and_missing_rows_are_warnings": (_unlabeled_and_missing, {}),
    "bad_label_cells_are_reported": (_edit_label_line(1, ""), {}),
    "non_numeric_label_cell_fails_loudly": (_edit_label_line(2, "oops"), {}),
    "deep_check_loads_real_samples": (None, dict(max_samples=2, deep=True)),
    "undecodable_fundus_is_an_error": (_bad_crc, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_tree_equals_jax(tree, tmp_path, case):  # noqa: F811
    root, labels = tree
    edit, verify_kw = CASES[case]
    other = edit(root, labels, tmp_path) if edit else None
    ours, theirs = _both(_kw(root, other or labels), **verify_kw)
    if case == "undecodable_fundus_is_an_error":
        # The one message that carries the decoder's own words: cv2 returns
        # None (JAX raises FileNotFoundError(path)), the port names the CRC.
        (a,), (b,) = ours.errors, theirs.errors
        assert (a.severity, a.sample) == (b.severity, b.sample) == ("error", "2") and not ours.ok
        assert "data_2_fundus.png" in a.message and "bad CRC" in a.message
        return
    _same(ours, theirs)
    assert ours.ok == (case in ("healthy_tree_is_ready", "processed_fallback_accepted", "deep_check_loads_real_samples",
                                "scaled_nifti_is_a_warning_not_error", "intercept_only_scaling_warns",
                                "unlabeled_dirs_and_missing_rows_are_warnings"))


def test_preflight_checks_a_png_without_unfiltering_it(tree, monkeypatch):  # noqa: F811
    """Without ``deep`` the fundus PNGs are checked by ``check_png``: the
    findings are JAX's and no row filter is undone."""
    from edrl_tpu_torch.data import png

    root, labels = tree

    def refuse(*a, **kw):
        raise AssertionError("the preflight unfiltered a PNG")

    monkeypatch.setattr(png, "_unfilter", refuse)
    ours, theirs = _both(_kw(root, labels))
    _same(ours, theirs)
    assert ours.ok and ours.n_checked == theirs.n_checked > 0


def test_missing_paths_short_circuit(tmp_path):
    _same(*_both(_kw(tmp_path / "nope", tmp_path / "nope.csv")))
    (tmp_path / "empty").mkdir()
    ours, theirs = _both(_kw(tmp_path / "empty", tmp_path / "nope.csv"))
    _same(ours, theirs)
    assert any("does not exist" in str(f) for f in ours.errors)


@pytest.mark.parametrize("deep", [False, True])
def test_glu2_layout_checks(tmp_path, rng, deep):
    root = tmp_path / "data"
    for i in (1, 2):
        sid = str(i)
        (root / sid / sid).mkdir(parents=True)
        _write_png(root / sid / f"{sid}.png", rng)
        for s in (1, 2, 10):  # unpadded numeric names
            _write_png(root / sid / sid / f"{s}.jpg", rng, size=(16, 16))
    label_file = tmp_path / "labels.csv"
    pd.DataFrame([{"data": "00001", "class_0": 1, "class_1": 0},
                  {"data": "00002", "class_0": 0, "class_1": 1}]).to_csv(label_file, index=False)
    kw = dict(dataset="glu2", data_path=str(root), label_file=str(label_file), fundus_size=32, oct_size=(8, 8, 8))
    ours, theirs = _both(kw, deep=deep)
    _same(ours, theirs)
    assert ours.ok and any("numeric-aware ordering" in str(f) for f in ours.warnings)
    shutil.rmtree(root / "2" / "2")
    ours, theirs = _both(kw, deep=deep)
    _same(ours, theirs)
    assert any("missing OCT slice directory" in str(f) for f in ours.errors)


def _script(name):
    sys.path.insert(0, str(SCRIPTS))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(SCRIPTS))


def test_verify_dataset_tool_equals_the_script(tree, capsys):  # noqa: F811
    root, labels = tree
    argv = ["--dataset", "dr2", "--data_path", str(root), "--label_file", str(labels), "--fundus_size", "64",
            "--oct_size", "16", "--deep"]
    script = _script("verify_dataset")
    for broken in (False, True):
        if broken:
            os.unlink(root / "1" / "data_1.nii")
        _drop_caches(root)
        rc = script.main(argv)
        theirs = capsys.readouterr().out
        _drop_caches(root)
        assert verify_dataset.main(argv) == rc == int(broken)
        assert capsys.readouterr().out == theirs
    assert "NOT READY" in theirs


def test_build_cache_tool_equals_the_script(tree, tmp_path, capsys):  # noqa: F811
    """``--workers 2`` (spawned processes): the same cache files as the
    script's, the volumes equal and the fundus at the resize bar (the script
    resizes with cv2); a second run finds every sample cached; an empty
    tree exits 1."""
    root, labels = tree
    shutil.copytree(root, tmp_path / "copy")
    argv = ["--label_file", str(labels), "--fundus_size", "64", "--oct_size", "16"]
    assert _script("build_cache").main(["--data_path", str(tmp_path / "copy")] + argv) == 0
    assert build_cache.main(["--data_path", str(root), "--workers", "2"] + argv) == 0
    out = capsys.readouterr().out
    assert "[4/4] cached" in out and "cache build complete: 4 samples" in out
    built = sorted(p.relative_to(root) for p in root.rglob("_edrl_cache8_*"))
    assert built == sorted(p.relative_to(tmp_path / "copy") for p in (tmp_path / "copy").rglob("_edrl_cache8_*"))
    assert len(built) == 4
    for rel in built:
        with np.load(root / rel) as a, np.load(tmp_path / "copy" / rel) as b:
            assert a.files == b.files and np.array_equal(a["oct"], b["oct"])
            diff = np.abs(a["fundus"].astype(np.int16) - b["fundus"])
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    assert build_cache.main(["--data_path", str(root)] + argv) == 0  # every sample a hit
    (tmp_path / "empty").mkdir()
    assert build_cache.main(["--data_path", str(tmp_path / "empty")] + argv) == 1
