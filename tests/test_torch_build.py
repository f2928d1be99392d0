"""PyTorch port: the kernel build's cache key.

``ops/_build.py`` names each library after a hash of its ``.cu`` source,
the headers that source includes by a quoted path and the nvcc flags, so a
library built from an older header is never loaded. These tests compute
the key only (no ``nvcc``): it changes when an included header changes,
directly or through another header, and not when an unrelated header does.
"""

import shutil

import pytest

from deepspeed_tpu_torch.ops import _build


def _tree(tmp_path, files):
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    return tmp_path


def test_key_changes_when_an_included_header_changes(tmp_path):
    d = _tree(tmp_path, {"k.cu": '#include "h.cuh"\nint f();\n', "h.cuh": "int g();\n"})
    before = _build.source_key(d / "k.cu")
    assert _build.source_key(d / "k.cu") == before  # deterministic
    (d / "h.cuh").write_text("int g(); // edited\n")
    assert _build.source_key(d / "k.cu") != before


def test_key_follows_nested_includes_and_ignores_other_headers(tmp_path):
    d = _tree(tmp_path, {"k.cu": '#include <cuda_runtime.h>\n  #  include "a.cuh"\n',
                         "a.cuh": '#pragma once\n#include "b.cuh"\n', "b.cuh": "int b;\n",
                         "unused.cuh": "int u;\n"})
    before = _build.source_key(d / "k.cu")
    (d / "unused.cuh").write_text("int u2;\n")
    assert _build.source_key(d / "k.cu") == before
    (d / "b.cuh").write_text("int b2;\n")
    assert _build.source_key(d / "k.cu") != before


def test_key_changes_with_the_source_and_the_flags(tmp_path, monkeypatch):
    d = _tree(tmp_path, {"k.cu": "int f();\n"})
    before = _build.source_key(d / "k.cu")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-DX"])
    assert _build.source_key(d / "k.cu") != before
    monkeypatch.undo()
    (d / "k.cu").write_text("int f(); \n")
    assert _build.source_key(d / "k.cu") != before


def test_a_missing_include_raises(tmp_path):
    d = _tree(tmp_path, {"k.cu": '#include "gone.cuh"\n'})
    with pytest.raises(_build.KernelBuildError, match="gone.cuh"):
        _build.source_key(d / "k.cu")


@pytest.mark.parametrize("stem", ["flash_attention", "paged_attention", "evoformer_attention",
                                  "block_sparse_attention"])
def test_attention_sources_key_on_the_shared_mma_header(tmp_path, stem):
    """The attention sources include ``mma_sm90.cuh``: an edit to a copy of
    it changes the copies' keys, and the other sources' keys stay put."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    keys = {p.name: _build.source_key(p) for p in csrc.glob("*.cu")}
    with open(csrc / "mma_sm90.cuh", "a") as f:
        f.write("// edited\n")
    after = {p.name: _build.source_key(p) for p in csrc.glob("*.cu")}
    assert after[f"{stem}.cu"] != keys[f"{stem}.cu"]
    for other in ("fused_adam.cu", "grouped_matmul.cu"):
        assert after[other] == keys[other]


def test_grouped_matmul_keys_on_the_wgmma_header(tmp_path):
    """``grouped_matmul.cu`` includes ``wgmma_sm90.cuh``: an edit to a copy
    of the header changes the copy's key (and no other source's), and a
    copy without the header raises ``KernelBuildError`` naming it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    keys = {p.name: _build.source_key(p) for p in csrc.glob("*.cu")}
    with open(csrc / "wgmma_sm90.cuh", "a") as f:
        f.write("// edited\n")
    after = {p.name: _build.source_key(p) for p in csrc.glob("*.cu")}
    assert after["grouped_matmul.cu"] != keys["grouped_matmul.cu"]
    assert {k: v for k, v in after.items() if k != "grouped_matmul.cu"} == \
        {k: v for k, v in keys.items() if k != "grouped_matmul.cu"}
    (csrc / "wgmma_sm90.cuh").unlink()
    with pytest.raises(_build.KernelBuildError, match="wgmma_sm90.cuh"):
        _build.source_key(csrc / "grouped_matmul.cu")


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(_build.CSRC).parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, path.parent


_CS, _ROOT = _chip_smoke()


@pytest.mark.parametrize("name", [f"mutant:{k}" for k in _CS.MUTANTS]
                         + [f"ablation:{k}" for k in _CS.ABLATIONS])
def test_chip_smoke_patches_apply_once(name):
    """``chip_smoke.py --mutant`` / ``--ablation`` patch copies of the
    kernel sources by exact text: every text they replace occurs exactly
    once in its file of the current tree, so no patch silently misses or
    hits two kernels."""
    kind, key = name.split(":")
    patches = _CS.MUTANTS[key][0] if kind == "mutant" else _CS.ABLATIONS[key]
    assert patches
    texts = {}
    for path, old, new in patches:
        text = texts.setdefault(path, (_ROOT / path).read_text())
        assert text.count(old) == 1, (path, old)
        assert old != new
        texts[path] = text.replace(old, new)
