"""The kernel build of the PyTorch port (``ops/_kernels.py``) on the CPU:
which sources go into each library's name.  Nothing is compiled here (no
nvcc); the tests work on a temporary copy of ``csrc/``."""
import shutil

import pytest

from qldpc_fault_tolerance_tpu_torch.ops import _kernels


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, copy)
    monkeypatch.setattr(_kernels, "CSRC", copy)
    return copy


def test_every_kernel_source_is_listed_and_its_headers_found(csrc):
    assert sorted(p.stem for p in csrc.glob("*.cu")) == sorted(_kernels.SOURCES)
    names = {n: [p.name for p in _kernels._sources_of(n)]
             for n in _kernels.SOURCES}
    assert names["bp_minsum"] == ["bp_minsum.cu", "minsum_body.cuh"]
    assert set(names["fused_decode"]) == {"fused_decode.cu", "counter_gf2.cuh",
                                          "minsum_body.cuh"}
    assert names["gf2_sample"] == ["gf2_sample.cu", "counter_gf2.cuh"]
    assert names["bp_int8"] == ["bp_int8.cu", "int8_body.cuh"]
    assert set(names["fused_decode_int8"]) == {
        "fused_decode_int8.cu", "counter_gf2.cuh", "int8_body.cuh"}


@pytest.mark.parametrize("header,changed,kept", [
    ("minsum_body.cuh", {"bp_minsum", "fused_decode"},
     {"osd_elim", "gf2_sample", "gf2_residual"}),
    ("counter_gf2.cuh", {"gf2_sample", "gf2_residual", "fused_decode",
                         "fused_decode_int8"},
     {"bp_minsum", "osd_elim"}),
    ("int8_body.cuh", {"bp_int8", "fused_decode_int8"},
     {"fused_decode", "bp_minsum", "cs_sweep"}),
])
def test_target_name_changes_with_an_included_header(csrc, header, changed,
                                                     kept):
    before = {n: _kernels._target(n) for n in _kernels.SOURCES}
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    after = {n: _kernels._target(n) for n in _kernels.SOURCES}
    assert {n for n in before if before[n] != after[n]} == changed
    assert kept.isdisjoint(changed)


def test_nested_includes_are_followed(csrc):
    (csrc / "inner.cuh").write_text("#pragma once\n")
    with open(csrc / "counter_gf2.cuh", "a") as f:
        f.write('\n#include "inner.cuh"\n')
    before = _kernels._target("gf2_sample")
    assert "inner.cuh" in [p.name for p in _kernels._sources_of("gf2_sample")]
    (csrc / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert _kernels._target("gf2_sample") != before
