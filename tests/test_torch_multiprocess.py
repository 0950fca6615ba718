"""The port's sweep grid across processes (``parallel/grid.py``), on the
CPU: the twin of the JAX package's ``tests/test_multiprocess.py``.

Two processes form a ``torch.distributed`` ``gloo`` group over a TCP store
on a free local port and run ``CodeFamily.EvalWER`` and
``CodeFamily_SpaceTime.EvalWER`` with ``shard_across_processes=True``: each
process computes only its round-robin cells (counted by the cell timer),
and the all-gather merge gives every process the single-process grid
exactly.  A grid with a cell that no process computed raises.  Every child
has a timeout and is killed when the test fails.  At world size 1 the
ownership mask and the merge are the identity.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 240

WORKER = r"""
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}",
                        world_size=2, rank={rank})
from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code
from qldpc_fault_tolerance_tpu_torch.decoders import BP_Decoder_Class
from qldpc_fault_tolerance_tpu_torch.parallel import (
    merge_cell_results, process_cell_owner)
from qldpc_fault_tolerance_tpu_torch.sweep import (
    CodeFamily, CodeFamily_SpaceTime)
from qldpc_fault_tolerance_tpu_torch.utils.observability import timings

dec = BP_Decoder_Class(3, "minimum_sum", 0.625, device="cpu")
codes = [hgp(rep_code(3), rep_code(3))]
wer = CodeFamily(codes, dec, dec, batch_size=64, seed=0, device="cpu").EvalWER(
    "data", "Total", [0.02, 0.05, 0.08], 128, if_plot=False,
    shard_across_processes=True)
cells = timings().get("cell:data", {{}}).get("count", 0)
st, _ = CodeFamily_SpaceTime(codes, dec, dec, batch_size=64, seed=0,
                             device="cpu").EvalWER(
    "data", "Total", [0.02, 0.05, 0.08], 128, if_plot=False,
    shard_across_processes=True)
st_cells = timings().get("cell:st-data", {{}}).get("count", 0)
try:
    merge_cell_results(np.full(3, np.nan))
    hole = "merged"
except RuntimeError as e:
    hole = str(e)
print("RESULT" + json.dumps({{
    "wer": wer.tolist(), "cells": cells, "st": [w.tolist() for w in st],
    "st_cells": st_cells, "owned": process_cell_owner(3).tolist(),
    "hole": hole}}), flush=True)
dist.destroy_process_group()
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers():
    port = _free_port()
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER.format(repo=REPO, port=port,
                                             rank=rank)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            assert p.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
            assert line, (out[-2000:], err[-2000:])
            outs.append(json.loads(line[-1][len("RESULT"):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return outs


def _single_process_grids():
    from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code
    from qldpc_fault_tolerance_tpu_torch.decoders import BP_Decoder_Class
    from qldpc_fault_tolerance_tpu_torch.sweep import (
        CodeFamily,
        CodeFamily_SpaceTime,
    )

    dec = BP_Decoder_Class(3, "minimum_sum", 0.625, device="cpu")
    codes = [hgp(rep_code(3), rep_code(3))]
    # the serial loop, which a grid across processes runs
    wer = CodeFamily(codes, dec, dec, batch_size=64, seed=0,
                     device="cpu").EvalWER(
        "data", "Total", [0.02, 0.05, 0.08], 128, if_plot=False,
        fused=False)
    st, _ = CodeFamily_SpaceTime(codes, dec, dec, batch_size=64, seed=0,
                                 device="cpu").EvalWER(
        "data", "Total", [0.02, 0.05, 0.08], 128, if_plot=False,
        fused=False)
    return wer, st


def test_two_process_grid_shard_matches_single_process():
    r0, r1 = _run_workers()
    wer, st = _single_process_grids()
    for r in (r0, r1):
        np.testing.assert_array_equal(np.asarray(r["wer"]), wer)
        np.testing.assert_array_equal(np.asarray(r["st"][0]), st[0])
        assert "no process" in r["hole"]
    # round-robin: rank 0 owns cells 0 and 2, rank 1 cell 1
    assert r0["owned"] == [True, False, True]
    assert r1["owned"] == [False, True, False]
    assert (r0["cells"], r1["cells"]) == (2, 1)
    assert (r0["st_cells"], r1["st_cells"]) == (2, 1)


def test_process_grid_single_process_identity():
    from qldpc_fault_tolerance_tpu_torch.parallel import (
        merge_cell_results,
        process_cell_owner,
    )
    from qldpc_fault_tolerance_tpu_torch.parallel.grid import rank, world_size

    assert (world_size(), rank()) == (1, 0)
    assert process_cell_owner(5).all()
    vals = np.array([1.0, 2.0, 3.0])
    assert merge_cell_results(vals) is vals


def test_code_family_sharded_flag_single_process():
    from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code
    from qldpc_fault_tolerance_tpu_torch.decoders import BP_Decoder_Class
    from qldpc_fault_tolerance_tpu_torch.sweep import CodeFamily

    dec = BP_Decoder_Class(3, "minimum_sum", 0.625, device="cpu")
    fam = CodeFamily([hgp(rep_code(3), rep_code(3))], dec, dec,
                     batch_size=64, seed=0, device="cpu")
    a = fam.EvalWER("data", "Total", [0.03], 128, if_plot=False)
    b = fam.EvalWER("data", "Total", [0.03], 128, if_plot=False,
                    shard_across_processes=True)
    assert a.shape == b.shape == (1, 1)
    assert not np.isnan(b).any() and a[0, 0] == b[0, 0]


@pytest.mark.parametrize("n", [2, 3])
def test_round_robin_owner_covers_every_cell_once(monkeypatch, n):
    from qldpc_fault_tolerance_tpu_torch.parallel import grid

    monkeypatch.setattr(grid, "world_size", lambda: n)
    masks = []
    for me in range(n):
        monkeypatch.setattr(grid, "rank", lambda me=me: me)
        masks.append(grid.process_cell_owner(7))
    assert (np.sum(masks, axis=0) == 1).all()
