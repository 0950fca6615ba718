"""The port's sweep checkpoint and mid-cell resume, on the CPU.

  * ``utils.checkpoint`` (the port's copy of the JAX package's module):
    finished cells and in-cell progress records round-trip, a torn tail is
    skipped, a stale fingerprint restarts the cell, and the JAX package's
    ``SweepCheckpoint`` reads the port's file and the other way round.
  * ``MegabatchDriver.run_keys(start=, carry0=)``: a stream resumed at
    megabatch k folds exactly the tail of the unbroken stream.
  * The data and phenomenological engines' ``WordErrorRate(progress=)``: a
    run killed after k megabatches and rerun from its ``CellProgress``
    gives the unbroken run's failures, shots and min weight, bit for bit;
    ``target_failures`` on a resumed cursor stops where the unbroken run
    stopped.
  * ``CodeFamily.EvalWER(checkpoint=)``: a sweep killed mid-cell and rerun
    gives the unbroken sweep's WER array, bit for bit, and runs no engine
    for the cells it finished.
Tolerance: none (integer counts).
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu.utils import checkpoint as jckpt
from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code, ring_code
from qldpc_fault_tolerance_tpu_torch.decoders import (
    BP_Decoder_Class,
    BPDecoder,
    BPOSD_Decoder_Class,
)
from qldpc_fault_tolerance_tpu_torch.parallel import count_min_driver
from qldpc_fault_tolerance_tpu_torch.parallel.shots import GeneratorInput
from qldpc_fault_tolerance_tpu_torch.sim import (
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
)
from qldpc_fault_tolerance_tpu_torch.sweep import CodeFamily
from qldpc_fault_tolerance_tpu_torch.utils.checkpoint import (
    CellProgress,
    SweepCheckpoint,
)

torch.set_num_threads(1)

KEY = {"code": "c", "noise": "data", "p": 0.01, "cycles": 1}


# ------------------------------------------------------------- checkpoint

def test_cells_and_progress_round_trip(tmp_path):
    path = str(tmp_path / "sub" / "ck.jsonl")
    ck = SweepCheckpoint(path)
    ck.put_progress(KEY, {"batches_done": 4, "failures": 2, "min_w": 3})
    assert ck.get(KEY) is None and KEY not in ck
    assert SweepCheckpoint(path).get_progress(KEY)["batches_done"] == 4
    ck.put(KEY, {"wer": 0.25})
    again = SweepCheckpoint(path)
    assert again.get(KEY) == {"wer": 0.25} and len(again) == 1
    assert again.get_progress(KEY) is None  # the finished cell supersedes
    # keys are canonical: float rounding and order do not matter
    assert again.get(dict(reversed(list(KEY.items())), p=0.01 + 1e-15))


def test_torn_tail_is_skipped_and_the_next_line_starts_fresh(tmp_path):
    path = str(tmp_path / "ck.jsonl")
    SweepCheckpoint(path).put(KEY, {"wer": 0.5})
    with open(path, "a") as f:
        f.write('{"key": {"code": "c"')  # a kill mid-append
    with pytest.warns(UserWarning, match="corrupt checkpoint line"):
        ck = SweepCheckpoint(path)
    other = dict(KEY, p=0.02)
    ck.put(other, {"wer": 0.75})
    with pytest.warns(UserWarning, match="corrupt checkpoint line"):
        again = SweepCheckpoint(path)
    assert again.get(KEY) == {"wer": 0.5} and again.get(other) == {"wer": 0.75}


def test_cell_progress_honours_only_its_fingerprint(tmp_path):
    ck = SweepCheckpoint(str(tmp_path / "ck.jsonl"))
    prog = CellProgress(ck, KEY, every=2)
    fp = {"engine": "e", "key": [0, 1], "batch_size": 64}
    for done in (1, 2, 3):
        prog.save(fp, batches_done=done, failures=done, min_w=9)
    # every=2 keeps saves 1 and 3
    assert CellProgress(ck, KEY).load(fp)["batches_done"] == 3
    with pytest.warns(UserWarning, match="fingerprint does not match"):
        assert CellProgress(ck, KEY).load(dict(fp, batch_size=32)) is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_the_packages_read_each_others_checkpoints(tmp_path, writer):
    path = str(tmp_path / "ck.jsonl")
    w, r = ((SweepCheckpoint, jckpt.SweepCheckpoint) if writer == "port"
            else (jckpt.SweepCheckpoint, SweepCheckpoint))
    ck = w(path)
    ck.put(KEY, {"wer": 0.125, "failures": 3})
    ck.put_progress(dict(KEY, p=0.02), {"batches_done": 8, "failures": 1,
                                        "min_w": 4})
    got = r(path)
    assert got.get(KEY) == {"wer": 0.125, "failures": 3}
    assert got.get_progress(dict(KEY, p=0.02))["batches_done"] == 8


# ------------------------------------------------------------- the driver

def _driver(k_inner=2):
    def stats(gen):
        x = torch.randint(0, 100, (8,), generator=gen, dtype=torch.int32)
        return x.sum(dtype=torch.int32), x.min().to(torch.int32)

    return count_min_driver(stats, 1000, "cpu", k_inner, GeneratorInput("cpu"))


@pytest.mark.parametrize("start", [2, 4, 6])
def test_run_keys_resumed_folds_the_tail_of_the_stream(start):
    full = list(_driver().run_keys((5, 7), 8))
    carry0 = next(c for c, done in full if done == start)
    tail = list(_driver().run_keys((5, 7), 8, start=start, carry0=carry0))
    assert tail == [(c, d) for c, d in full if d > start]


def test_run_keys_refuses_a_start_off_the_megabatch_grid():
    with pytest.raises(ValueError, match="multiple of k_inner"):
        list(_driver().run_keys((5, 7), 8, start=3, carry0=(0, 1000)))


# ------------------------------------------------- the engines mid-cell

class _Killed(Exception):
    pass


class _DyingProgress(CellProgress):
    """Saves its cursor, then dies after ``kill_after`` saves."""

    def __init__(self, checkpoint, key, kill_after):
        super().__init__(checkpoint, key)
        self.kill_after = kill_after

    def save(self, *args, **kwargs):
        super().save(*args, **kwargs)
        if self._saves >= self.kill_after:
            raise _Killed


def _data_sim(seed=3, batch_size=64):
    code = hgp(ring_code(3), ring_code(3))
    probs = np.full(code.N, 0.04)
    return CodeSimulator_DataError(
        code=code, decoder_x=BPDecoder(code.hz, probs, 8, device="cpu"),
        decoder_z=BPDecoder(code.hx, probs, 8, device="cpu"),
        pauli_error_probs=[0.02] * 3, batch_size=batch_size, scan_chunk=2,
        seed=seed, device="cpu")


def _phenom_sim(seed=4):
    code = hgp(rep_code(3), rep_code(3))
    c1 = BP_Decoder_Class(3, "minimum_sum", 0.625, device="cpu")
    c2 = BPOSD_Decoder_Class(3, "minimum_sum", 0.625, "osd_e", 4,
                             device="cpu")
    ext = lambda h: np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])  # noqa: E731
    d1 = [c1.GetDecoder({"h": ext(h), "p_data": 0.03, "p_syndrome": 0.03})
          for h in (code.hz, code.hx)]
    d2 = [c2.GetDecoder({"h": h, "p_data": 0.03}) for h in (code.hz, code.hx)]
    return CodeSimulator_Phenon(
        code=code, decoder1_x=d1[0], decoder1_z=d1[1], decoder2_x=d2[0],
        decoder2_z=d2[1], pauli_error_probs=[0.015] * 3, q=0.03,
        batch_size=64, scan_chunk=2, seed=seed, device="cpu")


def _wer(sim, engine, samples, **kw):
    if engine == "data":
        return sim.WordErrorRate(samples, **kw)
    return sim.WordErrorRate(3, samples, **kw)


@pytest.mark.parametrize("kill_after", [1, 3])
@pytest.mark.parametrize("engine", ["data", "phenom"])
def test_engine_killed_mid_cell_resumes_bit_for_bit(tmp_path, engine,
                                                    kill_after):
    make = _data_sim if engine == "data" else _phenom_sim
    samples = 64 * 2 * 5  # 5 megabatches of 2 batches
    unbroken = make()
    want = _wer(unbroken, engine, samples)
    ck = SweepCheckpoint(str(tmp_path / "ck.jsonl"))
    with pytest.raises(_Killed):
        _wer(make(), engine, samples,
             progress=_DyingProgress(ck, KEY, kill_after))
    state = SweepCheckpoint(ck.path).get_progress(KEY)
    assert state["batches_done"] == 2 * kill_after
    resumed = make()
    got = _wer(resumed, engine, samples,
               progress=CellProgress(SweepCheckpoint(ck.path), KEY))
    assert got == want
    assert (resumed.last_failures, resumed.last_shots,
            resumed.min_logical_weight) == (
        unbroken.last_failures, unbroken.last_shots,
        unbroken.min_logical_weight)
    assert resumed.last_megabatches == 5 - kill_after
    assert 0 < unbroken.last_failures < samples


def test_resumed_cursor_past_the_target_stops_there(tmp_path):
    samples = 64 * 2 * 8
    unbroken = _data_sim(batch_size=64)
    unbroken.WordErrorRate(samples, target_failures=1)
    stop = unbroken.last_shots // 128  # megabatches the run counted
    ck = SweepCheckpoint(str(tmp_path / "ck.jsonl"))
    with pytest.raises(_Killed):
        _data_sim(batch_size=64).WordErrorRate(
            samples, target_failures=1,
            progress=_DyingProgress(ck, KEY, stop))
    resumed = _data_sim(batch_size=64)
    resumed.WordErrorRate(samples, target_failures=1,
                          progress=CellProgress(SweepCheckpoint(ck.path), KEY))
    assert (resumed.last_failures, resumed.last_shots) == (
        unbroken.last_failures, unbroken.last_shots)
    assert resumed.last_megabatches == 0


# ------------------------------------------------------- the sweep layer

class _DyingCheckpoint(SweepCheckpoint):
    """Dies at its ``kill_at``-th progress record (written first)."""

    def __init__(self, path, kill_at):
        super().__init__(path)
        self.kill_at, self.progress_puts = kill_at, 0

    def put_progress(self, key, progress):
        super().put_progress(key, progress)
        self.progress_puts += 1
        if self.progress_puts == self.kill_at:
            raise _Killed


def _family():
    codes = [hgp(rep_code(3), rep_code(3)), hgp(ring_code(3), ring_code(3))]
    return CodeFamily(
        codes, BP_Decoder_Class(3, "minimum_sum", 0.625, device="cpu"),
        BP_Decoder_Class(8, "minimum_sum", 0.625, device="cpu"),
        batch_size=64, seed=11, device="cpu")


def test_sweep_killed_mid_cell_reruns_to_the_unbroken_grid(tmp_path,
                                                           monkeypatch):
    p_list = [0.03, 0.08]
    samples = 64 * 8 * 3  # 3 megabatches a cell (8 batches each)
    want = _family().EvalWER("data", "Total", p_list, samples, if_plot=False,
                             fused=False)
    path = str(tmp_path / "sweep.jsonl")
    # cell 0 finishes (3 progress records), cell 1 dies at its second,
    # after 16 of its 24 batches
    with pytest.raises(_Killed):
        _family().EvalWER("data", "Total", p_list, samples, if_plot=False,
                          checkpoint=_DyingCheckpoint(path, 5), fused=False)
    ck = SweepCheckpoint(path)
    assert len(ck) == 1
    runs = []
    real = CodeFamily._data_wer

    def counting(self, code, eval_p, *a, progress=None, **kw):
        state = progress.checkpoint.get_progress(progress.key) or {}
        runs.append((code.N, eval_p, state.get("batches_done", 0)))
        return real(self, code, eval_p, *a, progress=progress, **kw)

    monkeypatch.setattr(CodeFamily, "_data_wer", counting)
    got = _family().EvalWER("data", "Total", p_list, samples, if_plot=False,
                            checkpoint=ck, fused=False)
    np.testing.assert_array_equal(got, want)
    # cell 0 skipped; cell 1 resumed after two megabatches; cells 2-3 fresh
    assert runs == [(13, 0.08, 16), (18, 0.03, 0), (18, 0.08, 0)]
    assert len(SweepCheckpoint(path)) == 4
    rec = [json.loads(line) for line in open(path)]
    assert sum("record" in r for r in rec) == 4


def test_progress_every_zero_writes_no_progress(tmp_path):
    path = str(tmp_path / "sweep.jsonl")
    _family().EvalWER("data", "Total", [0.05], 128, if_plot=False,
                      checkpoint=SweepCheckpoint(path), progress_every=0)
    lines = [json.loads(line) for line in open(path)]
    assert [("record" in r, "progress" in r) for r in lines] == [
        (True, False)] * 2
    assert os.path.getsize(path) > 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        SweepCheckpoint(path)  # no torn line
