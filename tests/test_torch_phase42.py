"""``chip_smoke.py`` phase 42's small plain run against the JAX package,
on the CPU.

Phase 42 runs phase 5's engine (hgp_34_n625, BP-50, p = 0.01) with
``fused_sampler="v2"`` on a 2-entry shot mesh, 2 x 1024 shots under the
key ``MESH42_KEY``, through the plain versions on the CPU beside the card.
The same key and batches through the JAX package's fused v2 engine on a
2-device mesh give the same failures and minimum weight.  Tolerance:
none.
"""
import os
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from qldpc_fault_tolerance_tpu import parallel as jpar
from qldpc_fault_tolerance_tpu.codes import load_code as jload_code
from qldpc_fault_tolerance_tpu.decoders import BPDecoder as JBPDecoder
from qldpc_fault_tolerance_tpu.sim import data_error as jde
from qldpc_fault_tolerance_tpu_torch.codes import load_code
from qldpc_fault_tolerance_tpu_torch.parallel import shot_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


def test_phase42_plain_run_equals_jax_fused_v2():
    code = load_code(str(chip_smoke.CODE))
    batches = chip_smoke.MESH42_SMALL
    sim = chip_smoke.mesh42_sim(code, "cpu", shot_mesh(["cpu"] * 2), 1024,
                                "v2")
    sim.WordErrorRate(2 * batches * 1024, key=chip_smoke.MESH42_KEY)

    jcode = jload_code(str(chip_smoke.CODE))
    p = 0.01
    probs = np.full(jcode.N, 2 * p / 3)
    jsim = jde.CodeSimulator_DataError(
        code=jcode, decoder_x=JBPDecoder(jcode.hz, probs, 50),
        decoder_z=JBPDecoder(jcode.hx, probs, 50),
        pauli_error_probs=[p / 3] * 3, seed=chip_smoke.SEED,
        batch_size=1024, scan_chunk=8, fused_sampler="v2",
        mesh=jpar.shot_mesh(jax.devices()[:2]))
    # the key's two words, as the port's (hi, lo) pair gives them
    jkey = jnp.asarray(np.array(chip_smoke.MESH42_KEY, np.uint32))
    wer_j, _ = jsim.WordErrorRate(2 * batches * 1024, key=jkey)
    failures_j = round((1 - (1 - wer_j) ** jcode.K) * 2 * batches * 1024)
    assert sim.last_shots == 2 * batches * 1024
    assert (sim.last_failures, sim.min_logical_weight) == (
        failures_j, jsim.min_logical_weight)
