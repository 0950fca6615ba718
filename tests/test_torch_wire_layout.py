"""The JAX package's serve wire codec (``serve/wire.py``) against the
port's packed GF(2) layout (``ops/gf2_packed.py``), on the CPU: the wire's
lane words are the port's ``pack_shots`` words, bit for bit, and the
wire's ``unpack_plane`` inverts them as the port's ``unpack_shots`` does
(the port's serving, ROADMAP queue A item 9, will speak this wire).
Tolerance: none.

The wire codec checks its layout once per process, on its first pack, by
running ~36 small JAX programs.  This module runs that check when it is
imported — in every pytest worker, before any test runs — so that no
test's count of JAX compiles depends on whether an earlier test in its
process happened to send a packed frame (the count that
tests/test_serve_ops.py ``test_traced_request_full_stack_span_tree``
holds at zero depends on it)."""
import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu.serve import wire
from qldpc_fault_tolerance_tpu_torch.ops.gf2_packed import (
    pack_shots,
    unpack_shots,
)

wire.pack_plane(np.zeros((1, 1), np.uint8))  # the codec's one-time check


@pytest.mark.parametrize("b,cols", [(1, 3), (31, 2), (32, 5), (33, 4),
                                    (100, 7)])
def test_wire_words_are_the_ports_packed_words(b, cols):
    rng = np.random.default_rng(100 * b + cols)
    plane = (rng.random((b, cols)) < 0.5).astype(np.uint8)
    words = np.frombuffer(wire.pack_plane(plane), "<u4").reshape(-1, cols)
    ours = pack_shots(torch.from_numpy(plane)).numpy().view(np.uint32)
    assert np.array_equal(words, ours)
    back = wire.unpack_plane(words.astype("<u4").tobytes(), b, cols)
    assert np.array_equal(back, plane)
    assert np.array_equal(
        unpack_shots(torch.from_numpy(ours.view(np.int32)), b).numpy(), plane)
