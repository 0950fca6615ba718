"""PyTorch/CUDA port of qldpc_fault_tolerance_tpu.

Quantum LDPC codes under code-capacity, phenomenological and circuit-level
noise (the batch engines, their space-time windows and stream drivers),
decoded by min-sum BP, FirstMin BP and BP + ordered-statistics decoding
(OSD-E and OSD-CS); threshold sweeps with fused cells and checkpoints,
rare-event estimation, a shot mesh over several cards and grids across
processes; and decode-as-a-service (``serve/``: sessions of captured CUDA
graphs per shape bucket, a continuous batcher, a TCP server and client, an
ops plane).  The port imports torch and numpy only.  Every TPU kernel of the
JAX package has a hand-written Hopper counterpart under ``csrc/``, built
with nvcc at first use.  Entry points run on ``device="cuda"`` unless the
caller passes ``device="cpu"``.
"""

__all__ = ["reset_device_state"]


def reset_device_state() -> None:
    """The port's form of a worker restart: drop the per-H decoder memos
    (``decoders.bp_decoders._PER_H``: Tanner graphs, BP heads, OSD plans)
    and the in-process cache of captured CUDA graphs
    (``utils.progcache.clear_memory``), then bump the device-reset epoch
    that ``serve.ops.HealthProbe`` watches, so sessions rebuild their state
    and recapture their graphs.

    A real CUDA context cannot be restarted inside a process: after a
    sticky CUDA error every later call fails, and only a new process
    recovers (``utils.resilience.classify_error`` calls such errors
    deterministic).  Objects that still hold a graph (a session, until it
    swaps in its recaptured programs) keep the tensors that graph reads
    alive, and memos of tables that do not depend on H stay, since a live
    graph may read them."""
    from .decoders import bp_decoders
    from .utils import progcache, resilience

    bp_decoders._PER_H.clear()
    progcache.clear_memory()
    # the epoch moves last: a heal against half-cleared memos would
    # memoize the old state again
    resilience.note_device_reset()
