"""Decoder objects and factory classes.

  * ``BPDecoder`` / ``BPOSD_Decoder`` / ``FirstMinBPDecoder`` — the
    reference decoders' constructor signatures and ``.decode(synd) ->
    correction`` / ``.h`` contract, batched: ``decode_batch`` (host arrays
    in and out) and ``decode_batch_device`` (tensors in, tensors out) for
    the simulators.
  * ``ST_BP_Decoder_syndrome`` — the phenomenological space-time window
    decoder: BP over the block-bidiagonal ``GetSpaceTimeCheckMat``, its
    per-slice data corrections XOR-folded.
  * ``ST_BP_Decoder_Circuit`` / ``ST_BPOSD_Decoder_Circuit`` — BP and
    BP+OSD over a detector error model's fault matrix with its per-column
    priors (the circuit-level space-time engine's decoders).
  * ``DecoderClass`` factories — the ``GetDecoder(params)`` dict contract
    (keys 'h', 'p_data', optionally 'p_syndrome'; 'num_rep' for the
    space-time class; 'h', 'code_h', 'channel_probs' for the circuit
    space-time classes).

A decoder splits into ``device_static`` (a hashable description of the
program) and ``device_state`` (a dict of tensors), run by ``decode_device``.
Decoders live on one device, ``"cuda"`` unless the caller passes another.
What depends on H alone (the Tanner graph, the BP head, OSD's rank and
packed rows) is built once per matrix and device (``_per_h``, a small
bounded memo), so decoders of one H share those objects; the factories'
``GetDecoderState`` gives a decoder's (static, state) pair without
building it, its only new leaves the p-dependent priors (the fused
sweep's per-cell payload, ``sweep/fused.py``).

A min-sum ``BPDecoder`` carries a BP head (the JAX package's vocabulary):
``bp_kernel`` / ``QLDPC_BP_KERNEL`` ``"v2"`` (default) and ``"xla"`` decode
with float32 min-sum (kernel 1); ``"v1"`` runs the two-phase head and tail
in the dense one-hot head (kernel B9); ``quantize="int8"`` in int8 min-sum
(kernel B6).  The head's tag is the last slot of the BP static and its
tensors ride in ``device_state["pallas"]``.
"""
from __future__ import annotations

import os
from abc import ABC, abstractmethod

import numpy as np
import torch

from ..codes import gf2
from ..ops import _kernels, bp, bp_kernel, osd_cs_device, osd_device
from ..utils import telemetry
from ..utils.device import device_cond, host_value, resolve_device
from .osd import (
    DEVICE_METHODS,
    METHODS,
    _channel_cost,
    _check_osd_order,
    osd_postprocess,
)

__all__ = [
    "osd_compaction_tiers",
    "decode_device",
    "kernel_variant",
    "device_syndrome_width",
    "state_from_jax",
    "FusedBPPair",
    "BPDecoder",
    "BPOSD_Decoder",
    "FirstMinBPDecoder",
    "GetSpaceTimeCheckMat",
    "ST_BP_Decoder_syndrome",
    "ST_BP_Decoder_Circuit",
    "ST_BPOSD_Decoder_Circuit",
    "DecoderClass",
    "BP_Decoder_Class",
    "BPOSD_Decoder_Class",
    "FirstMinBP_Decoder_Class",
    "ST_BP_Decoder_Class",
    "ST_BP_Decoder_Circuit_Class",
    "ST_BPOSD_Decoder_Circuit_Class",
]

_BP_METHOD_ALIASES = {
    "minimum_sum": "minimum_sum",
    "min_sum": "minimum_sum",
    "ms": "minimum_sum",
    "msl": "minimum_sum",
    "product_sum": "product_sum",
    "ps": "product_sum",
    "psl": "product_sum",
}


def _norm_method(bp_method: str) -> str:
    return _BP_METHOD_ALIASES[str(bp_method).lower()]


def osd_compaction_tiers(batch_size: int) -> tuple:
    """Straggler-compaction capacities a ``bposd_dev`` decode of this batch
    size uses, ascending (empty for batches too small to compact)."""
    B = int(batch_size)
    return tuple(c for c in dict.fromkeys((max(B // 16, 128),
                                           max(B // 4, 128)))
                 if c < B and c % 128 == 0)


def _osd(static, state, syndromes, posterior):
    _, _bp_static, n, rank, osd_order, elim, method = static
    if method == "osd_cs":
        decode = osd_cs_device.osd_cs_decode_values
        cfg = (n, rank, osd_order,
               osd_cs_device.cs_pat_chunk(n, rank, osd_order), elim)
    else:
        decode = osd_device.osd_decode_values
        cfg = (n, rank, osd_order, 256, elim)
    return decode(cfg, state["osd_packed"], state["osd_cost"], syndromes,
                  posterior, device=syndromes.device)


def decode_device(static, state, syndromes):
    """Decode a (B, m) uint8 syndrome tensor with the program ``static``
    over the tensors ``state``.  Returns ``(corrections (B, n) uint8,
    aux)`` with aux holding ``converged``, ``posterior_llr`` and
    ``iterations``.

    ``"bposd_dev"`` (``("bposd_dev", bp_static, n, rank, order, elim,
    method)``, ``method`` ``"osd_e"`` or ``"osd_cs"``) runs OSD on the
    BP-failed shots only, gathered into a
    fixed-capacity sub-batch (tiers at B/16 and B/4, then the full batch).
    On the CPU results never depend on the tier; on the card the OSD
    scoring's float32 sums run at the tier's sub-batch size, and a cost
    tie may break otherwise at another size, so the batch's failure count
    can change a failed shot's answer.  The tiers are ``device_cond``s, as
    the JAX package's ``lax.cond``s: conditional nodes during a CUDA-graph
    capture, elsewhere chosen on the host from one read of the failure
    count, counted in ``decode_device.host_reads``.

    ``"firstmin"`` (``("firstmin", max_restarts, ms_scaling_factor)``) runs
    ``bp.first_min_bp_decode``; its aux holds ``final_weight``.

    ``"st_syndrome"`` (``("st_syndrome", num_rep, m, n, inner_static)``)
    decodes (B, num_rep, m) detector histories with the inner program over
    the space-time matrix and returns the XOR of the num_rep slices' data
    corrections, (B, n)."""
    kind = static[0]
    if kind == "st_syndrome":
        _, num_rep, m, n, inner = static
        b = syndromes.shape[0]
        corr, aux = decode_device(inner, state,
                                  syndromes.reshape(b, num_rep * m))
        data = corr.reshape(b, num_rep, n + m)[:, :, :n]
        return (data.sum(dim=1, dtype=torch.int32) & 1).to(torch.uint8), aux
    if kind == "firstmin":
        _, max_restarts, msf = static
        corr, w = bp.first_min_bp_decode(
            state["graph"], syndromes, state["llr0"],
            max_restarts=max_restarts, ms_scaling_factor=msf,
            device=syndromes.device)
        return corr, {"final_weight": w}
    if kind == "bposd_dev":
        err, aux = decode_device(static[1], state, syndromes)
        B = syndromes.shape[0]
        conv = aux["converged"]
        bad = ~conv

        def full():
            osd_err = _osd(static, state, syndromes, aux["posterior_llr"])
            return torch.where(conv[:, None], err, osd_err)

        def none():
            return err

        if B < 64:
            return device_cond(host_value(bad.any(), decode_device) != 0,
                               full, none), aux

        def compacted(cap):
            def run():
                # pad with an out-of-range sentinel (B): padded rows decode
                # shot B-1 again and their results land in a scratch row
                idx = torch.nonzero_static(bad, size=cap,
                                           fill_value=B).flatten()
                idx_c = idx.clamp(max=B - 1)
                sub = _osd(static, state, syndromes[idx_c],
                           aux["posterior_llr"][idx_c])
                out = torch.cat([err, err.new_zeros((1, err.shape[1]))])
                out[idx] = sub
                return out[:B]
            return run

        n_bad = host_value(bad.sum(dtype=torch.int32), decode_device)
        out = full
        for cap in reversed(osd_compaction_tiers(B)):
            out = (lambda cap, nxt: lambda: device_cond(
                n_bad <= cap, compacted(cap), nxt))(cap, out)
        return device_cond(n_bad == 0, none, out), aux
    if kind != "bp":
        raise ValueError(f"unknown decoder kind {kind!r}")
    # head_tag: "none" (float32 min-sum), "v2" / "v1" (the bf16 head),
    # "v2_int8" (int8 min-sum); the head's tensors in state["pallas"]
    _, max_iter, method, msf, two_phase, head_tag = static
    if (two_phase and syndromes.shape[0] >= bp.TWO_PHASE_MIN_BATCH
            and max_iter >= bp.TWO_PHASE_MIN_ITER):
        res = bp.bp_decode_two_phase(
            state["graph"], syndromes, state["llr0"], max_iter=max_iter,
            method=method, ms_scaling_factor=msf, head=state.get("pallas"),
            quantize="int8" if head_tag == "v2_int8" else None,
            device=syndromes.device)
    else:
        res = bp.bp_decode(
            state["graph"], syndromes, state["llr0"], max_iter=max_iter,
            method=method, ms_scaling_factor=msf, device=syndromes.device)
    return res.error, {"converged": res.converged,
                       "posterior_llr": res.posterior_llr,
                       "iterations": res.iterations}


decode_device.host_reads = 0


def _head_engages(static, state, batch_size: int) -> bool:
    """Whether a "bp" decode of ``batch_size`` shots runs its head in the
    head kernel (the gates of ``decode_device`` and
    ``bp.bp_decode_two_phase``)."""
    _, max_iter, method, _msf, two_phase, _tag = static
    return (two_phase and batch_size >= bp.TWO_PHASE_MIN_BATCH
            and max_iter >= bp.TWO_PHASE_MIN_ITER
            and bp.head_engages(state.get("pallas"), batch_size, method,
                                state["llr0"]))


def kernel_variant(static, state, batch_size: int | None = None) -> str:
    """Which BP program a decode with this (static, state) pair runs, in
    ``bp_kernel.KERNEL_VARIANTS`` — the JAX package's names for the programs
    whose results it gives: ``sparse_gather`` for an engaged v2 head and
    ``dense_onehot`` for an engaged v1 head (the port runs one bf16 gather
    kernel for both tags), ``sparse_int8`` for int8; ``xla_twin`` for every
    exact-float32 decode (kernel 1) and every plain-version decode (CPU
    tensors, ``force_plain()``), and for decoders without a BP stage
    (``"firstmin"``).  With ``batch_size`` the head's per-batch gates apply
    too (a head that does not engage leaves float32 min-sum)."""
    kind = static[0]
    if kind == "bposd_dev":
        return kernel_variant(static[1], state, batch_size)
    if kind == "st_syndrome":
        return kernel_variant(static[4], state, batch_size)
    if kind != "bp" or static[2] != "minimum_sum":
        return "xla_twin"
    if not state["llr0"].is_cuda or _kernels.plain_forced():
        return "xla_twin"
    names = {"v2": "sparse_gather", "v1": "dense_onehot",
             "v2_int8": "sparse_int8"}
    head_tag = static[5]
    if head_tag not in names or (
            batch_size is not None
            and not _head_engages(static, state, batch_size)):
        return "xla_twin"
    return names[head_tag]


def device_syndrome_width(static, state) -> int:
    """Columns of the syndrome batch a ``decode_device`` program with this
    (static, state) pair consumes (what a serve session sizes its request
    buckets by): ``num_rep * m`` for the space-time wrapper, else the
    Tanner graph's check count."""
    if static[0] == "st_syndrome":
        _, num_rep, m, _n, _inner = static
        return int(num_rep) * int(m)
    return int(state["graph"].chk_mask.shape[0])


def _make_head(bp_method: str, graph_host, quantize=None,
               kernel: str | None = None, device="cuda"):
    """The decoder's BP head, ``(head, head_tag)``, by the JAX package's
    rules (``_maybe_pallas_head``), a CUDA ``device`` standing for its TPU:
    ``kernel`` (default env ``QLDPC_BP_KERNEL``, "v2") is "v1", "v2" or
    "xla".  int8 needs min-sum and not v1 and builds its head on any device
    (raising when the head fails its size gate); on the card "v2" builds a
    SparseHeadGraph when it passes its size gate, else (and for "v1") a
    PallasHeadGraph when that passes its own; otherwise, and on the CPU, no
    head."""
    if bp_method != "minimum_sum" or os.environ.get("QLDPC_PALLAS", "1") == "0":
        if quantize:
            raise ValueError(
                "quantize='int8' needs the min-sum v2 head (QLDPC_PALLAS=0 "
                "or a non-min-sum method disables it)")
        return None, "none"
    kernel = kernel or os.environ.get("QLDPC_BP_KERNEL", "v2")
    if kernel not in ("v1", "v2", "xla"):
        raise ValueError(f"unknown QLDPC_BP_KERNEL {kernel!r}")
    if quantize:
        if kernel == "v1":
            raise ValueError("quantize='int8' requires the v2 kernel")
        head = bp_kernel.build_sparse_head(graph_host, device)
        if not head.fits_vmem():
            raise ValueError(
                f"quantize='int8' head infeasible for this shape "
                f"(fixed VMEM overhead {head.fixed_overhead_bytes})")
        return head, "v2_int8"
    if kernel == "xla" or torch.device(device).type != "cuda":
        return None, "none"
    if kernel == "v2":
        head = bp_kernel.build_sparse_head(graph_host, device)
        if head.fits_vmem():
            return head, "v2"
    head = bp_kernel.build_pallas_head(graph_host, device)
    return (head, "v1") if head.fits_vmem() else (None, "none")


def _head_from_jax(head, dev):
    """A JAX head (SparseHeadGraph or PallasHeadGraph, numpy leaves) as the
    port's, or None."""
    if head is None:
        return None
    if hasattr(head, "scat"):
        scat = np.asarray(head.scat, np.float32)
        mask = np.asarray(head.mask, np.float32)
        chk_idx = scat.argmax(axis=2).astype(np.int32) * (mask > 0)
        return bp_kernel.pallas_head_from_planes(chk_idx, mask,
                                                 scat.shape[2], dev)
    return bp_kernel.sparse_head_from_planes(
        np.asarray(head.chk_idx), np.asarray(head.mask),
        np.asarray(head.nvar).shape[1], dev)


def state_from_jax(jax_state, device="cuda") -> dict:
    """The port's decoder state from a JAX decoder's ``device_state`` given
    as numpy arrays: the Tanner graph fields, ``llr0``, the BP head
    (``"pallas"``: a SparseHeadGraph, or a PallasHeadGraph whose index
    planes are read off JAX's one-hot stack; None for a FirstMin decoder,
    whose state is its graph and ``llr0`` alone) and, for BPOSD,
    ``osd_packed`` (uint32 words read as int32 bit patterns) and
    ``osd_cost``."""
    dev = resolve_device(device)
    fields = jax_state["graph"]._asdict()
    graph = bp.graph_to(bp.TannerGraph(
        **{k: np.asarray(fields[k]) for k in bp.TannerGraph._fields}), dev)
    state = {"graph": graph,
             "llr0": torch.from_numpy(
                 np.array(jax_state["llr0"], np.float32)).to(dev),
             "pallas": _head_from_jax(jax_state.get("pallas"), dev)}
    if "osd_packed" in jax_state:
        packed = np.array(jax_state["osd_packed"], np.uint32).view(np.int32)
        state["osd_packed"] = torch.from_numpy(packed).to(dev)
        state["osd_cost"] = torch.from_numpy(
            np.array(jax_state["osd_cost"], np.float32)).to(dev)
    return state


# (H's bytes and shape, device, the head's settings) -> the per-H build;
# thread-safe: serving threads build decoder states at once (a fleet's
# hosts, a heal beside a new session)
_PER_H = bp._LruCache(maxsize=16)


def _memo(key, build):
    return _PER_H.get(key, build)


def _h_key(h01) -> tuple:
    return (h01.shape, h01.tobytes())


def _per_h(h01, device, bp_method, quantize=None, kernel=None):
    """``(graph, head, head_tag)`` of H on ``device``, built once (the
    head's rules: ``_make_head``, the environment read now)."""
    kernel = kernel or os.environ.get("QLDPC_BP_KERNEL", "v2")
    key = ("bp", _h_key(h01), str(device), bp_method, quantize, kernel,
           os.environ.get("QLDPC_PALLAS", "1"))

    def build():
        graph_host = bp.build_tanner_graph_host(h01)
        head, tag = _make_head(bp_method, graph_host, quantize=quantize,
                               kernel=kernel, device=device)
        return bp.graph_to(graph_host, device), head, tag

    return _memo(key, build)


def _osd_plan(h01, channel_probs, device):
    """The OSD plan of H with these priors' costs: rank and packed rows
    built once per H (``_per_h``'s memo), the costs per call."""
    base = _memo(("osd", _h_key(h01), str(device)),
                 lambda: osd_device.build_osd_plan(
                     h01, np.full(h01.shape[1], 0.5), device=device))
    return base.with_cost(_channel_cost(channel_probs))


class FusedBPPair:
    """Two independent plain-BP decodes in one decode (the JAX package's
    ``FusedBPPair``): the block-diagonal Tanner graph of ``dec_a.h`` and
    ``dec_b.h`` decoded with per-sector convergence and freeze
    (``ops/bp.py`` ``bp_decode_two_phase(sectors=)``, on the card kernel
    1's sector mode), so results equal running the two decoders separately
    while one launch decodes both sectors of every shot.  The data engine
    fuses its X and Z decodes with it (``fuse_sectors``).

    ``compatible`` is the JAX package's test (two plain two-phase
    ``BPDecoder``s with equal settings) on one device, and it also refuses
    a decoder that carries a BP head: the head is refused under sectors,
    so a fused decode is float32 min-sum, and a decoder whose decodes run
    in a bf16 or int8 head would give other results alone."""

    @staticmethod
    def compatible(dec_a, dec_b) -> bool:
        return (
            type(dec_a) is BPDecoder and type(dec_b) is BPDecoder
            and dec_a.max_iter == dec_b.max_iter
            and dec_a.bp_method == dec_b.bp_method
            and dec_a.ms_scaling_factor == dec_b.ms_scaling_factor
            and dec_a.two_phase and dec_b.two_phase
            and dec_a.device == dec_b.device
            and dec_a._head is None and dec_b._head is None
        )

    def __init__(self, dec_a, dec_b):
        ha, hb = dec_a._h01, dec_b._h01
        (ma, na), (mb, nb) = ha.shape, hb.shape
        h = np.zeros((ma + mb, na + nb), dtype=np.uint8)
        h[:ma, :na] = ha
        h[ma:, na:] = hb
        self.device = dec_a.device
        self.graph = bp.build_tanner_graph(h, self.device)
        self.sectors = ((ma, mb), (na, nb))
        # read the graph's layout once here, not in a captured decode
        bp_kernel.check_sectors(self.graph, self.sectors)
        self._split = na
        self.llr0 = torch.cat([dec_a.llr0, dec_b.llr0])
        self.max_iter = dec_a.max_iter
        self.bp_method = dec_a.bp_method
        self.ms_scaling_factor = dec_a.ms_scaling_factor

    def decode_pair_device(self, synd_a, synd_b):
        """(B, ma), (B, mb) uint8 tensors -> corrections (B, na), (B, nb)."""
        synd = torch.cat([synd_a.to(self.device, torch.uint8),
                          synd_b.to(self.device, torch.uint8)], dim=-1)
        res = bp.bp_decode_two_phase(
            self.graph, synd, self.llr0, max_iter=self.max_iter,
            method=self.bp_method, ms_scaling_factor=self.ms_scaling_factor,
            sectors=self.sectors, device=self.device)
        return res.error[:, :self._split], res.error[:, self._split:]


class BPDecoder:
    """Plain BP decoder (reference BPDecoder).  ``quantize="int8"`` decodes
    with int8 min-sum messages (the JAX package's int8 serving and
    ``BENCH_QUANT`` decoders: WER within ``bp_kernel.int8_parity_tolerance``
    of float32, not bit-exact); ``bp_kernel`` (default env
    ``QLDPC_BP_KERNEL``) picks the BP head (module docstring)."""

    # OSD (if any) runs on the device: no host stage after decode_device
    needs_host_postprocess = False

    def __init__(self, h, channel_probs, max_iter, bp_method="minimum_sum",
                 ms_scaling_factor=0.625, two_phase: bool = True,
                 quantize: str | None = None, bp_kernel: str | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.h = np.asarray(h)
        self._h01 = gf2.to_gf2(h)
        self.channel_probs = np.broadcast_to(
            np.asarray(channel_probs, np.float64), (self._h01.shape[1],)
        ).copy()
        # the reference factories pass float max_iter (num_qubits/ratio)
        self.max_iter = max(1, int(max_iter))
        self.bp_method = _norm_method(bp_method)
        self.ms_scaling_factor = float(ms_scaling_factor)
        # straggler compaction (ops/bp.bp_decode_two_phase): identical
        # results, fewer shot-iterations at low p
        self.two_phase = bool(two_phase)
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.quantize = quantize
        self.llr0 = bp.llr_from_probs(self.channel_probs, self.device)
        self.graph, self._head, self._head_tag = _per_h(
            self._h01, self.device, self.bp_method, quantize=quantize,
            kernel=bp_kernel)

    @property
    def device_static(self):
        return ("bp", self.max_iter, self.bp_method,
                float(self.ms_scaling_factor), self.two_phase, self._head_tag)

    @property
    def device_state(self):
        return {"graph": self.graph, "llr0": self.llr0, "pallas": self._head}

    @property
    def kernel_variant(self) -> str:
        """Which BP program this decoder's decodes run (``kernel_variant``,
        the JAX package's name for it)."""
        return kernel_variant(self.device_static, self.device_state)

    def decode_batch_device(self, syndromes):
        """(B, m) uint8 tensor -> (corrections (B, n) uint8, aux dict)."""
        return decode_device(self.device_static, self.device_state,
                             syndromes.to(self.device, torch.uint8))

    def bp_batch_device(self, syndromes) -> bp.BPResult:
        """This decoder's BP stage alone on a (B, m) uint8 tensor, as
        ``decode_device`` runs it (two-phase where it engages): the
        ``BPResult`` with posteriors and iterations."""
        err, aux = decode_device(BPDecoder.device_static.fget(self),
                                 BPDecoder.device_state.fget(self),
                                 syndromes.to(self.device, torch.uint8))
        return bp.BPResult(err, aux["converged"], aux["posterior_llr"],
                           aux["iterations"])

    def host_postprocess(self, syndromes, corrections, aux):
        """No host stage for plain BP: the corrections as they are."""
        return corrections

    def decode_batch(self, syndromes) -> np.ndarray:
        synd = torch.from_numpy(np.atleast_2d(np.asarray(syndromes, np.uint8)))
        res = self.bp_batch_device(synd)
        telemetry.record_bp_aux({"converged": res.converged,
                                 "iterations": res.iterations})
        return res.error.cpu().numpy()

    def decode(self, synd):
        """Reference-compatible single-shot decode."""
        return self.decode_batch(np.atleast_2d(synd))[0]


class BPOSD_Decoder(BPDecoder):
    """BP + OSD (reference BPOSD_Decoder): BP for the whole batch, then OSD
    on the shots BP failed.

    ``device_osd`` (default True) picks where OSD runs.  On, it runs on
    the device inside ``decode_device``: OSD-0/OSD-E
    (``ops/osd_device.py``) or, for ``osd_method="osd_cs"``, the
    combination sweep (``ops/osd_cs_device.py``); the elimination route is
    read from ``QLDPC_OSD_ELIM`` at construction (``"pallas"``, the
    default, or ``"pallas_percol"``).  Off, ``decode_device`` runs BP only
    and OSD runs on the host in C++ (``decoders/osd.py``,
    ``needs_host_postprocess``): an engine then takes its host-assisted
    path.  Both implement the same semantics; the device scores costs in
    float32, the host in float64, so only float-tied candidates may
    differ.  The argument is the one way to choose the host: unlike the
    JAX package, no environment variable switches it, and a fault of the
    device decode raises instead of stepping to the host (ROADMAP §C)."""

    def __init__(self, h, channel_probs, max_iter, bp_method="minimum_sum",
                 ms_scaling_factor=0.625, osd_method="osd_e", osd_order=10,
                 device_osd: bool = True, *, device="cuda"):
        super().__init__(h, channel_probs, max_iter, bp_method,
                         ms_scaling_factor, device=device)
        self.osd_method = str(osd_method)
        if self.osd_method not in METHODS:
            raise NotImplementedError(
                f"OSD implements OSD-0/OSD-E/OSD-CS only, not "
                f"{self.osd_method!r}")
        self.osd_order = _check_osd_order(osd_order)
        self.device_osd = _check_device_osd(device_osd, self.osd_method)
        self.osd_elim = osd_device.elim_route()
        self._osd_plan = (_osd_plan(self._h01, self.channel_probs,
                                    self.device)
                          if self.device_osd else None)

    @property
    def needs_host_postprocess(self) -> bool:
        return not self.device_osd

    @property
    def device_static(self):
        bp_static = super().device_static
        if not self.device_osd:
            return bp_static
        order = 0 if METHODS[self.osd_method] == 0 else self.osd_order
        method = "osd_cs" if self.osd_method == "osd_cs" else "osd_e"
        return ("bposd_dev", bp_static, self._osd_plan.n,
                self._osd_plan.rank, order, self.osd_elim, method)

    @property
    def device_state(self):
        state = super().device_state
        if not self.device_osd:
            return state
        return dict(state, osd_packed=self._osd_plan.packed,
                    osd_cost=self._osd_plan.cost)

    def host_postprocess(self, syndromes, corrections, aux) -> np.ndarray:
        """The host OSD on a BP-only decode's outputs: ``syndromes`` and
        ``corrections`` (B, m) / (B, n) and ``aux`` (``converged``,
        ``posterior_llr``), host arrays or tensors.  The aux comes to the
        host here, so its BP counts go to telemetry
        (``telemetry.record_bp_aux``) at no further read."""
        telemetry.record_bp_aux(aux)
        telemetry.count("osd.host_round_trips")
        return self.osd_host(_host(syndromes), _host(corrections),
                             _host(aux["converged"]),
                             _host(aux["posterior_llr"]))

    def osd_host(self, syndromes, bp_errors, converged,
                 posterior_llrs) -> np.ndarray:
        return osd_postprocess(
            self._h01, syndromes, bp_errors, converged,
            np.asarray(posterior_llrs, np.float64), self.channel_probs,
            osd_method=self.osd_method, osd_order=self.osd_order)

    def decode_batch(self, syndromes) -> np.ndarray:
        synd = torch.from_numpy(np.atleast_2d(np.asarray(syndromes, np.uint8)))
        if self.device_osd:
            out, aux = self.decode_batch_device(synd)
            telemetry.record_bp_aux(aux)
            if telemetry.enabled():
                # BP-failed shots go to the device OSD, as the device
                # telemetry vector counts them
                telemetry.count("osd.device_shots",
                                int((~aux["converged"]).sum()))
            return out.cpu().numpy()
        res = self.bp_batch_device(synd)
        return self.host_postprocess(synd.numpy(), res.error, res._asdict())


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_device_osd(device_osd: bool, osd_method: str) -> bool:
    """``device_osd`` as a bool; True for a method without a device program
    raises."""
    if not isinstance(device_osd, (bool, np.bool_)):
        raise TypeError(f"device_osd must be True or False, got "
                        f"{device_osd!r}")
    if device_osd and osd_method not in DEVICE_METHODS:
        raise NotImplementedError(
            f"device OSD implements OSD-0/OSD-E/OSD-CS only, not "
            f"{osd_method!r}; use device_osd=False")
    return bool(device_osd)


class FirstMinBPDecoder:
    """Sequential-restart decoder (reference FirstMinBPDecoder,
    ``src/Decoders.py:49-74``): ``max_iter`` restarts of one min-sum
    iteration each (``bp.first_min_bp_decode``, plain PyTorch on either
    device)."""

    # OSD (if any) runs on the device: no host stage after decode_device
    needs_host_postprocess = False

    def __init__(self, h, channel_probs, max_iter, bp_method="minimum_sum",
                 ms_scaling_factor=0.9, device="cuda"):
        if _norm_method(bp_method) != "minimum_sum":
            raise NotImplementedError("FirstMinBPDecoder supports min-sum only")
        self.device = resolve_device(device)
        self.h = np.asarray(h)
        self._h01 = gf2.to_gf2(h)
        self.graph = bp.build_tanner_graph(self._h01, self.device)
        self.channel_probs = np.broadcast_to(
            np.asarray(channel_probs, np.float64), (self._h01.shape[1],)
        ).copy()
        self.max_iter = max(1, int(max_iter))
        self.ms_scaling_factor = float(ms_scaling_factor)
        self.llr0 = bp.llr_from_probs(self.channel_probs, self.device)

    @property
    def device_static(self):
        return ("firstmin", self.max_iter, float(self.ms_scaling_factor))

    @property
    def device_state(self):
        return {"graph": self.graph, "llr0": self.llr0}

    @property
    def kernel_variant(self) -> str:
        return kernel_variant(self.device_static, self.device_state)

    def decode_batch_device(self, syndromes):
        """(B, m) uint8 tensor -> (corrections (B, n) uint8, aux dict)."""
        return decode_device(self.device_static, self.device_state,
                             syndromes.to(self.device, torch.uint8))

    def host_postprocess(self, syndromes, corrections, aux):
        """No host stage: the corrections as they are."""
        return corrections

    def decode_batch(self, syndromes) -> np.ndarray:
        synd = torch.from_numpy(np.atleast_2d(np.asarray(syndromes, np.uint8)))
        out, _ = self.decode_batch_device(synd)
        return out.cpu().numpy()

    def decode(self, synd):
        return self.decode_batch(np.atleast_2d(synd))[0]


def GetSpaceTimeCheckMat(h, t0: int) -> np.ndarray:
    """Block-lower-bidiagonal space-time check matrix (reference
    ``src/Decoders.py:179-194``): diagonal blocks [H | I_m], first
    subdiagonal blocks [0 | I_m]; t0*m rows by t0*(n+m) columns."""
    h = gf2.to_gf2(h)
    m, n = h.shape
    eye = np.eye(m, dtype=np.uint8)
    st = np.zeros((t0 * m, t0 * (n + m)), dtype=np.uint8)
    for i in range(t0):
        st[i * m:(i + 1) * m, i * (n + m):i * (n + m) + n] = h
        st[i * m:(i + 1) * m, i * (n + m) + n:(i + 1) * (n + m)] = eye
        if i >= 1:
            j = i - 1
            st[i * m:(i + 1) * m, j * (n + m) + n:(j + 1) * (n + m)] = eye
    return st


class ST_BP_Decoder_syndrome:
    """Space-time syndrome decoder (reference ``src/Decoders.py:200-223``):
    a ``BPDecoder`` over ``GetSpaceTimeCheckMat(h, num_rep)`` with the
    channel [p_data x n, p_synd x m] tiled num_rep times; the output is the
    XOR of the per-slice data-error estimates.  The inner decoder picks its
    BP head by the window matrix's shape, as any ``BPDecoder``."""

    # OSD (if any) runs on the device: no host stage after decode_device
    needs_host_postprocess = False

    def __init__(self, h, p_data, p_synd, max_iter, bp_method="minimum_sum",
                 ms_scaling_factor=0.625, num_rep=1, device="cuda"):
        h = gf2.to_gf2(h)
        self.num_checks, self.num_qubits = h.shape
        self.h = h
        self.num_rep = int(num_rep)
        self.ST_h = GetSpaceTimeCheckMat(h, self.num_rep)
        probs = np.concatenate([np.full(self.num_qubits, p_data),
                                np.full(self.num_checks, p_synd)])
        self._bp = BPDecoder(self.ST_h, np.tile(probs, self.num_rep),
                             max_iter, bp_method, ms_scaling_factor,
                             device=device)
        self.device = self._bp.device

    @property
    def device_static(self):
        return ("st_syndrome", self.num_rep, self.num_checks,
                self.num_qubits, self._bp.device_static)

    @property
    def device_state(self):
        return self._bp.device_state

    @property
    def kernel_variant(self) -> str:
        return kernel_variant(self.device_static, self.device_state)

    def decode_batch_device(self, detector_histories):
        """(B, num_rep, m) uint8 tensor -> (folded data corrections (B, n)
        uint8, the inner decode's aux)."""
        return decode_device(self.device_static, self.device_state,
                             detector_histories.to(self.device, torch.uint8))

    def host_postprocess(self, syndromes, corrections, aux):
        """No host stage: the corrections as they are."""
        return corrections

    def decode_batch(self, detector_histories) -> np.ndarray:
        """(B, num_rep, m) -> (B, n) folded data corrections (host arrays);
        a single (num_rep, m) history is a batch of one."""
        arr = np.asarray(detector_histories, np.uint8)
        if arr.ndim == 2:
            arr = arr[None]
        out, _ = self.decode_batch_device(torch.from_numpy(arr))
        return out.cpu().numpy()

    def decode(self, detector_history):
        return self.decode_batch(np.asarray(detector_history)[None])[0]


class ST_BP_Decoder_Circuit(BPDecoder):
    """BP over a detector error model's fault matrix ``h`` with one prior
    per fault column (reference ``src/Decoders_SpaceTime.py:261-274``):
    a ``BPDecoder``, whose BP head follows the matrix's shape."""

    def __init__(self, h, channel_probs, max_iter, bp_method="minimum_sum",
                 ms_scaling_factor=0.625, device="cuda"):
        super().__init__(h, channel_probs, max_iter, bp_method,
                         ms_scaling_factor, device=device)


class ST_BPOSD_Decoder_Circuit(BPOSD_Decoder):
    """BP+OSD over a detector error model's fault matrix (reference
    ``src/Decoders_SpaceTime.py:277-292``): a ``BPOSD_Decoder``."""


class DecoderClass(ABC):
    """Abstract factory (reference DecoderClass)."""

    @abstractmethod
    def GetDecoder(self, code_and_noise_channel_params):
        ...

    def GetDecoderState(self, code_and_noise_channel_params):
        """``(device_static, device_state)`` of the decoder ``GetDecoder``
        would build for these params: the per-cell payload the fused sweep
        stacks along its cell axis.  This default builds the decoder; the
        BP and BPOSD classes give the pair without building it."""
        dec = self.GetDecoder(code_and_noise_channel_params)
        return dec.device_static, dec.device_state


def _bp_state(d, params, device):
    """The BP part of ``GetDecoderState`` (the factories' settings ``d``):
    ``(bp static, {graph, llr0, pallas}, h01, channel probs)``, the graph
    and head from ``_per_h``, as ``BPDecoder`` builds them."""
    probs, num_qubits = _channel_from_params(params)
    h01 = gf2.to_gf2(params["h"])
    method = _norm_method(d["bp_method"])
    dev = resolve_device(device)
    graph, head, tag = _per_h(h01, dev, method, quantize=d.get("quantize"))
    static = ("bp", max(1, int(num_qubits / d["max_iter_ratio"])), method,
              float(d["ms_scaling_factor"]), True, tag)
    channel = np.broadcast_to(np.asarray(probs, np.float64),
                              (h01.shape[1],)).copy()
    return (static, {"graph": graph, "llr0": bp.llr_from_probs(channel, dev),
                     "pallas": head}, h01, channel)


def _channel_from_params(params) -> tuple[np.ndarray, int]:
    """With 'p_syndrome' present, h is the extended [H|I] matrix and the
    channel is [p_data x n, p_syndrome x m]; otherwise uniform p_data."""
    h = np.asarray(params["h"])
    if "p_syndrome" in params:
        num_checks = h.shape[0]
        num_qubits = h.shape[1] - h.shape[0]
        probs = np.concatenate(
            [np.full(num_qubits, params["p_data"]),
             np.full(num_checks, params["p_syndrome"])])
    else:
        num_qubits = h.shape[1]
        probs = np.full(num_qubits, params["p_data"])
    return probs, num_qubits


def _require(params):
    for key in ("h", "p_data"):
        if key not in params:
            raise KeyError(f"decoder params miss {key!r}")


class BPOSD_Decoder_Class(DecoderClass):
    """Factory of ``BPOSD_Decoder``; ``device_osd`` goes to each decoder."""

    def __init__(self, max_iter_ratio, bp_method, ms_scaling_factor,
                 osd_method, osd_order, device="cuda",
                 device_osd: bool = True):
        self.decoder_default_params = {
            "max_iter_ratio": max_iter_ratio, "bp_method": bp_method,
            "ms_scaling_factor": ms_scaling_factor, "osd_method": osd_method,
            "osd_order": osd_order,
        }
        self.device = device
        self.device_osd = device_osd

    def GetDecoder(self, code_and_noise_channel_params):
        _require(code_and_noise_channel_params)
        probs, num_qubits = _channel_from_params(code_and_noise_channel_params)
        d = self.decoder_default_params
        return BPOSD_Decoder(
            h=code_and_noise_channel_params["h"], channel_probs=probs,
            max_iter=num_qubits / d["max_iter_ratio"],
            bp_method=d["bp_method"], ms_scaling_factor=d["ms_scaling_factor"],
            osd_method=d["osd_method"], osd_order=d["osd_order"],
            device=self.device, device_osd=self.device_osd)

    def GetDecoderState(self, code_and_noise_channel_params):
        """``GetDecoder(params)``'s ``(device_static, device_state)``
        without the build: its new leaves are the priors and OSD's costs
        (``BPOSD_Decoder``'s statics and per-H leaves, equal to a full
        build's).  A host-OSD decoder has no device program of its whole
        decode, so it raises."""
        _require(code_and_noise_channel_params)
        d = self.decoder_default_params
        if not _check_device_osd(self.device_osd, d["osd_method"]):
            raise ValueError(
                "a host-OSD decoder (device_osd off) has no device state: "
                "its OSD runs on the host after the device's BP")
        bp_static, state, h01, channel = _bp_state(
            d, code_and_noise_channel_params, self.device)
        plan = _osd_plan(h01, channel, resolve_device(self.device))
        order = (0 if METHODS[d["osd_method"]] == 0
                 else _check_osd_order(d["osd_order"]))
        method = "osd_cs" if d["osd_method"] == "osd_cs" else "osd_e"
        static = ("bposd_dev", bp_static, plan.n, plan.rank, order,
                  osd_device.elim_route(), method)
        return static, dict(state, osd_packed=plan.packed,
                            osd_cost=plan.cost)


class BP_Decoder_Class(DecoderClass):
    """``quantize`` (default None) builds int8 min-sum decoders."""

    def __init__(self, max_iter_ratio, bp_method, ms_scaling_factor,
                 quantize: str | None = None, device="cuda"):
        self.decoder_default_params = {
            "max_iter_ratio": max_iter_ratio, "bp_method": bp_method,
            "ms_scaling_factor": ms_scaling_factor, "quantize": quantize,
        }
        self.device = device

    def GetDecoder(self, code_and_noise_channel_params):
        _require(code_and_noise_channel_params)
        probs, num_qubits = _channel_from_params(code_and_noise_channel_params)
        d = self.decoder_default_params
        return BPDecoder(
            h=code_and_noise_channel_params["h"], channel_probs=probs,
            max_iter=num_qubits / d["max_iter_ratio"],
            bp_method=d["bp_method"], ms_scaling_factor=d["ms_scaling_factor"],
            quantize=d["quantize"], device=self.device)

    def GetDecoderState(self, code_and_noise_channel_params):
        """``GetDecoder(params)``'s ``(device_static, device_state)``
        without the build: the graph and head from the per-H memo, a new
        prior (the JAX package's fast path)."""
        _require(code_and_noise_channel_params)
        static, state, _, _ = _bp_state(
            self.decoder_default_params, code_and_noise_channel_params,
            self.device)
        return static, state


class FirstMinBP_Decoder_Class(DecoderClass):
    """Factory for the restart decoder (the Single-Shot notebook's)."""

    def __init__(self, max_iter_ratio, bp_method, ms_scaling_factor,
                 device="cuda"):
        self.decoder_default_params = {
            "max_iter_ratio": max_iter_ratio, "bp_method": bp_method,
            "ms_scaling_factor": ms_scaling_factor,
        }
        self.device = device

    def GetDecoder(self, code_and_noise_channel_params):
        _require(code_and_noise_channel_params)
        probs, num_qubits = _channel_from_params(code_and_noise_channel_params)
        d = self.decoder_default_params
        return FirstMinBPDecoder(
            h=code_and_noise_channel_params["h"], channel_probs=probs,
            max_iter=num_qubits / d["max_iter_ratio"],
            bp_method=d["bp_method"], ms_scaling_factor=d["ms_scaling_factor"],
            device=self.device)


class ST_BP_Decoder_Class(DecoderClass):
    """Factory of ``ST_BP_Decoder_syndrome`` (reference
    ``src/Decoders.py:227-257``), keys 'h', 'p_data', 'num_rep'.  The
    reference's quirk is kept: with 'p_syndrome' present the syndrome prior
    is p_data, not the p_syndrome value; without it the prior is 0 (which
    ``bp.llr_from_probs`` clips); ``max_iter`` is n / max_iter_ratio."""

    def __init__(self, max_iter_ratio, bp_method, ms_scaling_factor,
                 device="cuda"):
        self.decoder_default_params = {
            "max_iter_ratio": max_iter_ratio, "bp_method": bp_method,
            "ms_scaling_factor": ms_scaling_factor,
        }
        self.device = device

    def GetDecoder(self, code_and_noise_channel_params):
        p = code_and_noise_channel_params
        _require(p)
        if "num_rep" not in p:
            raise KeyError("decoder params miss 'num_rep'")
        h = np.asarray(p["h"])
        d = self.decoder_default_params
        return ST_BP_Decoder_syndrome(
            h=h, p_data=p["p_data"],
            p_synd=p["p_data"] if "p_syndrome" in p else 0,
            max_iter=h.shape[1] / d["max_iter_ratio"],
            bp_method=d["bp_method"],
            ms_scaling_factor=d["ms_scaling_factor"], num_rep=p["num_rep"],
            device=self.device)


def _require_circuit(params):
    for key in ("h", "code_h", "channel_probs"):
        if key not in params:
            raise KeyError(f"decoder params miss {key!r}")


class ST_BP_Decoder_Circuit_Class(DecoderClass):
    """Factory of ``ST_BP_Decoder_Circuit`` (reference
    ``src/Decoders_SpaceTime.py:296-321``), keys 'h' (the fault matrix),
    'code_h' and 'channel_probs'.  The reference's quirk is kept:
    ``max_iter`` scales with the code's width (``code_h``), not the fault
    matrix's, and is ``int(n / max_iter_ratio)``."""

    def __init__(self, max_iter_ratio, bp_method, ms_scaling_factor,
                 device="cuda"):
        self.decoder_default_params = {
            "max_iter_ratio": max_iter_ratio, "bp_method": bp_method,
            "ms_scaling_factor": ms_scaling_factor,
        }
        self.device = device

    def GetDecoder(self, code_and_noise_channel_params):
        p = code_and_noise_channel_params
        _require_circuit(p)
        num_qubits = np.asarray(p["code_h"]).shape[1]
        d = self.decoder_default_params
        return ST_BP_Decoder_Circuit(
            h=p["h"], channel_probs=p["channel_probs"],
            max_iter=int(num_qubits / d["max_iter_ratio"]),
            bp_method=d["bp_method"],
            ms_scaling_factor=d["ms_scaling_factor"], device=self.device)


class ST_BPOSD_Decoder_Circuit_Class(DecoderClass):
    """Factory of ``ST_BPOSD_Decoder_Circuit`` (reference
    ``src/Decoders_SpaceTime.py:323-357``), the keys of
    ``ST_BP_Decoder_Circuit_Class``; ``max_iter`` is ``code_h``'s width
    over ``max_iter_ratio``, passed unrounded as the reference does."""

    def __init__(self, max_iter_ratio, bp_method, ms_scaling_factor,
                 osd_method, osd_order, device="cuda",
                 device_osd: bool = True):
        self.decoder_default_params = {
            "max_iter_ratio": max_iter_ratio, "bp_method": bp_method,
            "ms_scaling_factor": ms_scaling_factor, "osd_method": osd_method,
            "osd_order": osd_order,
        }
        self.device = device
        self.device_osd = device_osd

    def GetDecoder(self, code_and_noise_channel_params):
        p = code_and_noise_channel_params
        _require_circuit(p)
        num_qubits = np.asarray(p["code_h"]).shape[1]
        d = self.decoder_default_params
        return ST_BPOSD_Decoder_Circuit(
            h=p["h"], channel_probs=p["channel_probs"],
            max_iter=num_qubits / d["max_iter_ratio"],
            bp_method=d["bp_method"], ms_scaling_factor=d["ms_scaling_factor"],
            osd_method=d["osd_method"], osd_order=d["osd_order"],
            device=self.device, device_osd=self.device_osd)
