"""Generator-driven noise samplers.

Each sampler draws float32 uniforms from a ``torch.Generator`` on the
device.  Convention: ``pauli_error_probs = [px, py, pz]`` with the binning
order u < pz -> Z; pz <= u < pz+px -> X; pz+px <= u < pz+px+py -> Y.  The
probabilities are Python numbers or a (3,) float32 tensor on the
generator's device (a fused sweep lane's, gathered on the device): the bin
edges are the same float32 sums either way, so both draw the same planes.

Weighted (importance-sampled) samplers for the rare-event estimators
(``rare/``), as the JAX package's: the ``*_tilted`` samplers draw from a
TILTED channel ``q`` and return the per-shot log importance weight
``log dP_p/dP_q`` with the planes.  They take the same uniforms as the
direct samplers with the tilt probabilities in the thresholds, so a zero
tilt (``q == p``) gives the direct planes bit for bit and a log weight of
exactly 0.  The ``*_stratum`` samplers draw fixed-weight patterns uniformly
within a stratum; their weight is constant across the stratum.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.gf2_packed import pack_shots

__all__ = ["depolarizing_xz", "depolarizing_xz_packed", "bit_flips",
           "bit_flips_packed", "depolarizing_xz_tilted",
           "depolarizing_xz_tilted_packed", "bit_flips_tilted",
           "bit_flips_tilted_packed", "fixed_weight_flips",
           "stratum_log_weight", "depolarizing_xz_stratum"]


def _uniform(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=generator.device)


def _triple(probs):
    """``(px, py, pz)`` as float32: 0-dim tensors of a tensor, else Python
    floats holding float32 values (no host-to-device copy, which would
    synchronize the stream, per batch)."""
    if isinstance(probs, torch.Tensor):
        return probs.to(torch.float32).unbind()
    return tuple(np.float32(p) for p in probs)


def _edges(probs):
    """The bins' float32 upper edges (Z, X, Y): pz, pz+px, pz+px+py."""
    px, py, pz = _triple(probs)
    x_edge = pz + px
    edges = (pz, x_edge, x_edge + py)
    if isinstance(pz, torch.Tensor):
        return edges
    return tuple(float(e) for e in edges)


def _bins(u, probs):
    z_edge, x_edge, y_edge = _edges(probs)
    is_z = u < z_edge
    is_x = (u >= z_edge) & (u < x_edge)
    is_y = (u >= x_edge) & (u < y_edge)
    return is_z, is_x, is_y


def depolarizing_xz(generator: torch.Generator, shape, pauli_error_probs):
    """Sample X/Z error components for independent single-qubit Pauli noise.

    shape: output shape, e.g. (batch, n).  Returns (error_x, error_z) uint8
    on the generator's device; the bin edges are float32 sums, as in the
    JAX package."""
    is_z, is_x, is_y = _bins(_uniform(generator, shape), pauli_error_probs)
    return (is_x | is_y).to(torch.uint8), (is_z | is_y).to(torch.uint8)


def depolarizing_xz_packed(generator: torch.Generator, shape,
                           pauli_error_probs):
    """``depolarizing_xz`` packed 32 shots per int32 word: (ceil(B/32), n)."""
    error_x, error_z = depolarizing_xz(generator, shape, pauli_error_probs)
    return pack_shots(error_x), pack_shots(error_z)


def _rate(p):
    """A flip rate as a float32 0-dim tensor or a Python float holding a
    float32 value."""
    if isinstance(p, torch.Tensor):
        return p.to(torch.float32)
    return float(np.float32(p))


def bit_flips(generator: torch.Generator, shape, p):
    """i.i.d. Bernoulli(p) flips."""
    return (_uniform(generator, shape) < _rate(p)).to(torch.uint8)


def bit_flips_packed(generator: torch.Generator, shape, p):
    """``bit_flips`` packed 32 shots per int32 word (the same draws):
    (ceil(B/32), m)."""
    return pack_shots(bit_flips(generator, shape, p))


# ---------------------------------------------------------------------------
# Importance-sampled (tilted) channels
# ---------------------------------------------------------------------------
def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _shot_sum(per_site) -> torch.Tensor:
    """(batch, ...) per-site plane -> (batch,) per-shot sum."""
    return per_site.reshape(per_site.shape[0], -1).sum(dim=-1)


def depolarizing_xz_tilted(generator: torch.Generator, shape,
                           pauli_error_probs, tilt_probs):
    """Depolarizing sample from the TILTED channel ``tilt_probs`` with the
    per-shot log importance weight toward ``pauli_error_probs``.

    Returns ``(error_x, error_z, log_weight)``, ``log_weight`` float32
    ``(batch,)``: the sum over sites of ``log P_p(outcome) - log
    P_q(outcome)``, computed in float32 on the device as the JAX package
    does.  The uniforms and binning are ``depolarizing_xz``'s with ``q`` in
    the thresholds, so ``tilt_probs == pauli_error_probs`` gives its planes
    bit for bit and a log weight of exactly 0.  Each per-outcome term is
    selected (not multiplied), so an impossible outcome's ``-inf`` or NaN
    never reaches a taken one."""
    dev = generator.device
    p = _as_tensor(pauli_error_probs, dev)
    q = _as_tensor(tilt_probs, dev)
    is_z, is_x, is_y = _bins(_uniform(generator, shape), q)
    px, py, pz = p.unbind()
    qx, qy, qz = q.unbind()
    lr_i = torch.log1p(-(px + py + pz)) - torch.log1p(-(qx + qy + qz))
    lw = torch.where(
        is_z, torch.log(pz) - torch.log(qz),
        torch.where(is_x, torch.log(px) - torch.log(qx),
                    torch.where(is_y, torch.log(py) - torch.log(qy), lr_i)))
    return ((is_x | is_y).to(torch.uint8), (is_z | is_y).to(torch.uint8),
            _shot_sum(lw))


def depolarizing_xz_tilted_packed(generator: torch.Generator, shape,
                                  pauli_error_probs, tilt_probs):
    """``depolarizing_xz_tilted`` with the planes packed 32 shots per int32
    word; the log weight stays per shot, (batch,) float32."""
    ex, ez, logw = depolarizing_xz_tilted(generator, shape,
                                          pauli_error_probs, tilt_probs)
    return pack_shots(ex), pack_shots(ez), logw


def bit_flips_tilted(generator: torch.Generator, shape, p, q):
    """Bernoulli flips at the TILTED rate ``q`` with the per-shot log
    importance weight toward ``p``: ``(flips, log_weight)``.  The uniforms
    of ``bit_flips``, so ``q == p`` gives its flips and a log weight of
    exactly 0."""
    dev = generator.device
    p = _as_tensor(p, dev).reshape(())
    q = _as_tensor(q, dev).reshape(())
    flipped = _uniform(generator, shape) < q
    lw = torch.where(flipped, torch.log(p) - torch.log(q),
                     torch.log1p(-p) - torch.log1p(-q))
    return flipped.to(torch.uint8), _shot_sum(lw)


def bit_flips_tilted_packed(generator: torch.Generator, shape, p, q):
    """``bit_flips_tilted`` with the flips packed (the same draws)."""
    flips, logw = bit_flips_tilted(generator, shape, p, q)
    return pack_shots(flips), logw


# ---------------------------------------------------------------------------
# Fixed-weight strata
# ---------------------------------------------------------------------------
def fixed_weight_flips(generator: torch.Generator, shape, k):
    """Uniformly random weight-``k`` rows, one per shot: a random
    permutation of each row's sites (the argsort of its uniforms) and the
    ``k`` lowest ranks flip, so every row has weight exactly ``k``."""
    ranks = torch.argsort(_uniform(generator, shape), dim=-1)
    return (ranks < k).to(torch.uint8)


def stratum_log_weight(n, k, p_total, dtype=torch.float32):
    """Log importance weight of a uniform weight-``k`` sample toward an
    i.i.d. channel of total rate ``p_total``: ``log C(n, k) + k log p +
    (n - k) log(1 - p)``, constant across the stratum.  In ``dtype``
    (float32, as the JAX package computes it, or float64); a 0-dim CPU
    tensor."""
    n, k, p = (torch.as_tensor(x, dtype=dtype) for x in (n, k, p_total))
    log_comb = torch.lgamma(n + 1) - torch.lgamma(k + 1) - torch.lgamma(
        n - k + 1)
    return log_comb + k * torch.log(p) + (n - k) * torch.log1p(-p)


def depolarizing_xz_stratum(generator: torch.Generator, shape,
                            pauli_error_probs, k):
    """Depolarizing sample conditioned on total error weight ``k``: ``k``
    uniformly chosen sites take a Pauli from the renormalized ``(px, py,
    pz)`` (the reference's binning order), the rest none.  Returns
    ``(error_x, error_z, log_weight)``, the weight the constant
    ``stratum_log_weight(n, k, px + py + pz)`` of every shot."""
    batch, n = shape
    px, py, pz = (float(np.float32(x)) for x in pauli_error_probs)
    total = float(np.float32(px) + np.float32(py) + np.float32(pz))
    on = fixed_weight_flips(generator, shape, k).bool()
    u = _uniform(generator, shape)
    tz = float(np.float32(pz) / np.float32(total))
    tx = float(np.float32(px) / np.float32(total))
    is_z = u < tz
    is_x = (u >= tz) & (u < float(np.float32(tz) + np.float32(tx)))
    is_y = ~(is_z | is_x)
    logw = torch.full((batch,), float(stratum_log_weight(n, k, total)),
                      dtype=torch.float32, device=generator.device)
    return ((on & (is_x | is_y)).to(torch.uint8),
            (on & (is_z | is_y)).to(torch.uint8), logw)
