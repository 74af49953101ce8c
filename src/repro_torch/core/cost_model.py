"""Inference delay & energy model (paper §II-D, eqs. (4)-(9)).

Port of ``repro/core/cost_model.py`` for the serving slice, in float64 host
arithmetic (Python floats / numpy scalars):

  on-agent  delay   t(b_hat, f)  = b_hat N_FLOP / (b f c)              (4)
  on-server delay   t~(f~)       = N~_FLOP / (f~ c~)                   (5)
  on-agent  energy  e(b_hat, f)  = eta  (b_hat N_FLOP / (b c)) psi f^2 (6)
  on-server energy  e~(f~)       = eta~ (N~_FLOP / c~) psi~ f~^2       (7)
  totals            T = t + t~,  E = e + e~                            (8),(9)

plus the optional uplink term for the boundary embedding at ``b_emb``
(delay over ``link_bps``, transmit energy at ``tx_power_w``), 0 by
default, and the decode step's KV-cache read (delay over ``kv_bw_bps``,
access energy at ``kv_power_w``), 0 by default, and the terms of one
speculative round (draft, verify, rollback) that the speculative
allocator of ``core.mixed_precision`` prices.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SystemParams:
    """Hardware/system constants of §II-D and §VI-C (paper defaults)."""

    n_flop_agent: float          # N_FLOP: full-precision on-agent FLOPs
    n_flop_server: float         # N~_FLOP
    b_full: float = 16.0         # b: full-precision storage bit-width
    c_agent: float = 32.0
    c_server: float = 128.0
    f_max: float = 2.0e9
    f_server_max: float = 10.0e9
    eta_agent: float = 1.0
    eta_server: float = 2.0
    psi_agent: float = 2.0e-29
    psi_server: float = 1.0e-28
    # optional transport (0 = faithful computation-only model)
    emb_bytes_full: float = 0.0  # boundary embedding bytes at full precision
    link_bps: float = 0.0        # uplink rate in bytes/s; 0 disables
    tx_power_w: float = 0.0      # radio transmit power; 0 disables tx energy
    # optional KV-cache traffic (decode serving; 0 = prefill-only model)
    kv_bytes_full: float = 0.0   # KV cache bytes/step at full precision
    kv_bw_bps: float = 0.0       # cache memory bandwidth in bytes/s
    kv_power_w: float = 0.0      # cache access power; 0 disables kv energy


def agent_delay(b_hat, f, p: SystemParams):
    """Eq. (4)."""
    return b_hat * p.n_flop_agent / (p.b_full * f * p.c_agent)


def server_delay(f_server, p: SystemParams):
    """Eq. (5)."""
    return p.n_flop_server / (f_server * p.c_server)


def transport_delay(b_emb, p: SystemParams):
    """Embedding uplink time (0 when link modeling is disabled)."""
    if p.link_bps <= 0.0 or p.emb_bytes_full <= 0.0:
        return 0.0
    return (b_emb / p.b_full) * p.emb_bytes_full / p.link_bps


def transport_energy(b_emb, p: SystemParams):
    """Uplink radio energy: tx power × uplink time (0 when disabled)."""
    if p.tx_power_w <= 0.0:
        return 0.0
    return p.tx_power_w * transport_delay(b_emb, p)


def kv_delay(b_kv, p: SystemParams):
    """Per-step KV-cache read time at stored bit-width ``b_kv``: linear in
    the bit-width, 0 when cache modeling is disabled."""
    if p.kv_bw_bps <= 0.0 or p.kv_bytes_full <= 0.0:
        return 0.0
    return (b_kv / p.b_full) * p.kv_bytes_full / p.kv_bw_bps


def kv_energy(b_kv, p: SystemParams):
    """KV-cache access energy: access power × read time (0 when disabled)."""
    if p.kv_power_w <= 0.0:
        return 0.0
    return p.kv_power_w * kv_delay(b_kv, p)


def agent_energy(b_hat, f, p: SystemParams):
    """Eq. (6)."""
    return p.eta_agent * (b_hat * p.n_flop_agent / (p.b_full * p.c_agent)) \
        * p.psi_agent * f ** 2


def server_energy(f_server, p: SystemParams):
    """Eq. (7)."""
    return p.eta_server * (p.n_flop_server / p.c_server) \
        * p.psi_server * f_server ** 2


def draft_delay(b_draft, k, p: SystemParams):
    """Draft phase of one speculative round: ``k`` agent-partition
    forwards at ``b_draft`` bits, pinned at ``f_max`` (so the term shrinks
    the (T0, E0) budgets the way the transport share does)."""
    return k * agent_delay(b_draft, p.f_max, p)


def draft_energy(b_draft, k, p: SystemParams):
    """Energy of the draft phase (eq. (6) at ``f_max``, ``k`` times)."""
    return k * agent_energy(b_draft, p.f_max, p)


def verify_delay(b_hat, f, f_server, k, p: SystemParams):
    """Verify phase of one speculative round: one batched forward over the
    ``k`` drafted positions and the bonus position costs one weight pass,
    so ``k`` does not enter."""
    del k
    return agent_delay(b_hat, f, p) + server_delay(f_server, p)


def verify_energy(b_hat, f, f_server, k, p: SystemParams):
    """Energy of the verify phase: one weight pass (eqs. (6)-(7))."""
    del k
    return agent_energy(b_hat, f, p) + server_energy(f_server, p)


def rollback_delay(b_kv, n_rejected, p: SystemParams):
    """One discarded cache write per rejected draft at the stored
    bit-width (0 when cache modeling is disabled)."""
    return n_rejected * kv_delay(b_kv, p)


def rollback_energy(b_kv, n_rejected, p: SystemParams):
    """Energy of truncating rejected speculative cache writes."""
    return n_rejected * kv_energy(b_kv, p)


def speculative_round_delay(b_hat, f, f_server, b_draft, k, tau,
                            p: SystemParams, b_emb=None, b_kv=None):
    """Expected delay of one draft/uplink/verify/rollback round delivering
    ``tau`` tokens in expectation: the uplink once a round, the cache read
    ``k + 1`` times, the expected ``k + 1 - tau`` rejected entries billed
    as rollback."""
    t = draft_delay(b_draft, k, p) \
        + verify_delay(b_hat, f, f_server, k, p)
    if b_emb is not None:
        t = t + transport_delay(b_emb, p)
    if b_kv is not None:
        t = t + (k + 1) * kv_delay(b_kv, p) \
            + rollback_delay(b_kv, max(k + 1 - tau, 0.0), p)
    return t


def speculative_round_energy(b_hat, f, f_server, b_draft, k, tau,
                             p: SystemParams, b_emb=None, b_kv=None):
    """Expected energy of one speculative round, term for term as
    :func:`speculative_round_delay`."""
    e = draft_energy(b_draft, k, p) \
        + verify_energy(b_hat, f, f_server, k, p)
    if b_emb is not None:
        e = e + transport_energy(b_emb, p)
    if b_kv is not None:
        e = e + (k + 1) * kv_energy(b_kv, p) \
            + rollback_energy(b_kv, max(k + 1 - tau, 0.0), p)
    return e


def total_delay(b_hat, f, f_server, p: SystemParams, b_emb=None,
                b_kv=None):
    """Eq. (8) (+ the optional transport and KV-cache terms)."""
    t = agent_delay(b_hat, f, p) + server_delay(f_server, p)
    if b_emb is not None:
        t = t + transport_delay(b_emb, p)
    if b_kv is not None:
        t = t + kv_delay(b_kv, p)
    return t


def total_energy(b_hat, f, f_server, p: SystemParams, b_emb=None,
                 b_kv=None):
    """Eq. (9) (+ the optional uplink transmit and KV-cache access
    energy)."""
    e = agent_energy(b_hat, f, p) + server_energy(f_server, p)
    if b_emb is not None:
        e = e + transport_energy(b_emb, p)
    if b_kv is not None:
        e = e + kv_energy(b_kv, p)
    return e
