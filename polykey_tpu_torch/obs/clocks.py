"""Cross-process clock alignment for the disaggregated tiers (the
reference's polykey_tpu/obs/clocks.py).

Every process in a disagg deployment stamps its timeline and spans with
its OWN ``time.monotonic()`` — a clock whose zero is arbitrary per
process, so worker events cannot be placed on the coordinator's axis by
subtraction alone. This module is the ping-based offset estimator the
merged flight deck rests on:

- The coordinator already heartbeats every worker (``disagg_heartbeat_s``)
  with a ``ping`` op; the reply now carries the worker's monotonic
  timestamp taken while building the reply. The estimator samples the
  coordinator clock immediately before send (``t_send``) and after
  receive (``t_recv``) and assumes the reply was stamped at the
  request/response midpoint — the classic NTP-style bound:

      offset      = (t_send + t_recv) / 2 - remote_mono
      uncertainty = (t_recv - t_send) / 2          # half the RTT

  so ``local ≈ remote + offset`` within ±uncertainty.
- Samples are quality-filtered, not averaged: the lowest-uncertainty
  sample wins, but its uncertainty is AGED by a drift bound (crystal
  oscillators drift ~tens of ppm; we budget 200 ppm) so a stale perfect
  sample eventually loses to a fresh mediocre one. Re-estimating on
  every heartbeat keeps the aged uncertainty near RTT/2 forever.

The estimator is deliberately stateless across restarts: a restarted
worker has a NEW monotonic epoch, so the pool resets the sync when a
member's pid changes.
"""

from __future__ import annotations

import time
from typing import Optional


class ClockSync:
    """Maps one remote process's monotonic clock onto the local one.

    Thread contract: ``update`` is called from a single thread (the
    pool's heartbeat loop); readers (``offset``/``to_local``) may race a
    concurrent update and observe either the old or the new estimate —
    both are valid mappings within their stated uncertainty.
    """

    __slots__ = ("drift", "offset", "_uncertainty", "_at", "samples",
                 "accepted")

    def __init__(self, drift_ppm: float = 200.0):
        self.drift = drift_ppm * 1e-6
        self.offset: Optional[float] = None   # local ≈ remote + offset
        self._uncertainty = float("inf")
        self._at = 0.0                        # local stamp of best sample
        self.samples = 0
        self.accepted = 0

    def update(self, t_send: float, t_recv: float,
               remote_mono: float) -> bool:
        """Fold in one ping exchange. Returns True when the sample
        replaced the current estimate (lower aged uncertainty)."""
        rtt = t_recv - t_send
        if rtt < 0:                 # non-monotonic caller bug; drop it
            return False
        sample_offset = (t_send + t_recv) / 2.0 - remote_mono
        sample_unc = rtt / 2.0
        self.samples += 1
        current = self.uncertainty(now=t_recv)
        if current is not None and sample_unc >= current:
            return False
        self.offset = sample_offset
        self._uncertainty = sample_unc
        self._at = t_recv
        self.accepted += 1
        return True

    def uncertainty(self, now: Optional[float] = None) -> Optional[float]:
        """Current bound on |true offset - estimate|, drift-aged. None
        until the first sample lands."""
        if self.offset is None:
            return None
        if now is None:
            now = time.monotonic()
        return self._uncertainty + self.drift * max(0.0, now - self._at)

    def to_local(self, remote_t: float) -> float:
        """Map a remote monotonic timestamp onto the local clock.
        Identity until the first sample (callers render unaligned rather
        than not at all)."""
        return remote_t if self.offset is None else remote_t + self.offset

    def reset(self) -> None:
        """Forget the estimate — required when the remote restarts (its
        monotonic epoch changed, so the old offset is meaningless)."""
        self.offset = None
        self._uncertainty = float("inf")
        self._at = 0.0

    def snapshot(self) -> dict:
        return {
            "offset_s": self.offset,
            "uncertainty_s": self.uncertainty(),
            "samples": self.samples,
            "accepted": self.accepted,
        }
