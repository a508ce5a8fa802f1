"""Seeded open-loop arrival schedules for storm clients (a copy of the
JAX package's load/arrivals.py: the same floats for the same arguments).

A closed-loop client waits for each answer before sending the next
request, so offered load can never exceed capacity and nothing is ever
refused. Production webhook traffic is open-loop: the apiserver offers
whatever the cluster generates (Poisson at steady state, square-wave
bursts from controller hot loops, flash crowds from node reconnect
storms) regardless of how the webhook is doing. These generators produce
the *schedule* (absolute arrival offsets in seconds from the stream
start); a storm client (chip_smoke.py phase 16) fires one request per entry at
its due time and never waits.

Determinism: every generator is a pure function of its arguments. Each
inter-arrival draw uses its own derived stream,
``random.Random(f"{seed}:{i}")``, so the i-th arrival is identical across
runs, hosts and Python hash randomization, and a failing storm replays
bit for bit.
"""

from __future__ import annotations

import random
from typing import List


def _gap(seed, i: int, rate_hz: float) -> float:
    """The i-th exponential inter-arrival gap of a seeded Poisson stream
    (one derived PRNG per draw: order-independent, re-runnable)."""
    return random.Random(f"{seed}:{i}").expovariate(rate_hz)


def poisson_schedule(
    rate_hz: float, duration_s: float, seed=0
) -> List[float]:
    """Homogeneous Poisson arrivals at ``rate_hz`` over ``duration_s``:
    monotonically non-decreasing offsets in [0, duration_s)."""
    if rate_hz <= 0 or duration_s <= 0:
        return []
    out: List[float] = []
    t, i = 0.0, 0
    while True:
        t += _gap(seed, i, rate_hz)
        i += 1
        if t >= duration_s:
            return out
        out.append(t)


def burst_schedule(
    base_hz: float,
    burst_hz: float,
    period_s: float,
    duty: float,
    duration_s: float,
    seed=0,
) -> List[float]:
    """Square-wave bursts (the controller-hot-loop shape): the rate is
    ``burst_hz`` during the first ``duty`` fraction of every ``period_s``
    window and ``base_hz`` outside it. Implemented by thinning a Poisson
    stream at the peak rate — each candidate arrival keeps its own derived
    coin, so the kept schedule stays deterministic."""
    peak = max(base_hz, burst_hz)
    if peak <= 0 or duration_s <= 0:
        return []
    duty = min(1.0, max(0.0, duty))
    out: List[float] = []
    t, i = 0.0, 0
    while True:
        t += _gap(seed, i, peak)
        coin = random.Random(f"{seed}:keep:{i}").random()
        i += 1
        if t >= duration_s:
            return out
        in_burst = period_s <= 0 or (t % period_s) < duty * period_s
        rate = burst_hz if in_burst else base_hz
        if coin < rate / peak:
            out.append(t)


def flash_crowd_schedule(
    base_hz: float,
    peak_hz: float,
    at_s: float,
    ramp_s: float,
    duration_s: float,
    seed=0,
) -> List[float]:
    """Base-rate Poisson with one flash crowd (the node-reconnect-storm
    shape): the rate ramps linearly from ``base_hz`` to ``peak_hz`` over
    ``ramp_s`` starting at ``at_s``, holds for ``ramp_s``, and ramps back
    down. Thinned at the peak rate like burst_schedule."""
    peak = max(base_hz, peak_hz)
    if peak <= 0 or duration_s <= 0:
        return []
    ramp_s = max(1e-9, ramp_s)

    def rate_at(t: float) -> float:
        if t < at_s or t > at_s + 3 * ramp_s:
            return base_hz
        if t < at_s + ramp_s:  # ramp up
            return base_hz + (peak_hz - base_hz) * (t - at_s) / ramp_s
        if t < at_s + 2 * ramp_s:  # hold
            return peak_hz
        # ramp down
        return peak_hz - (peak_hz - base_hz) * (t - at_s - 2 * ramp_s) / ramp_s

    out: List[float] = []
    t, i = 0.0, 0
    while True:
        t += _gap(seed, i, peak)
        coin = random.Random(f"{seed}:keep:{i}").random()
        i += 1
        if t >= duration_s:
            return out
        if coin < rate_at(t) / peak:
            out.append(t)


__all__ = ["burst_schedule", "flash_crowd_schedule", "poisson_schedule"]
