"""Network weather: reusable adversity profiles for the simulator
(docs/DESIGN.md §14 — the adversity half of the traffic laboratory).

The port's own copy of ``rlo_tpu/workloads/weather.py``, line for line:
only the imports and the logger names differ, so both packages give the
same results and the same bytes for the same seed
(``tests/test_torch_workloads.py`` holds them equal).

A profile scripts network badness as FIRST-CLASS data plugged into
``SimWorld``'s existing hooks, instead of ad-hoc per-test knobs:

  - :class:`HeavyTailDelay` — a ``delay_fn`` hook: Pareto-tailed WAN
    latency (most frames fast, a heavy tail of stragglers), capped;
  - :class:`GilbertLoss` — a ``drop_fn`` hook: two-state Markov
    (Gilbert) burst loss — CORRELATED drop runs, the shape that turns
    per-frame ARQ timers into retransmit storms, unlike the iid
    ``drop_p`` coin;
  - :func:`churn_script` — sustained churn RATE (not one scripted
    kill): kill and rejoin events with exponential interarrivals,
    emitted as ordinary Scenario script steps.

Everything is seeded and clock-free (rlo-lint R5 scope): samplers draw
ONLY from the rng the simulator passes in, so a weather-driven run
replays bit-for-bit from the world seed; ``churn_script`` derives its
schedule from its own seed at build time.

:func:`make_weather` bundles the canned profiles into a
:class:`Weather` whose repr is its own replay recipe — Scenario
violation messages print it verbatim.
"""

from __future__ import annotations

from dataclasses import dataclass
from random import Random
from typing import Callable, List, Optional, Sequence, Tuple

WEATHER_KINDS = ("wan", "burst_loss", "churn", "storm")


@dataclass(frozen=True)
class HeavyTailDelay:
    """Pareto-tailed per-frame delay sampler (a ``SimWorld delay_fn``).

    delay = base + scale * (U^(-1/alpha) - 1), capped at ``cap``: the
    bulk lands near ``base`` (the LAN floor) while the Lomax/Pareto
    tail produces rare multi-hundred-ms WAN stragglers. ``alpha``
    close to 1 makes the tail vicious; larger tames it. Frozen
    dataclass => the repr replays the profile exactly.
    """
    base: float = 0.002
    scale: float = 0.02
    alpha: float = 1.4
    cap: float = 2.0

    def __call__(self, rng: Random) -> float:
        u = 1.0 - rng.random()  # (0, 1]: avoids the **-1/alpha pole
        d = self.base + self.scale * (u ** (-1.0 / self.alpha) - 1.0)
        return d if d < self.cap else self.cap


class GilbertLoss:
    """Two-state Markov burst loss (a ``SimWorld drop_fn``).

    GOOD state drops with ``loss_good`` (usually 0), BAD state with
    ``loss_bad``; each send first advances the state (GOOD->BAD with
    ``p_enter``, BAD->GOOD with ``p_exit``), so losses arrive in
    correlated runs of mean length 1/``p_exit`` sends — the
    retransmit-storm shape iid loss can't produce at equal average
    rates. Stateful by design; all randomness comes from the passed
    rng, so runs replay from the world seed (the state itself resets
    with each fresh instance).
    """

    def __init__(self, p_enter: float = 0.02, p_exit: float = 0.2,
                 loss_good: float = 0.0, loss_bad: float = 0.75):
        self.p_enter = p_enter
        self.p_exit = p_exit
        self.loss_good = loss_good
        self.loss_bad = loss_bad
        self.bad = False
        self.bad_entries = 0   # observability: burst count

    def reset(self) -> None:
        """Back to the GOOD state with fresh counters. Scenario runs
        call this (via ``transport.sim.weather_hooks``) before
        handing the sampler to a SimWorld: a chain reused across runs
        would otherwise start mid-burst and break the bit-for-bit
        replay contract."""
        self.bad = False
        self.bad_entries = 0

    def __call__(self, rng: Random) -> bool:
        if self.bad:
            if rng.random() < self.p_exit:
                self.bad = False
        elif rng.random() < self.p_enter:
            self.bad = True
            self.bad_entries += 1
        p = self.loss_bad if self.bad else self.loss_good
        return bool(p) and rng.random() < p

    def __repr__(self) -> str:
        return (f"GilbertLoss(p_enter={self.p_enter}, "
                f"p_exit={self.p_exit}, loss_good={self.loss_good}, "
                f"loss_bad={self.loss_bad})")


def churn_script(seed: int, *, world_size: int, rate: float,
                 duration: float, start: float = 10.0,
                 mean_down: float = 20.0, min_down: float = 13.0,
                 min_live: int = 2, settle: float = 70.0,
                 immortal: Sequence[int] = (),
                 max_kills: Optional[int] = None) -> List[Tuple]:
    """Sustained-churn fault schedule: kill events with exponential
    interarrivals at ``rate`` per virtual second from ``start``, each
    followed by that rank's restart after an exponential ``mean_down``
    downtime floored at ``min_down``. Victims are drawn uniformly from
    the currently-live, non-``immortal`` ranks; a kill that would
    leave fewer than ``min_live`` ranks is skipped (the interarrival
    clock still advances — the RATE is what is being scripted). All
    pending restarts are clamped to land by ``duration - settle`` so a
    churn scenario ends healed and the convergence properties stay
    checkable. Returns ordinary ``(t, "kill"|"restart", rank)``
    Scenario steps, sorted.

    ``max_kills`` caps the total fault budget (None = unlimited): a
    watchdog-armed sweep scenario wants sustained-churn SHAPE with a
    bounded epoch advance, because every kill/heal cycle permanently
    raises the fleet epoch that the epoch-lag SLO is levelled against.

    ``min_down`` models the real-world floor on crash-restart
    turnaround AND must exceed the fleet's failure_timeout: a rank
    restarting before any survivor has detected its death petitions a
    membership that still believes the old incarnation is alive —
    outside the rejoin protocol's model (docs/DESIGN.md §8 defines
    rejoin as admission of a DETECTED-failed rank)."""
    if not 0 < settle < duration:
        raise ValueError(f"need 0 < settle < duration, got {settle}, "
                         f"{duration}")
    rng = Random(seed)
    last_event = duration - settle
    steps: List[Tuple] = []
    live = set(range(world_size))
    down_until = {}
    kills = 0
    t = start
    while True:
        t += rng.expovariate(rate)
        if t >= last_event:
            break
        if max_kills is not None and kills >= max_kills:
            break
        # restarts that came due before this kill
        for r in sorted(down_until):
            if down_until[r] <= t:
                steps.append((round(down_until[r], 6), "restart", r))
                live.add(r)
                del down_until[r]
        victims = sorted(live - set(immortal))
        if len(live) - 1 < min_live or not victims:
            continue
        v = victims[rng.randrange(len(victims))]
        steps.append((round(t, 6), "kill", v))
        live.discard(v)
        back = t + max(min_down, rng.expovariate(1.0 / mean_down))
        # a restart clamped to the settle fence must still respect the
        # detection floor; drop the kill instead when it cannot
        if back > last_event:
            if t + min_down > last_event:
                steps.pop()
                live.add(v)
                continue
            back = last_event
        down_until[v] = back
        kills += 1
    for r in sorted(down_until):
        steps.append((round(down_until[r], 6), "restart", r))
    steps.sort(key=lambda s: s[0])
    return steps


@dataclass
class Weather:
    """One bundled adversity profile: the ``delay_fn``/``drop_fn``
    hooks handed to ``SimWorld`` plus scripted fault ``script`` steps
    merged into a Scenario's script. Build via :func:`make_weather`
    so the repr (printed in SimViolation replay recipes) rebuilds the
    profile exactly."""
    name: str
    seed: int
    delay_fn: Optional[Callable[[Random], float]] = None
    drop_fn: Optional[Callable[[Random], bool]] = None
    script: Tuple = ()
    kwargs: Optional[dict] = None

    def __repr__(self) -> str:
        kw = "".join(f", {k}={v!r}"
                     for k, v in sorted((self.kwargs or {}).items()))
        return f"make_weather({self.name!r}, {self.seed}{kw})"


def make_weather(name: str, seed: int = 0, **kwargs) -> Weather:
    """Canned weather profiles (``WEATHER_KINDS``):

      - ``"wan"``        — heavy-tailed WAN delay (HeavyTailDelay);
      - ``"burst_loss"`` — correlated Gilbert burst loss;
      - ``"churn"``      — sustained kill/rejoin churn script
        (requires ``world_size=``; accepts the churn_script knobs;
        ``gilbert=dict(...)`` additionally rides GilbertLoss burst
        drops under the churn — the §18 healing-path stress shape);
      - ``"storm"``      — burst loss AND heavy-tailed delay together
        (the ARQ-storm worst case).

    The seed feeds the churn schedule; the delay/drop samplers draw
    from the SimWorld rng at run time (weather objects carry no
    hidden entropy)."""
    if name == "wan":
        return Weather(name, seed, delay_fn=HeavyTailDelay(**kwargs),
                       kwargs=kwargs)
    if name == "burst_loss":
        return Weather(name, seed, drop_fn=GilbertLoss(**kwargs),
                       kwargs=kwargs)
    if name == "churn":
        if "world_size" not in kwargs:
            raise ValueError("churn weather needs world_size=")
        gilbert = kwargs.pop("gilbert", None)
        kw = dict(rate=kwargs.pop("rate", 0.05),
                  duration=kwargs.pop("duration", 240.0), **kwargs)
        rkw = dict(kw, **({"gilbert": gilbert} if gilbert else {}))
        return Weather(name, seed,
                       script=tuple(churn_script(seed, **kw)),
                       drop_fn=(GilbertLoss(**gilbert)
                                if gilbert else None),
                       kwargs=rkw)
    if name == "storm":
        return Weather(name, seed, delay_fn=HeavyTailDelay(),
                       drop_fn=GilbertLoss(**kwargs), kwargs=kwargs)
    raise ValueError(f"unknown weather {name!r}; known: "
                     f"{', '.join(WEATHER_KINDS)}")
