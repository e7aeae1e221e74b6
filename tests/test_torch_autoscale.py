"""The port's fleet elasticity and phase stagger (``serve/autoscale.py``)
against the JAX package's, on the CPU: the cases of
``tests/test_autoscale.py`` (the stagger math, the ``StaggerController``,
the ``FleetAutoscaler`` on a fake fleet with an injected clock and samplers,
``AutoscaleConfig``'s validation and the serve CLI's fleet rule), and both
packages' controllers driven through the same seeded clock and sampler
scripts, with the same decision, holds and stats at every poll.

Nothing here waits on a thread for more than ``FILE_LIMIT_S`` seconds.
"""

import dataclasses
import time

import numpy as np
import pytest

from flexible_llm_sharding_tpu import cli as jcli
from flexible_llm_sharding_tpu.config import AutoscaleConfig as JAutoscaleConfig
from flexible_llm_sharding_tpu.config import ServeConfig as JServeConfig
from flexible_llm_sharding_tpu.serve import autoscale as jautoscale
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.config import AutoscaleConfig, ServeConfig
from flexible_llm_sharding_tpu_torch.serve import autoscale
from flexible_llm_sharding_tpu_torch.serve.autoscale import (
    FleetAutoscaler,
    StaggerController,
    stagger_error,
    stagger_targets,
)

FILE_LIMIT_S = 30.0

# ---------------------------------------------------------------------------
# The stagger math
# ---------------------------------------------------------------------------


def test_stagger_targets_even_spread():
    assert stagger_targets(4) == (0.0, 0.25, 0.5, 0.75)
    assert stagger_targets(1) == (0.0,)
    assert stagger_targets(0) == ()


def test_stagger_error_bounds_and_invariance():
    for n in (2, 3, 4, 7):
        assert stagger_error(stagger_targets(n)) == pytest.approx(0.0)
    assert stagger_error([0.3, 0.3, 0.3]) == pytest.approx(1.0)
    assert stagger_error([0.0, 1.0, 2.0]) == pytest.approx(1.0)
    base = [0.0, 0.25, 0.5, 0.75]
    assert stagger_error([(p + 0.13) % 1.0 for p in base]) == pytest.approx(stagger_error(base))
    assert stagger_error([]) == 0.0
    assert stagger_error([0.7]) == 0.0
    assert 0.0 < stagger_error([0.0, 0.1, 0.5, 0.6]) < 1.0


@pytest.mark.parametrize("seed", range(3))
def test_stagger_error_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        phases = list(rng.random(int(rng.integers(0, 8))) * 3)
        assert stagger_error(phases) == jautoscale.stagger_error(phases)


# ---------------------------------------------------------------------------
# StaggerController
# ---------------------------------------------------------------------------

def _stagger(**kw):
    return StaggerController(AutoscaleConfig(**{"enabled": True, "stagger_tolerance": 0.15,
                                                "stagger_hold_max_frac": 0.5, **kw}))


def _warm_walls(ctl, idxs, wall=1.0):
    for i in idxs:
        ctl.on_boundary(i, 10.0)
        ctl.on_boundary(i, 10.0 + wall)


def test_stagger_converged_assigns_no_holds():
    ctl = _stagger()
    _warm_walls(ctl, (0, 1, 2, 3))
    assert ctl.observe({0: 0.0, 1: 0.25, 2: 0.5, 3: 0.75}) == pytest.approx(0.0)
    s = ctl.stats()
    assert s["stagger_converged"] == 1 and s["holds_pending"] == 0


def test_stagger_assigns_bounded_holds_anchor_exempt():
    ctl = _stagger(stagger_hold_max_frac=0.5)
    _warm_walls(ctl, (0, 1, 2), wall=2.0)
    assert ctl.observe({0: 0.4, 1: 0.4, 2: 0.4}) == pytest.approx(1.0)
    holds = {i: ctl.hold_frac(i) for i in (0, 1, 2)}
    assert sum(1 for h in holds.values() if h == 0.0) == 1
    assert all(0.0 <= h <= 0.5 + 1e-9 for h in holds.values())
    assert ctl.stats()["holds_pending"] == 2


def test_stagger_one_round_at_a_time():
    ctl = _stagger()
    _warm_walls(ctl, (0, 1))
    ctl.observe({0: 0.2, 1: 0.2})
    pending = ctl.stats()["holds_pending"]
    assert pending == 1
    ctl.observe({0: 0.3, 1: 0.3})
    assert ctl.stats()["holds_pending"] == pending
    for i in (0, 1):
        ctl.on_boundary(i, 20.0)
    assert ctl.stats()["holds_pending"] == 0 and ctl.stats()["holds_applied"] == 1
    ctl.observe({0: 0.3, 1: 0.3})
    assert ctl.stats()["holds_pending"] == 1


def test_stagger_membership_change_drops_holds():
    ctl = _stagger()
    _warm_walls(ctl, (0, 1))
    ctl.observe({0: 0.2, 1: 0.2})
    assert ctl.stats()["holds_pending"] == 1
    ctl.note_membership_change()
    s = ctl.stats()
    assert s["holds_pending"] == 0 and s["restaggers"] == 1
    ctl.forget(1)
    assert ctl.hold_frac(1) == 0.0


def test_stagger_no_wall_no_hold():
    ctl = _stagger()
    ctl.observe({0: 0.2, 1: 0.2})
    assert ctl.stats()["holds_pending"] == 0


def test_stagger_wall_ema_updates():
    ctl = _stagger()
    ctl.on_boundary(0, 0.0)
    ctl.on_boundary(0, 1.0)
    ctl.on_boundary(0, 4.0)
    ctl.on_boundary(1, 0.0)
    ctl.on_boundary(1, 1.0)
    ctl.observe({0: 0.5, 1: 0.5})
    assert 0.0 < max(ctl.hold_frac(0), ctl.hold_frac(1)) <= 0.5 + 1e-9


# ---------------------------------------------------------------------------
# FleetAutoscaler on a fake fleet
# ---------------------------------------------------------------------------

class _FakeFleet:
    """The surface FleetAutoscaler touches, with counted calls."""

    def __init__(self, population=2):
        self._population = population
        self.adds = self.removes = self.drains = 0

    def population(self):
        return self._population

    def add_replica(self):
        self.adds += 1
        self._population += 1
        return self._population - 1

    def remove_replica(self, idx=None, drain=True, timeout=None):
        self.removes += 1
        self._population -= 1
        return True

    def drains_in_flight(self):
        return self.drains

    def queue_frac(self):
        return 0.0

    def serving_engines(self):
        return []


class _Harness:
    """An autoscaler of ``mod`` on a fake fleet, its clock and samplers
    cranked by hand."""

    def __init__(self, population=2, replay_pending=False, mod=autoscale, cfg_cls=AutoscaleConfig,
                 **cfg_kw):
        self.cfg = cfg_cls(**{"enabled": True, "min": 1, "max": 4, "confirm_polls": 2,
                              "grow_cooldown_s": 5.0, "shrink_cooldown_s": 10.0, **cfg_kw})
        self.fleet = _FakeFleet(population)
        self.now = 100.0
        self.burn = (0.5, False)
        self.queue = 0.0
        self.shed = False
        self.auto = mod.FleetAutoscaler(
            self.fleet, self.cfg, clock=lambda: self.now, burn_sampler=lambda: self.burn,
            queue_sampler=lambda: self.queue, pressure_sampler=lambda: self.shed,
            replay_pending=replay_pending)


def test_grow_requires_consecutive_confirmation():
    h = _Harness(confirm_polls=3)
    h.burn = (2.0, False)
    assert h.auto.poll_once()["action"] == "hold"
    assert h.auto.poll_once()["action"] == "hold"
    h.burn = (0.0, False)
    assert h.auto.poll_once()["action"] == "hold"
    h.burn = (2.0, False)
    assert h.auto.poll_once()["action"] == "hold"
    assert h.auto.poll_once()["action"] == "hold"
    assert h.auto.poll_once()["action"] == "grow"
    assert h.fleet.adds == 1 and h.auto.stats()["target_replicas"] == 3


def test_falling_trend_vetoes_burn_grow_but_not_queue_grow():
    h = _Harness(confirm_polls=1)
    h.burn = (2.0, True)
    assert h.auto.poll_once()["action"] == "hold"
    assert h.fleet.adds == 0
    h.queue = 0.9
    assert h.auto.poll_once()["action"] == "grow"
    assert h.fleet.adds == 1


def test_grow_cooldown_blocks_then_releases():
    h = _Harness(confirm_polls=1, grow_cooldown_s=5.0)
    h.burn = (2.0, False)
    assert h.auto.poll_once()["action"] == "grow"
    assert h.auto.poll_once()["action"] == "blocked:grow_cooldown"
    assert h.fleet.adds == 1
    h.now += 6.0
    assert h.auto.poll_once()["action"] == "grow"
    assert h.fleet.adds == 2


def test_pressure_shed_interlock_and_latch():
    h = _Harness(confirm_polls=1)
    h.burn = (2.0, False)
    h.shed = True
    assert h.auto.poll_once()["action"] == "blocked:pressure_shed"
    assert h.fleet.adds == 0
    h.auto.poll_once()
    h.auto.poll_once()
    assert h.auto.stats()["blocked"] == 1
    h.shed = False
    assert h.auto.poll_once()["action"] == "grow"
    h.now += 100.0
    h.shed = True
    h.auto.poll_once()
    assert h.auto.stats()["blocked"] == 2


def test_at_max_is_blocked_not_silent():
    h = _Harness(population=4, confirm_polls=1)
    h.burn = (2.0, False)
    assert h.auto.poll_once()["action"] == "blocked:at_max"
    assert h.fleet.adds == 0


def test_shrink_confirms_and_acts():
    h = _Harness(population=3, confirm_polls=2)
    h.burn = (0.0, False)
    assert h.auto.poll_once()["action"] == "hold"
    assert h.auto.poll_once()["action"] == "shrink"
    assert h.fleet.removes == 1 and h.auto.stats()["target_replicas"] == 2


def test_shrink_at_min_is_silent_resting_state():
    h = _Harness(population=1, confirm_polls=1)
    h.burn = (0.0, False)
    for _ in range(3):
        assert h.auto.poll_once()["action"] == "hold"
    assert h.auto.stats()["blocked"] == 0 and h.fleet.removes == 0


def test_drain_in_flight_blocks_shrink():
    h = _Harness(population=3, confirm_polls=1)
    h.burn = (0.0, False)
    h.fleet.drains = 1
    assert h.auto.poll_once()["action"] == "blocked:drain_in_flight"
    assert h.fleet.removes == 0
    h.fleet.drains = 0
    assert h.auto.poll_once()["action"] == "shrink"


def test_replay_gate_blocks_both_directions_until_opened():
    h = _Harness(population=2, confirm_polls=1, replay_pending=True)
    h.burn = (2.0, False)
    assert h.auto.poll_once()["action"] == "blocked:replay_pending"
    h.burn = (0.0, False)
    assert h.auto.poll_once()["action"] == "blocked:replay_pending"
    assert h.fleet.adds == 0 and h.fleet.removes == 0
    h.auto.mark_replay_complete()
    h.burn = (2.0, False)
    assert h.auto.poll_once()["action"] == "grow"


def test_dry_run_journals_without_acting():
    h = _Harness(confirm_polls=1, dry_run=True, grow_cooldown_s=5.0)
    h.burn = (2.0, False)
    assert h.auto.poll_once()["action"] == "grow"
    assert h.fleet.adds == 0
    s = h.auto.stats()
    assert s["dry_run_decisions"] == 1 and s["grows"] == 0
    assert h.auto.poll_once()["action"] == "blocked:grow_cooldown"
    assert s["target_replicas"] == 2


def test_scale_race_loss_holds_until_next_poll():
    h = _Harness(population=3, confirm_polls=1)

    def boom(**kw):
        raise ValueError("cannot remove the last serving replica")

    h.fleet.remove_replica = boom
    h.burn = (0.0, False)
    assert h.auto.poll_once()["action"] == "hold"
    assert h.auto.stats()["shrinks"] == 0


def test_stats_exports_every_counter():
    h = _Harness()
    h.auto.poll_once()
    s = h.auto.stats()
    for key in ("enabled", "dry_run", "polls", "grows", "shrinks", "blocked", "poll_errors",
                "dry_run_decisions", "target_replicas", "min_replicas", "max_replicas",
                "grow_streak", "shrink_streak", "replay_pending", "last_burn_rate",
                "last_queue_frac"):
        assert key in s
    assert s["polls"] == 1


def _wait_for(cond, limit=FILE_LIMIT_S / 4):
    deadline = time.monotonic() + limit
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)


def test_daemon_poll_loop_runs_and_closes():
    h = _Harness(confirm_polls=1, poll_s=0.01)
    h.burn = (2.0, False)
    h.auto.start()
    _wait_for(lambda: h.fleet.adds >= 1)
    h.auto.close()
    assert h.fleet.adds >= 1 and h.auto._thread is None


def test_daemon_survives_sampler_exception():
    calls = []

    def flaky():
        calls.append(1)
        raise RuntimeError("sampler broke")

    h = _Harness(poll_s=0.01)
    h.auto._burn_sampler = flaky
    h.auto.start()
    _wait_for(lambda: len(calls) >= 3)
    h.auto.close()
    assert len(calls) >= 3
    # The JAX loop marks each failed poll with a trace instant; the port counts it.
    assert h.auto.stats()["poll_errors"] >= 3


# ---------------------------------------------------------------------------
# Both packages' controllers on one script
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_controllers_match_jax_on_one_script(seed):
    """A seeded 120-poll script of burn, trend, queue fraction, pressure,
    drains in flight, clock steps, config (dry run, confirmation, cooldowns)
    and the replay gate opening, fed to both packages' FleetAutoscaler; and
    a seeded script of boundaries, phase observations and membership
    changes fed to both StaggerControllers: the same decision record and
    stats after every poll, the same holds and stats after every step."""
    rng = np.random.default_rng(seed)
    kw = dict(confirm_polls=int(rng.integers(1, 4)), grow_cooldown_s=float(rng.integers(0, 8)),
              shrink_cooldown_s=float(rng.integers(0, 12)), dry_run=bool(seed == 3),
              min=1, max=int(rng.integers(2, 6)))
    pop = int(rng.integers(1, kw["max"] + 1))
    ours = _Harness(population=pop, replay_pending=True, **kw)
    theirs = _Harness(population=pop, replay_pending=True, mod=jautoscale,
                      cfg_cls=JAutoscaleConfig, **kw)
    for step in range(120):
        burn = (float(rng.choice([0.0, 0.1, 0.5, 1.0, 2.0])), bool(rng.random() < 0.2))
        queue, shed = float(rng.choice([0.0, 0.05, 0.5, 0.9])), bool(rng.random() < 0.1)
        drains, dt = int(rng.random() < 0.2), float(rng.choice([0.5, 1.0, 6.0]))
        for h in (ours, theirs):
            h.burn, h.queue, h.shed, h.fleet.drains = burn, queue, shed, drains
            h.now += dt
            if step == 10:
                h.auto.mark_replay_complete()
        a, b = ours.auto.poll_once(), theirs.auto.poll_once()
        assert a == b, step
        sa = ours.auto.stats()
        assert sa.pop("poll_errors") == 0
        assert sa == theirs.auto.stats(), step
        assert (ours.fleet.adds, ours.fleet.removes, ours.fleet.population()) == (
            theirs.fleet.adds, theirs.fleet.removes, theirs.fleet.population())

    cfg_kw = dict(enabled=True, stagger_tolerance=float(rng.choice([0.05, 0.15, 0.4])),
                  stagger_hold_max_frac=float(rng.choice([0.2, 0.5, 1.0])))
    ctl = StaggerController(AutoscaleConfig(**cfg_kw))
    jctl = jautoscale.StaggerController(JAutoscaleConfig(**cfg_kw))
    now = 0.0
    for step in range(200):
        op = rng.random()
        now += float(rng.random())
        if op < 0.5:
            idx = int(rng.integers(0, 4))
            assert ctl.on_boundary(idx, now) == jctl.on_boundary(idx, now), step
        elif op < 0.9:
            phases = {int(i): float(rng.random()) for i in rng.choice(4, int(rng.integers(0, 5)),
                                                                      replace=False)}
            assert ctl.observe(phases) == jctl.observe(phases), step
        elif op < 0.95:
            ctl.note_membership_change()
            jctl.note_membership_change()
        else:
            idx = int(rng.integers(0, 4))
            ctl.forget(idx)
            jctl.forget(idx)
        assert ctl.stats() == jctl.stats(), step
        assert [ctl.hold_frac(i) for i in range(4)] == [jctl.hold_frac(i) for i in range(4)]


# ---------------------------------------------------------------------------
# The config and the CLI
# ---------------------------------------------------------------------------

BAD_AUTOSCALE = [
    (dict(min=0), "min"),
    (dict(min=3, max=2), "max"),
    (dict(poll_s=0.0), "poll_s"),
    (dict(grow_burn_rate=0.5, shrink_burn_rate=0.6), "shrink_burn_rate"),
    (dict(grow_queue_frac=0.5, shrink_queue_frac=0.6), "shrink_queue_frac"),
    (dict(confirm_polls=0), "confirm_polls"),
    (dict(stagger_tolerance=0.0), "stagger_tolerance"),
    (dict(stagger_hold_max_frac=1.5), "stagger_hold_max_frac"),
]


def test_autoscale_config_validation():
    for kw, match in BAD_AUTOSCALE:
        with pytest.raises(ValueError, match=match) as ours:
            AutoscaleConfig(**kw)
        with pytest.raises(ValueError) as theirs:
            JAutoscaleConfig(**kw)
        assert str(ours.value) == str(theirs.value)
    assert dataclasses.asdict(AutoscaleConfig()) == dataclasses.asdict(JAutoscaleConfig())


def test_serve_config_replicas_must_sit_inside_autoscale_band():
    with pytest.raises(ValueError, match="autoscale") as ours:
        ServeConfig(replicas=5, autoscale=AutoscaleConfig(enabled=True, min=1, max=4))
    with pytest.raises(ValueError) as theirs:
        JServeConfig(replicas=5, autoscale=JAutoscaleConfig(enabled=True, min=1, max=4))
    assert str(ours.value) == str(theirs.value)
    ServeConfig(replicas=5, autoscale=AutoscaleConfig(min=1, max=4))


def test_cli_serve_wants_fleet_whenever_elasticity_is_on():
    for mod, sc, ac in ((cli, ServeConfig, AutoscaleConfig),
                        (jcli, JServeConfig, JAutoscaleConfig)):
        assert not mod._serve_wants_fleet(sc(replicas=1))
        assert mod._serve_wants_fleet(sc(replicas=2))
        assert mod._serve_wants_fleet(sc(replicas=1, autoscale=ac(enabled=True)))
        assert not mod._serve_wants_fleet(sc(replicas=1, autoscale=ac()))
