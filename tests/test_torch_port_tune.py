"""The port's closed-loop autotuner (``horovod_tpu_torch.tune``), held
against the JAX package's (``horovod_tpu.tune``, the twin of
``tests/test_tune.py``).

The GP/EI against the C++ fixture at 1e-9, knob registry typing, the
deterministic search and its journal round trip, the lockstep rollout
protocol over a fake KV (2 workers, no mixed vectors), the
``make_train_step`` wrapper on GPT-2 tiny and a small regression, the
serve tuner and ``ServePool(autotune=)``, the ``hvdtpu_top`` panel, the
elastic driver's journaled rollout and the ``autotune`` soak. Across the
two packages: the same GP predictions and candidate draws (exact), the
same candidate sequence from one scripted score feed (exact), a JAX
coordinator driving port clients over one KV and the other way round, and
GPT-2 tiny's trial vectors equal to the JAX search's for the same seed
and scores. Tolerances: the fixture at 1e-9 (abs for mean/sd, rel for
EI); everything else exact.
"""

import json
import math
import os

import pytest

from horovod_tpu_torch import tune
from horovod_tpu_torch.tune import gp as _gp
from horovod_tpu_torch.tune import rollout as _ro
from horovod_tpu_torch.tune import topology as _topo
from horovod_tpu_torch.tune.knobs import Knob, KnobRegistry
from horovod_tpu_torch.utils import env as _env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "gp_parity.json")


@pytest.fixture(autouse=True)
def _restore_env():
    """Knob application mutates os.environ (that IS the mechanism);
    nothing may leak into other tests' env-default reads."""
    snap = dict(os.environ)
    yield
    for k in list(os.environ):
        if k not in snap:
            del os.environ[k]
    for k, v in snap.items():
        if os.environ.get(k) != v:
            os.environ[k] = v


# ---------------------------------------------------------------------------
# GP / EI parity with csrc/parameter_manager.cc
# ---------------------------------------------------------------------------


class TestGpParity:
    def _fixture(self):
        with open(FIXTURE) as f:
            return json.load(f)

    def test_predict_matches_cc(self):
        fx = self._fixture()
        g = _gp.GaussianProcess()
        g.fit(fx["observations_x"], fx["observations_y"])
        for cand, want in zip(fx["candidates"], fx["predictions"]):
            mean, sd = g.predict(cand)
            assert mean == pytest.approx(want["mean"], abs=1e-9)
            assert sd == pytest.approx(want["sd"], abs=1e-9)

    def test_ei_and_argmax_match_cc(self):
        """Same observations -> same next candidate (the pinning claim)."""
        fx = self._fixture()
        g = _gp.GaussianProcess()
        g.fit(fx["observations_x"], fx["observations_y"])
        idx, eis = _gp.best_by_ei(g, fx["y_best"], fx["candidates"])
        assert idx == fx["argmax"]
        for got, want in zip(eis, fx["predictions"]):
            if want["ei"] is None:
                assert math.isnan(got)
            else:
                assert got == pytest.approx(want["ei"], rel=1e-9)

    def test_sd_zero_guard_skips_not_poisons(self):
        """The PR-1 guard: a zero-sd candidate is skipped (nan in the EI
        list, never the argmax) instead of inf/NaN-poisoning the pick."""

        class Degenerate(_gp.GaussianProcess):
            def predict(self, x):
                if x[0] == 0.5:
                    return 10.0, 0.0  # on top of an observation
                return 0.0, 1.0

        idx, eis = _gp.best_by_ei(
            Degenerate(), 0.0, [[0.5, 0.5], [0.2, 0.2]]
        )
        assert idx == 1
        assert math.isnan(eis[0]) and not math.isnan(eis[1])

    def test_all_guarded_returns_none(self):
        class Flat(_gp.GaussianProcess):
            def predict(self, x):
                return 1.0, 0.0

        idx, eis = _gp.best_by_ei(Flat(), 0.0, [[0.1], [0.9]])
        assert idx is None and all(math.isnan(e) for e in eis)

    def test_unfitted_prior(self):
        g = _gp.GaussianProcess()
        mean, sd = g.predict([0.3, 0.7])
        assert mean == 0.0 and sd == pytest.approx(1.0)

    def test_candidates_pure_function_of_seed_and_trial(self):
        a = _gp.candidates_for_trial(7, 3, 4)
        b = _gp.candidates_for_trial(7, 3, 4)
        c = _gp.candidates_for_trial(7, 4, 4)
        assert a == b and a != c
        assert len(a) == _gp.N_CANDIDATES and len(a[0]) == 4
        assert all(0.0 <= v <= 1.0 for row in a for v in row)


# ---------------------------------------------------------------------------
# Knob registry
# ---------------------------------------------------------------------------


def _small_registry(**kw):
    return KnobRegistry([
        Knob(_env.FUSION_THRESHOLD, "log_int", lo=1 << 20, hi=512 << 20,
             default=128 << 20, requires_retrace=True),
        Knob(_env.PREFETCH_DEPTH, "int", lo=1, hi=4, default=2),
        Knob(_env.OVERLAP_STAGGER, "bool", default=True,
             requires_retrace=True),
        Knob(_env.COLLECTIVE_LAYOUT, "choice",
             choices=("flat", "hierarchical"), default="flat",
             requires_retrace=True),
    ])


class TestKnobs:
    def test_log_unit_round_trip(self):
        k = Knob(_env.FUSION_THRESHOLD, "log_int", lo=1 << 20,
                 hi=512 << 20, default=128 << 20)
        assert k.from_unit(k.to_unit(128 << 20)) == 128 << 20
        assert k.from_unit(0.0) == 1 << 20
        assert k.from_unit(1.0) == 512 << 20

    def test_choice_and_bool_quantize(self):
        k = Knob(_env.COLLECTIVE_LAYOUT, "choice",
                 choices=("flat", "hierarchical"), default="flat")
        assert k.from_unit(0.2) == "flat"
        assert k.from_unit(0.9) == "hierarchical"
        assert k.to_unit("hierarchical") == 1.0
        b = Knob(_env.OVERLAP_STAGGER, "bool", default=True)
        assert b.from_unit(0.1) is False and b.from_unit(0.8) is True

    def test_undeclared_knob_rejected(self):
        with pytest.raises(ValueError, match="not declared"):
            KnobRegistry([
                Knob("TOTALLY_NOT_A_KNOB", "int", lo=0, hi=1, default=0)
            ])

    def test_apply_writes_env_and_setters(self):
        reg = _small_registry()
        seen = {}
        vec = {
            _env.FUSION_THRESHOLD: 1 << 21, _env.PREFETCH_DEPTH: 3,
            _env.OVERLAP_STAGGER: False, _env.COLLECTIVE_LAYOUT: "flat",
        }
        reg.apply(
            vec, setters={_env.PREFETCH_DEPTH: lambda v: seen.update(d=v)}
        )
        assert os.environ["HVDTPU_FUSION_THRESHOLD"] == str(1 << 21)
        assert os.environ["HVDTPU_OVERLAP_STAGGER"] == "0"
        assert seen["d"] == 3
        # The env round-trips through the real accessors.
        assert _env.fusion_threshold_bytes() == 1 << 21
        assert _env.overlap_stagger() is False

    def test_canonical_idempotent(self):
        reg = _small_registry()
        v = reg.canonical(reg.default_vector())
        assert reg.canonical(v) == v

    def test_retrace_changed(self):
        reg = _small_registry()
        a = reg.canonical(reg.default_vector())
        b = dict(a, **{_env.PREFETCH_DEPTH: 4})
        assert not reg.retrace_changed(a, b)  # cheap knob only
        c = dict(a, **{_env.FUSION_THRESHOLD: 1 << 21})
        assert reg.retrace_changed(a, c)
        assert not reg.retrace_changed(None, c)  # first apply

    def test_training_space_subset_validation(self):
        with pytest.raises(ValueError, match="unknown knob"):
            tune.training_space(subset=("NOPE",))

    def test_training_space_pinned(self):
        reg = tune.training_space(
            pinned=(_env.FUSION_THRESHOLD,),
            subset=(_env.FUSION_THRESHOLD, _env.PREFETCH_DEPTH),
        )
        assert reg.names == [_env.PREFETCH_DEPTH]

    def test_training_space_default_selection(self):
        # Vanilla build (overlap off): only the always-consumed knob.
        assert tune.training_space().names == [_env.FUSION_THRESHOLD]
        # Overlap armed via env: stagger becomes a live knob.
        os.environ["HVDTPU_OVERLAP"] = "1"
        assert set(tune.training_space().names) == {
            _env.FUSION_THRESHOLD, _env.OVERLAP_STAGGER,
        }
        del os.environ["HVDTPU_OVERLAP"]
        # The opt-in catalog knobs stay subset-addressable.
        reg = tune.training_space(subset=(
            _env.COLLECTIVE_LAYOUT, _env.PREFETCH_DEPTH,
        ))
        assert set(reg.names) == {
            _env.COLLECTIVE_LAYOUT, _env.PREFETCH_DEPTH,
        }

    def test_empty_space_raises(self):
        with pytest.raises(ValueError, match="empty"):
            tune.serve_space(pinned=(
                _env.SERVE_BATCH_TIMEOUT_MS, _env.SERVE_QUEUE_HIGH,
                _env.SERVE_QUEUE_LOW,
            ))


class TestTopology:
    def test_env_pin_wins(self):
        os.environ["HVDTPU_COLLECTIVE_LAYOUT"] = "hierarchical"
        assert _topo.choose_layout({"dp": 8}) == "hierarchical"

    def test_single_level_flat(self):
        assert _topo.choose_layout({"dp": 8}) == "flat"

    def test_two_level_by_cross_fraction(self):
        shape = {"dp": 4, "dcn": 2}
        assert _topo.choose_layout(
            shape, cross_axes=("dcn",), cross_bytes_fraction=0.25
        ) == "hierarchical"
        assert _topo.choose_layout(
            shape, cross_axes=("dcn",), cross_bytes_fraction=0.05
        ) == "flat"

    def test_two_level_estimates_from_shape(self):
        # local 4 -> implied fraction 0.25 >= breakeven.
        assert _topo.choose_layout(
            {"dp": 4, "dcn": 2}, cross_axes=("dcn",)
        ) == "hierarchical"

    def test_layout_env_typo_raises(self):
        os.environ["HVDTPU_COLLECTIVE_LAYOUT"] = "ring"
        with pytest.raises(ValueError, match="COLLECTIVE_LAYOUT"):
            _env.collective_layout()


# ---------------------------------------------------------------------------
# Search engine: determinism, convergence, durability
# ---------------------------------------------------------------------------


def _bowl_score(reg, vector, optimum=0.35):
    u = reg.to_unit(vector)
    return -(100.0 + 50.0 * sum((ui - optimum) ** 2 for ui in u))


class TestSearch:
    def test_trial_zero_is_default(self):
        reg = _small_registry()
        s = tune.AutotuneSearch(reg, seed=3)
        assert s.propose() == reg.canonical(reg.default_vector())

    def test_deterministic_resume_from_state(self):
        reg = _small_registry()
        a = tune.AutotuneSearch(reg, seed=11, max_trials=8, patience=8)
        proposals = []
        for _ in range(6):
            v = a.propose()
            proposals.append(v)
            a.record(v, _bowl_score(reg, v))
        # Resume a FRESH search from the state after 3 trials; its
        # remaining proposals must replay the original's exactly.
        b = tune.AutotuneSearch(reg, seed=0)
        c = tune.AutotuneSearch(reg, seed=11, max_trials=8, patience=8)
        for v, y in zip(proposals[:3], [_bowl_score(reg, p) for p in proposals[:3]]):
            c.record(v, y)
        b.load_state_dict(c.state_dict())
        for want in proposals[3:]:
            got = b.propose()
            assert got == want
            b.record(got, _bowl_score(reg, got))

    def test_patience_convergence_and_best(self):
        reg = _small_registry()
        s = tune.AutotuneSearch(reg, seed=5, max_trials=50, patience=2)
        best = None
        while not s.done:
            v = s.propose()
            y = _bowl_score(reg, v)
            s.record(v, y)
            if best is None or y > best[1]:
                best = (v, y)
        assert s.best_vector() == reg.canonical(best[0])
        assert s.best_score == best[1]

    def test_max_trials_cap(self):
        reg = _small_registry()
        s = tune.AutotuneSearch(reg, seed=5, max_trials=3, patience=99)
        while not s.done:
            v = s.propose()
            s.record(v, _bowl_score(reg, v))
        assert s.n_trials == 3

    def test_state_dict_space_mismatch_raises(self):
        reg = _small_registry()
        s = tune.AutotuneSearch(reg, seed=1)
        state = s.state_dict()
        state["knobs"] = ["SOMETHING_ELSE"]
        with pytest.raises(ValueError, match="does not match"):
            tune.AutotuneSearch(reg, seed=1).load_state_dict(state)

    def test_journal_round_trip(self, tmp_path):
        """Search state → ControlPlaneJournal driver record → recover →
        identical remaining proposal sequence (the adoption contract)."""
        from horovod_tpu_torch.runner.journal import ControlPlaneJournal

        reg = _small_registry()
        a = tune.AutotuneSearch(reg, seed=9, max_trials=8, patience=8)
        for _ in range(3):
            v = a.propose()
            a.record(v, _bowl_score(reg, v))
        j = ControlPlaneJournal(str(tmp_path / "j"))
        j.record_driver({"autotune": {"search": a.state_dict()}})
        j.close()
        _, state = ControlPlaneJournal(str(tmp_path / "j")).recover()
        b = tune.AutotuneSearch(reg, seed=0)
        b.load_state_dict(state["autotune"]["search"])
        for _ in range(3):
            want = a.propose()
            got = b.propose()
            assert got == want
            a.record(want, _bowl_score(reg, want))
            b.record(got, _bowl_score(reg, got))


# ---------------------------------------------------------------------------
# Scoring plane
# ---------------------------------------------------------------------------


class TestScoring:
    def test_warmup_discard_then_window_mean(self):
        s = tune.WindowScorer(window_steps=3, warmup_steps=2)
        vals = [100, 100, 10, 20, 30]  # first two discarded
        out = [s.add(v) for v in vals]
        assert out[:4] == [None, None, None, None]
        assert out[4] == pytest.approx(-20.0)

    def test_reset_restarts_warmup(self):
        s = tune.WindowScorer(window_steps=1, warmup_steps=1)
        assert s.add(5) is None
        assert s.add(7) == -7
        s.reset()
        assert s.add(9) is None  # warmup again after a switch
        assert s.add(4) == -4

    def test_higher_is_better_sign(self):
        s = tune.WindowScorer(window_steps=2, warmup_steps=0, sign=1.0)
        s.add(0.5)
        assert s.add(0.7) == pytest.approx(0.6)

    def test_serve_latency_scorer(self):
        class FakeHist:
            def __init__(self):
                self.count = 0
                self.p95 = 0.0

            def summary(self):
                return {"count": self.count, "p95": self.p95}

        h = FakeHist()
        s = tune.ServeLatencyScorer(
            window_responses=4, warmup_responses=2, histogram=h
        )
        h.count, h.p95 = 3, 9.0
        assert s.poll() is None  # 3 < 2 + 4
        h.count, h.p95 = 6, 7.5
        assert s.poll() == -7.5
        s.reset()
        assert s.poll() is None  # base moved to 6


# ---------------------------------------------------------------------------
# Rollout protocol (coordinator + clients over a fake KV)
# ---------------------------------------------------------------------------


class FakeStore:
    """Dict-backed stand-in for both RendezvousServer (put/scope_items)
    and RendezvousClient (get/put)."""

    def __init__(self):
        self.data = {}
        self.drop_next_puts = 0

    def put(self, scope, key, value):
        if self.drop_next_puts > 0:
            self.drop_next_puts -= 1
            raise OSError("chaos: dropped KV put")
        self.data[(scope, key)] = bytes(value)

    def get(self, scope, key):
        return self.data.get((scope, key))

    def scope_items(self, scope):
        return {k: v for (s, k), v in self.data.items() if s == scope}


def _protocol_parts(seed=13, max_trials=4, patience=3, hosts=("a", "b")):
    reg = _small_registry()
    coord = _ro.RolloutCoordinator(
        reg,
        search=tune.AutotuneSearch(
            reg, seed=seed, max_trials=max_trials, patience=patience
        ),
    )
    store = FakeStore()
    clients = {
        h: _ro.AutotuneClient(
            reg, _ro.KVConfigSource(store, h),
            scorer=tune.WindowScorer(window_steps=2, warmup_steps=1),
        )
        for h in hosts
    }
    return reg, coord, store, clients


def _drive(reg, coord, store, clients, max_steps=400):
    """Simulated lockstep training loop; returns per-step applied
    vectors for the mixed-vector assertion."""
    hosts = list(clients)
    coord.poll(store, hosts)  # publish trial 0
    per_step = []
    for _ in range(max_steps):
        for c in clients.values():
            c.step_start()
        per_step.append({
            h: None if c.applied is None else dict(c.applied)
            for h, c in clients.items()
        })
        for c in clients.values():
            vec = c.applied or reg.canonical(reg.default_vector())
            c.step_end(-_bowl_score(reg, vec) / 1e3)
        coord.poll(store, hosts)
        if all(c.done for c in clients.values()):
            break
    return per_step


class TestRollout:
    def test_two_worker_lockstep_no_mixed_vector(self):
        reg, coord, store, clients = _protocol_parts()
        per_step = _drive(reg, coord, store, clients)
        assert all(c.done for c in clients.values())
        # No step anywhere ran a mixed vector across ranks.
        for step_no, applied in enumerate(per_step):
            vals = list(applied.values())
            assert vals[0] == vals[1], (
                f"step {step_no} ran a mixed vector: {applied}"
            )
        # Every switch landed at the identical step boundary.
        a, b = clients.values()
        assert [(s, t) for s, t, _ in a.switch_log] == [
            (s, t) for s, t, _ in b.switch_log
        ]
        # Switches were on-time (the published boundary, never late).
        assert all(
            rec[0] >= 0 for rec in a.switch_log
        ) and a.switch_log[0][0] == 0

    def test_converges_to_bowl_optimum_neighborhood(self):
        """Deterministic fake-gauge convergence: with a smooth bowl the
        winner must beat the default vector's score."""
        reg, coord, store, clients = _protocol_parts(max_trials=8,
                                                     patience=8)
        _drive(reg, coord, store, clients, max_steps=800)
        hist = coord.search.history()
        assert len(hist) == 8
        default_score = hist[0][1]
        assert coord.search.best_score >= default_score
        # All ranks settled on the coordinator's winner.
        for c in clients.values():
            assert c.applied == coord.search.best_vector()

    def test_retrace_switch_requests_republish(self):
        reg, coord, store, clients = _protocol_parts(max_trials=6,
                                                     patience=6)
        hosts = list(clients)
        coord.poll(store, hosts)
        republishes = 0
        for _ in range(600):
            for c in clients.values():
                c.step_start()
            for c in clients.values():
                vec = c.applied or reg.canonical(reg.default_vector())
                c.step_end(-_bowl_score(reg, vec) / 1e3)
            if coord.poll(store, hosts):
                republishes += 1
            if all(c.done for c in clients.values()):
                break
        # The space is dominated by retrace knobs (threshold, stagger,
        # layout): some candidate transition must have flipped one.
        assert republishes >= 1

    def test_lost_score_report_rereported(self):
        reg, coord, store, clients = _protocol_parts()
        hosts = list(clients)
        coord.poll(store, hosts)
        # Swallow the next 2 puts (both ranks' first window reports).
        store.drop_next_puts = 2
        for _ in range(400):
            for c in clients.values():
                c.step_start()
            for c in clients.values():
                vec = c.applied or reg.canonical(reg.default_vector())
                c.step_end(-_bowl_score(reg, vec) / 1e3)
            coord.poll(store, hosts)
            if all(c.done for c in clients.values()):
                break
        assert all(c.done for c in clients.values())
        assert coord.search.done

    def test_coordinator_state_round_trip_mid_search(self):
        """Kill the coordinator after N trials; an adopted twin loaded
        from its state_dict finishes the search with the IDENTICAL
        remaining candidates and final vector (fault-free reference)."""
        # Reference run, no interruption.
        reg, coord_ref, store_ref, clients_ref = _protocol_parts(
            max_trials=5, patience=5
        )
        _drive(reg, coord_ref, store_ref, clients_ref, max_steps=600)
        want_final = coord_ref.search.best_vector()
        want_trials = coord_ref.search.n_trials

        # Interrupted run: stop after 2 recorded trials, adopt.
        reg2, coord_a, store, clients = _protocol_parts(
            max_trials=5, patience=5
        )
        hosts = list(clients)
        coord_a.poll(store, hosts)
        while coord_a.search.n_trials < 2:
            for c in clients.values():
                c.step_start()
            for c in clients.values():
                vec = c.applied or reg2.canonical(reg2.default_vector())
                c.step_end(-_bowl_score(reg2, vec) / 1e3)
            coord_a.poll(store, hosts)
        state = coord_a.state_dict()  # what the journal holds

        coord_b = _ro.RolloutCoordinator(
            reg2,
            search=tune.AutotuneSearch(reg2, seed=0),
        )
        coord_b.load_state_dict(state)
        assert coord_b.search.n_trials == 2  # adopted, not re-learned
        for _ in range(600):
            for c in clients.values():
                c.step_start()
            for c in clients.values():
                vec = c.applied or reg2.canonical(reg2.default_vector())
                c.step_end(-_bowl_score(reg2, vec) / 1e3)
            coord_b.poll(store, hosts)
            if all(c.done for c in clients.values()):
                break
        assert coord_b.search.n_trials == want_trials
        assert coord_b.search.best_vector() == want_final

    def test_fresh_client_adopts_live_candidate_immediately(self):
        """A worker respawned mid-search (step counter restarted, no
        applied vector) must adopt the live candidate at once instead
        of waiting out a boundary hundreds of steps ahead."""
        reg, coord, store, clients = _protocol_parts()
        hosts = list(clients)
        coord.poll(store, hosts)
        store.put("autotune", "config", json.dumps({
            "trial": 4,
            "vector": reg.canonical(reg.default_vector()),
            "switch_step": 500, "done": False,
        }).encode())
        joiner = _ro.AutotuneClient(
            reg, _ro.KVConfigSource(store, "late"),
            scorer=tune.WindowScorer(window_steps=2, warmup_steps=1),
        )
        act = joiner.step_start()
        assert act is not None and joiner.applied_trial == 4
        # An ESTABLISHED client (applied trial 0 before the new config
        # existed) still honors the boundary.
        reg2, coord2, store2, clients2 = _protocol_parts()
        coord2.poll(store2, list(clients2))
        b = list(clients2.values())[0]
        b.step_start()  # applies trial 0 at step 0 (switch_step 0)
        assert b.applied_trial == 0
        store2.put("autotune", "config", json.dumps({
            "trial": 5,
            "vector": reg2.canonical(reg2.default_vector()),
            "switch_step": 500, "done": False,
        }).encode())
        b.step_end(0.001)
        assert b.step_start() is None  # boundary not reached
        assert b.applied_trial == 0

    def test_journal_runs_before_publish_and_adoption_republishes(self):
        """Crash window between journal and KV publish: the journaled
        view may be AHEAD of the store but never behind; the adopter's
        first poll re-puts the journaled doc so both views re-align."""
        reg, coord, store, clients = _protocol_parts()
        hosts = list(clients)
        journal_states = []
        coord.poll(store, hosts,
                   journal=lambda: journal_states.append(
                       json.dumps(coord.state_dict(), sort_keys=True)))
        assert journal_states, "publish did not journal first"
        # Drive one full trial so the coordinator wants to publish
        # trial 1 — but the KV put crashes (journal already ran).
        for _ in range(50):
            for c in clients.values():
                c.step_start()
            for c in clients.values():
                vec = c.applied or reg.canonical(reg.default_vector())
                c.step_end(-_bowl_score(reg, vec) / 1e3)
            if len(coord._read_scores(store, hosts)) == len(hosts):
                break
        store.drop_next_puts = 1
        with pytest.raises(OSError):
            coord.poll(store, hosts, journal=lambda: None)
        # The store still holds trial 0's config; the journaled state
        # holds trial 1 (ahead, never behind).
        stale = json.loads(store.get("autotune", "config").decode())
        assert stale["trial"] == 0
        state = coord.state_dict()
        assert state["trial"] == 1 and state["last_doc"]["trial"] == 1
        # Adoption: the heal re-puts the journaled doc verbatim.
        coord2 = _ro.RolloutCoordinator(
            reg, search=tune.AutotuneSearch(reg, seed=0)
        )
        coord2.load_state_dict(state)
        coord2.poll(store, hosts, journal=lambda: None)
        healed = json.loads(store.get("autotune", "config").decode())
        assert healed["trial"] == 1

    def test_retrace_candidate_gated_on_round(self):
        """A retrace candidate published with a round rides the rejoin
        boundary: the client applies when its joined round reaches it
        (counter boundaries can't skew across respawned workers), and
        the counter realigns to 0 at the switch."""
        reg = _small_registry()
        store = FakeStore()
        round_box = [0]
        c = _ro.AutotuneClient(
            reg, _ro.KVConfigSource(store, "a"),
            scorer=tune.WindowScorer(window_steps=2, warmup_steps=1),
            round_provider=lambda: round_box[0],
        )
        base = reg.canonical(reg.default_vector())
        store.put("autotune", "config", json.dumps({
            "trial": 0, "vector": base, "switch_step": 0, "done": False,
            "round": None,
        }).encode())
        c.step_start()
        assert c.applied_trial == 0
        # Retrace candidate for round 1; counter boundary already met,
        # but the round has not advanced -> not applied.
        nxt = dict(base, **{_env.FUSION_THRESHOLD: 1 << 21})
        store.put("autotune", "config", json.dumps({
            "trial": 1, "vector": nxt, "switch_step": 0, "done": False,
            "round": 1,
        }).encode())
        for _ in range(5):
            c.step_end(0.001)
            assert c.step_start() is None or c.applied_trial == 0
        assert c.applied_trial == 0
        round_box[0] = 1  # the republish landed; every rank rejoined
        act = c.step_start()
        assert act is not None and act.retrace
        assert c.applied_trial == 1
        assert c.step == 0  # counters realigned at the rejoin boundary

    def test_coordinator_embeds_round_only_for_retrace(self):
        reg, coord, store, clients = _protocol_parts(max_trials=6,
                                                     patience=6)
        hosts = list(clients)
        coord.poll(store, hosts, round_=7)
        doc0 = json.loads(store.get("autotune", "config").decode())
        assert doc0["round"] is None  # trial 0: nothing to retrace from
        # Drive trials; every published retrace candidate must carry
        # round_+1, cheap ones None.
        for _ in range(400):
            for c in clients.values():
                c.step_start()
            for c in clients.values():
                vec = c.applied or reg.canonical(reg.default_vector())
                c.step_end(-_bowl_score(reg, vec) / 1e3)
            retrace = coord.poll(store, hosts, round_=7)
            doc = json.loads(store.get("autotune", "config").decode())
            if retrace:
                assert doc["round"] == 8
                break
        else:
            pytest.fail("no retrace candidate was ever published")

    def test_stale_trial_scores_ignored(self):
        reg, coord, store, clients = _protocol_parts()
        hosts = list(clients)
        coord.poll(store, hosts)
        # A leftover score from a previous trial number must not count.
        store.put("autotune", "score/a",
                  json.dumps({"trial": 99, "score": 1.0, "step": 1}).encode())
        assert coord.poll(store, hosts) is False
        assert coord.search.n_trials == 0


# ---------------------------------------------------------------------------
# make_train_step(autotune=...) wrapper
# ---------------------------------------------------------------------------


def _mlp():
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    params = {"w": torch.from_numpy((rng.randn(8, 4) * 0.1).astype(
        np.float32))}
    x = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 4, 16).astype(np.int64))

    def loss_fn(p, b):
        xx, yy = b
        return torch.nn.functional.cross_entropy(xx @ p["w"], yy)

    return params, (x, y), loss_fn


class TestTrainStepWrapper:
    def test_end_to_end_convergence_and_rebuild(self):
        import torch

        from horovod_tpu_torch import optimizer as topt
        from horovod_tpu_torch.parallel import dp

        params, batch, loss_fn = _mlp()
        cfg = tune.AutotuneConfig(
            window_steps=2, warmup_steps=1, max_trials=3, patience=3,
            seed=7,
        )
        step, opt = dp.make_train_step(
            loss_fn, topt.adamw(1e-3), autotune=cfg, device="cpu"
        )
        state = dp.init_state(params, opt)
        for _ in range(80):
            state, loss = step(state, batch)
            if step.autotune.done:
                break
        assert step.autotune.done
        assert step.autotune.best is not None
        assert bool(torch.isfinite(loss))
        # Local (driverless) mode ran a real search.
        assert step.autotune.source.search.n_trials == 3
        # Trial 0 was the incumbent default vector.
        hist = step.autotune.source.search.history()
        reg = step.registry
        assert hist[0][0] == reg.canonical(reg.default_vector())
        # Every switch that moved the (retrace) threshold rebuilt the step.
        log = step.autotune.switch_log
        assert step._n_retraces == sum(
            1 for a, b in zip(log, log[1:]) if a[2] != b[2])

    def test_retrace_rebuild_runs_tagged_preflight(self):
        """A retrace switch rebuilds the inner step and re-certifies it
        once, under the retraceN tag, its first-call latch set first (the
        JAX package's order)."""
        calls = []

        class Inner:
            def __init__(self):
                self._cert_latch = {"done": False}

            def preflight(self, state, batch, tag=""):
                calls.append((tag, self._cert_latch["done"]))

            def __call__(self, state, batch):
                return state, 0.0

        class Client:
            done = True  # no synchronize

            def __init__(self):
                self._acts = [
                    tune.SwitchAction(vector={}, retrace=True, done=False)
                ]

            def step_start(self):
                return self._acts.pop() if self._acts else None

            def step_end(self, dt):
                pass

        inners = []

        def build():
            inner = Inner()
            inners.append(inner)
            return inner, "opt"

        step = tune.AutotunedStep(build, None, Client())
        step("state", "batch")
        step("state", "batch")  # no action: no second rebuild
        assert len(inners) == 2  # initial build + the retrace rebuild
        assert step._n_retraces == 1
        assert calls == [("retrace1", True)]

    def test_caller_pin_empties_space_builds_untuned(self):
        """Explicit threshold_bytes= pins the only live knob of a
        vanilla (overlap-off) build: the step comes back PLAIN with a
        warning, not wrapped around an empty search."""
        from horovod_tpu_torch import optimizer as topt
        from horovod_tpu_torch.parallel import dp

        params, batch, loss_fn = _mlp()
        cfg = tune.AutotuneConfig(window_steps=1, warmup_steps=0,
                                  max_trials=1, patience=1)
        with pytest.warns(UserWarning, match="search space is empty"):
            step, opt = dp.make_train_step(
                loss_fn, topt.adamw(1e-3), autotune=cfg,
                threshold_bytes=1 << 20, device="cpu",
            )
        assert not hasattr(step, "autotune")
        state = dp.init_state(params, opt)
        state, loss = step(state, batch)  # plain step still trains

    @pytest.mark.parametrize("kw", [
        dict(sharded=True), dict(fused_update=True, sharded=True),
        dict(compression="int8"),
    ], ids=["sharded", "fused", "quant_ef"])
    def test_structure_locked_pins_threshold(self, kw):
        from horovod_tpu_torch import optimizer as topt
        from horovod_tpu_torch.ops.compression import Compression
        from horovod_tpu_torch.parallel import dp

        if kw.get("compression") == "int8":
            kw = dict(compression=Compression.int8)
        params, batch, loss_fn = _mlp()
        cfg = tune.AutotuneConfig(
            window_steps=1, warmup_steps=0, max_trials=1, patience=1,
            knobs=(_env.FUSION_THRESHOLD, _env.PREFETCH_DEPTH),
        )
        step, _ = dp.make_train_step(
            loss_fn, topt.fused_adamw(1e-3) if kw.get("fused_update")
            else topt.adamw(1e-3), autotune=cfg, device="cpu", **kw,
        )
        # The optimizer state's layout depends on the bucket geometry:
        # the fusion threshold must not move mid-run; the rest of the
        # requested space survives.
        assert step.registry.names == [_env.PREFETCH_DEPTH]

    def test_elastic_conflict_raises(self, monkeypatch):
        """Under an elastic driver a build pin that sits in the
        coordinator's shared space raises instead of degrading."""
        from horovod_tpu_torch import optimizer as topt
        from horovod_tpu_torch.elastic import worker as _ew
        from horovod_tpu_torch.parallel import dp

        monkeypatch.setattr(_ew, "tune_config_source",
                            lambda: _ro.KVConfigSource(FakeStore(), "a"))
        _, _, loss_fn = _mlp()
        with pytest.raises(ValueError, match="pinned by this build"):
            dp.make_train_step(loss_fn, topt.adamw(1e-3), autotune=True,
                               threshold_bytes=1 << 20, device="cpu")


def _scripted_ms(reg, vector):
    """A deterministic step time for a vector (a bowl in the unit cube)."""
    u = reg.to_unit(vector)
    return 100.0 + 50.0 * sum((ui - 0.35) ** 2 for ui in u)


class _ScriptedScorer(tune.WindowScorer):
    """A WindowScorer fed the scripted time of the applied vector instead
    of the measured one."""

    def __init__(self, client_box, reg, **kw):
        super().__init__(**kw)
        self._box = client_box
        self._reg = reg

    def add(self, value):
        return super().add(_scripted_ms(self._reg, self._box[0].applied))


def _gpt2_tiny_run(autotune, n_steps=40):
    """GPT-2 tiny (fp32, plain attention) through make_train_step(
    autotune=...) on the CPU, ``n_steps`` steps or until the search is
    done; returns the step, the steps run and the trained parameters."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch import optimizer as topt
    from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
    from horovod_tpu_torch.parallel import dp

    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (4, 33)).astype(np.int64))
    torch.manual_seed(0)
    model = GPT2LMModel(GPT2Config.tiny(dtype=torch.float32,
                                        use_flash=False), device="cpu")

    def loss_fn(p, t):
        logits = torch.func.functional_call(model, p, (t[:, :-1],))
        return F.cross_entropy(logits.flatten(0, 1), t[:, 1:].flatten())

    step, opt = dp.make_train_step(loss_fn, topt.adamw(1e-3),
                                   autotune=autotune, device="cpu")
    if autotune:
        step.autotune.scorer = _ScriptedScorer(
            [step.autotune], step.registry, window_steps=2, warmup_steps=1)
    state = dp.init_state(model, opt)
    n = 0
    while n < n_steps and not (autotune and step.autotune.done):
        state, loss = step(state, tokens)
        assert bool(torch.isfinite(loss))
        n += 1
    return step, n, {k: v.detach().clone() for k, v in state.params.items()}


def test_gpt2_tiny_autotune_vectors_and_params_match():
    """GPT-2 tiny under make_train_step(autotune=) on the CPU: the trial
    vectors are the JAX package's search's for the same seed and scores,
    and the trained parameters are the untuned step's bit for bit (at one
    process the fusion threshold cannot change the math)."""
    import torch

    from horovod_tpu import tune as jtune

    # Built first: a switch writes the tuned knob into the environment,
    # where a later registry would read its default.
    jreg = jtune.training_space()
    cfg = tune.AutotuneConfig(window_steps=2, warmup_steps=1, max_trials=4,
                              patience=4, seed=11)
    tuned, n, got = _gpt2_tiny_run(cfg)
    _, _, want = _gpt2_tiny_run(False, n_steps=n)
    assert tuned.autotune.done and tuned._n_retraces >= 1
    for k in got:
        assert torch.equal(got[k], want[k]), k
    # The JAX package's search, fed the same scores, proposes the same
    # vectors.
    js = jtune.AutotuneSearch(jreg, seed=11, max_trials=4, patience=4)
    for vec, score in tuned.autotune.source.search.history():
        jv = js.propose()
        assert jv == vec
        js.record(jv, -_scripted_ms(jreg, jv))
        assert score == -_scripted_ms(jreg, jv)
    assert js.done and js.best_vector() == tuned.autotune.best


# ---------------------------------------------------------------------------
# Serve twin
# ---------------------------------------------------------------------------


class TestServeTuner:
    def _fake_pool(self):
        class FakePolicy:
            high, low = 4.0, 0.5

        class FakeDispatcher:
            batch_timeout_ms = 1.5  # explicit, differs from the env 2.0

        class FakePool:
            dispatcher = FakeDispatcher()
            policy = FakePolicy()

        return FakePool()

    def test_flips_dispatcher_in_place_and_converges(self):
        from horovod_tpu_torch.tune.serve import ServeTuner

        class FakeScorer:
            """Deterministic p95: best at ~1 ms timeout."""

            def __init__(self, pool):
                self.pool = pool

            def reset(self):
                pass

            def poll(self):
                t = self.pool.dispatcher.batch_timeout_ms
                return -(5.0 + (math.log10(t) - 0.0) ** 2)

        pool = self._fake_pool()
        cfg = tune.AutotuneConfig(max_trials=5, patience=5, seed=3)
        tuner = ServeTuner(pool, cfg, scorer=FakeScorer(pool))
        assert tuner.tick()  # applies trial 0
        # Trial 0's incumbent is the POOL'S live config, not the env's.
        assert tuner.applied[_env.SERVE_BATCH_TIMEOUT_MS] == (
            pytest.approx(1.5, rel=1e-6)
        )
        for _ in range(20):
            if not tuner.tick():
                break
        assert tuner.done
        assert tuner.search.n_trials == 5
        # Serve knobs never leak into the process env.
        assert "HVDTPU_SERVE_BATCH_TIMEOUT_MS" not in os.environ
        # The live dispatcher holds the winner (in-place flip).
        assert pool.dispatcher.batch_timeout_ms == pytest.approx(
            tuner.applied[_env.SERVE_BATCH_TIMEOUT_MS]
        )
        # Watermark invariant survived every trial.
        assert pool.policy.low < pool.policy.high

    def test_same_trials_as_the_reference_tuner(self):
        """The JAX package's ServeTuner on the same fake pool and scores
        applies the same vectors in the same order."""
        from horovod_tpu.tune.serve import ServeTuner as JServeTuner
        from horovod_tpu_torch.tune.serve import ServeTuner

        class Scorer:
            def __init__(self, pool):
                self.pool = pool

            def reset(self):
                pass

            def poll(self):
                t = self.pool.dispatcher.batch_timeout_ms
                return -(5.0 + math.log10(t) ** 2 + self.pool.policy.high)

        runs = []
        for cls in (ServeTuner, JServeTuner):
            pool = self._fake_pool()
            tuner = cls(pool, tune.AutotuneConfig(max_trials=6, patience=6,
                                                  seed=5),
                        scorer=Scorer(pool))
            seen = []
            while tuner.tick():
                seen.append(dict(tuner.applied))
            runs.append((seen, tuner.applied))
        assert runs[0] == runs[1]

    def test_pool_integration_smoke(self):
        """ServePool(autotune=cfg) spawns the tuner and serves while it
        searches; stop() tears it down."""
        import torch

        from horovod_tpu_torch import obs as _obs
        from horovod_tpu_torch.serve import ServePool

        _obs.enable()
        try:
            params = {"w": torch.ones(4, 2)}
            pool = ServePool(
                lambda p, x: x @ p["w"], params, workers=1, batch_size=2,
                batch_timeout_ms=1.0, device="cpu",
                autotune=tune.AutotuneConfig(
                    window_steps=1, warmup_steps=0, max_trials=2,
                    patience=2,
                ),
            ).start()
            try:
                assert pool.tuner is not None
                x = torch.ones(4)
                for _ in range(40):
                    pool.submit(x).result(timeout=10.0)
                    if pool.tuner.done:
                        break
                # The tuner ran (applied at least one candidate) without
                # disturbing the answers.
                assert pool.tuner.applied is not None
                out = pool.submit(x).result(timeout=10.0)
                assert tuple(out.shape) == (2,)
                assert torch.equal(torch.as_tensor(out), torch.full((2,), 4.))
            finally:
                pool.stop()
            assert not pool.tuner._thread.is_alive()
        finally:
            _obs.disable()


# ---------------------------------------------------------------------------
# hvdtpu_top: tolerant panel discovery (gauges appearing mid-run)
# ---------------------------------------------------------------------------


class TestTopPanel:
    def _write(self, tmp_path, records):
        p = tmp_path / "rank0.jsonl"
        with open(p, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
        return str(tmp_path)

    def test_partial_record_no_keyerror(self, tmp_path):
        import horovod_tpu_torch.tools.hvdtpu_top as top

        d = self._write(tmp_path, [
            {"ts": 1.0, "gauges": {"step.mfu": 0.5}},
            {"ts": 2.0, "counters": {"step.count": 3}},
        ])
        rows, events = top.collect(d)
        assert len(rows) == 1
        out = top.render(rows, events, d)
        assert "rank0" in out

    def test_autotune_gauges_appear_mid_run(self, tmp_path):
        import horovod_tpu_torch.tools.hvdtpu_top as top

        base = {"counters": {"step.count": 10}, "gauges": {},
                "histograms": {}}
        late = {
            "ts": 2.0,
            "counters": {"step.count": 20, "autotune.trials": 3,
                         "autotune.switches": 4, "autotune.retraces": 2},
            "gauges": {
                "autotune.trial": 3.0, "autotune.score": -12.5,
                "autotune.best_score": -9.4, "autotune.converged": 0.0,
                "autotune.candidate.FUSION_THRESHOLD": 2097152.0,
                "autotune.candidate.PREFETCH_DEPTH": 3.0,
            },
            "histograms": {},
        }
        d = self._write(tmp_path, [dict(base, ts=1.0), late])
        rows, events = top.collect(d)
        t = rows[0]["autotune"]
        assert t is not None and t["trial"] == 3.0
        assert set(t["candidate"]) == {"FUSION_THRESHOLD",
                                       "PREFETCH_DEPTH"}
        out = top.render(rows, events, d)
        assert "autotune" in out and "FUSION_THRESHOLD" in out

    def test_no_autotune_gauges_no_panel(self, tmp_path):
        import horovod_tpu_torch.tools.hvdtpu_top as top

        d = self._write(tmp_path, [
            {"ts": 1.0, "counters": {"step.count": 1}, "gauges": {},
             "histograms": {}},
        ])
        rows, _ = top.collect(d)
        assert rows[0]["autotune"] is None

    def test_panel_shows_a_port_runs_gauges(self, tmp_path, monkeypatch):
        """A port run's own registry, exported and read back: the panel
        shows the gauges a tuned step recorded, and the recorded counts
        are the client's own."""
        from horovod_tpu_torch import obs as _obs
        from horovod_tpu_torch import optimizer as topt
        from horovod_tpu_torch.obs import export as _export
        from horovod_tpu_torch.obs import registry as _registry
        from horovod_tpu_torch.parallel import dp
        import horovod_tpu_torch.tools.hvdtpu_top as top

        monkeypatch.setenv("HVDTPU_METRICS_DIR", str(tmp_path / "live"))
        _registry._registry.reset()
        _export._reporter = None
        _obs.enable()
        try:
            params, batch, loss_fn = _mlp()
            step, opt = dp.make_train_step(
                loss_fn, topt.adamw(1e-3), device="cpu",
                autotune=tune.AutotuneConfig(window_steps=1, warmup_steps=0,
                                             max_trials=3, patience=3))
            state = dp.init_state(params, opt)
            while not step.autotune.done:
                state, _ = step(state, batch)
            snap = _obs.metrics().snapshot()
            c = step.autotune
            assert snap["counters"]["autotune.switches"] == len(
                c.switch_log)
            assert snap["counters"]["autotune.trials"] == 3
            assert snap["counters"].get("autotune.retraces", 0) == \
                step._n_retraces
            assert snap["gauges"]["autotune.converged"] == 1.0
            _export.MetricsReporter(str(tmp_path)).flush(summarize=False)
        finally:
            _obs.disable()
            _registry._registry.reset()
            _export._reporter = None
        rows, events = top.collect(str(tmp_path))
        assert rows[0]["autotune"]["converged"] == 1.0
        assert "FUSION_THRESHOLD" in top.render(rows, events, str(tmp_path))


# ---------------------------------------------------------------------------
# Env knobs
# ---------------------------------------------------------------------------


class TestEnvKnobs:
    def test_accessors_defaults_and_floors(self):
        from horovod_tpu.utils import env as jenv

        for name in ("autotune_default", "autotune_window_steps",
                     "autotune_warmup_steps", "autotune_max_trials",
                     "autotune_patience", "autotune_seed",
                     "stream_enabled", "stream_staleness_secs",
                     "stream_max_pending", "publish_every"):
            assert getattr(_env, name)() == getattr(jenv, name)(), name
        assert _env.autotune_default() is False
        assert _env.autotune_window_steps() == 10
        assert _env.autotune_warmup_steps() == 3
        assert _env.autotune_max_trials() == 40
        assert _env.autotune_patience() == 10
        assert _env.autotune_seed() == 20240731
        os.environ["HVDTPU_AUTOTUNE_WINDOW_STEPS"] = "0"
        assert _env.autotune_window_steps() == 1  # floored
        os.environ["HVDTPU_STREAM_STALENESS_SECS"] = "0"
        assert _env.stream_staleness_secs() == 0.1
        os.environ["HVDTPU_STREAM_MAX_PENDING"] = "0"
        with pytest.raises(ValueError, match="STREAM_MAX_PENDING"):
            _env.stream_max_pending()

    def test_knob_csv(self):
        os.environ["HVDTPU_AUTOTUNE_KNOBS"] = (
            "fusion_threshold, prefetch_depth"
        )
        assert _env.autotune_knobs() == (
            "FUSION_THRESHOLD", "PREFETCH_DEPTH"
        )

    def test_declared(self):
        from horovod_tpu.utils import env as jenv

        declared = _env.declared_env_vars()
        for name in (
            "HVDTPU_AUTOTUNE", "HVDTPU_AUTOTUNE_WINDOW_STEPS",
            "HVDTPU_AUTOTUNE_WARMUP_STEPS", "HVDTPU_AUTOTUNE_MAX_TRIALS",
            "HVDTPU_AUTOTUNE_PATIENCE", "HVDTPU_AUTOTUNE_SEED",
            "HVDTPU_AUTOTUNE_KNOBS", "HVDTPU_COLLECTIVE_LAYOUT",
            "HVDTPU_AUTOTUNE_LOG", "HVDTPU_STREAM",
            "HVDTPU_STREAM_STALENESS_SECS", "HVDTPU_STREAM_MAX_PENDING",
        ):
            assert name in declared
        # Every port knob is one the JAX package declares too.
        assert declared <= jenv.declared_env_vars()


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------


class TestAcrossPackages:
    def test_gp_and_candidates_equal_the_reference(self):
        from horovod_tpu.tune import gp as jgp

        with open(FIXTURE) as f:
            fx = json.load(f)
        g, jg = _gp.GaussianProcess(), jgp.GaussianProcess()
        g.fit(fx["observations_x"], fx["observations_y"])
        jg.fit(fx["observations_x"], fx["observations_y"])
        for c in fx["candidates"]:
            assert g.predict(c) == jg.predict(c)
        for seed, trial, dims in ((7, 3, 4), (20240731, 1, 1), (0, 9, 2)):
            assert _gp.candidates_for_trial(seed, trial, dims) == \
                jgp.candidates_for_trial(seed, trial, dims)

    def test_same_candidate_sequence_for_a_scripted_feed(self):
        """The same registry, seed and score feed give the JAX package's
        candidate sequence, through convergence and a resume from
        state_dict midway."""
        from horovod_tpu import tune as jtune
        from horovod_tpu.tune.knobs import Knob as JKnob
        from horovod_tpu.tune.knobs import KnobRegistry as JKnobRegistry

        reg = _small_registry()
        jreg = JKnobRegistry([JKnob(k.name, k.kind, lo=k.lo, hi=k.hi,
                                    choices=k.choices, default=k.default,
                                    requires_retrace=k.requires_retrace)
                              for k in reg.knobs])
        ours = tune.AutotuneSearch(reg, seed=13, max_trials=9, patience=9)
        theirs = jtune.AutotuneSearch(jreg, seed=13, max_trials=9,
                                      patience=9)
        while not ours.done:
            v, jv = ours.propose(), theirs.propose()
            assert v == jv
            ours.record(v, _bowl_score(reg, v))
            theirs.record(jv, _bowl_score(reg, jv))
            if ours.n_trials == 4:
                # Each resumes from the other's journaled state.
                a, b = ours.state_dict(), theirs.state_dict()
                assert json.dumps(a, sort_keys=True) == json.dumps(
                    b, sort_keys=True)
                ours = tune.AutotuneSearch(reg, seed=0)
                ours.load_state_dict(b)
                theirs = jtune.AutotuneSearch(jreg, seed=0)
                theirs.load_state_dict(a)
        assert theirs.done and ours.best_vector() == theirs.best_vector()

    @pytest.mark.parametrize("coord_pkg", ["jax", "port"])
    def test_coordinator_drives_the_other_packages_clients(self, coord_pkg):
        """A coordinator of one package and clients of the other over one
        KV: lockstep switches, no mixed vector, the same final vector as
        a same-package run."""
        from horovod_tpu import tune as jtune
        from horovod_tpu.tune import rollout as jro
        from horovod_tpu.tune.knobs import Knob as JKnob
        from horovod_tpu.tune.knobs import KnobRegistry as JKnobRegistry

        def regs():
            reg = _small_registry()
            return reg, JKnobRegistry([
                JKnob(k.name, k.kind, lo=k.lo, hi=k.hi, choices=k.choices,
                      default=k.default, requires_retrace=k.requires_retrace)
                for k in reg.knobs])

        def parts(cpkg, wpkg):
            reg, jreg = regs()
            ctune, cro, creg = ((jtune, jro, jreg) if cpkg == "jax"
                                else (tune, _ro, reg))
            wtune, wro, wreg = ((jtune, jro, jreg) if wpkg == "jax"
                                else (tune, _ro, reg))
            coord = cro.RolloutCoordinator(creg, search=ctune.AutotuneSearch(
                creg, seed=13, max_trials=5, patience=5))
            store = FakeStore()
            clients = {h: wro.AutotuneClient(
                wreg, wro.KVConfigSource(store, h),
                scorer=wtune.WindowScorer(window_steps=2, warmup_steps=1))
                for h in ("a", "b")}
            return reg, coord, store, clients

        worker_pkg = "port" if coord_pkg == "jax" else "jax"
        mixed = _drive(*parts(coord_pkg, worker_pkg), max_steps=600)
        reg, coord, store, clients = parts(coord_pkg, worker_pkg)
        per_step = _drive(reg, coord, store, clients, max_steps=600)
        assert per_step == mixed
        assert all(c.done for c in clients.values())
        for applied in per_step:
            a, b = applied.values()
            assert a == b
        same = parts("port", "port")
        _drive(*same, max_steps=600)
        assert coord.search.best_vector() == same[1].search.best_vector()
        for c in clients.values():
            assert c.applied == same[1].search.best_vector()


# ---------------------------------------------------------------------------
# The elastic half: the soak (driver crash mid-search, adoption)
# ---------------------------------------------------------------------------


def test_elastic_driver_journals_and_adopts_the_search(tmp_path):
    """The driver's coordinator state rides its journal record under the
    JAX package's key, and an adopter resumes the search from it."""
    from horovod_tpu_torch.runner.journal import ControlPlaneJournal

    reg, coord, store, clients = _protocol_parts()
    hosts = list(clients)
    coord.poll(store, hosts)
    while coord.search.n_trials < 2:
        for c in clients.values():
            c.step_start()
        for c in clients.values():
            vec = c.applied or reg.canonical(reg.default_vector())
            c.step_end(-_bowl_score(reg, vec) / 1e3)
        coord.poll(store, hosts)
    j = ControlPlaneJournal(str(tmp_path / "j"))
    j.record_driver({"autotune": coord.state_dict()})
    j.close()
    _, state = ControlPlaneJournal(str(tmp_path / "j")).recover()
    adopter = _ro.RolloutCoordinator(reg, search=tune.AutotuneSearch(
        reg, seed=0))
    adopter.load_state_dict(state["autotune"])
    assert adopter.search.n_trials == 2
    assert adopter.state_dict() == json.loads(json.dumps(coord.state_dict()))


def test_autotune_soak_scenario():
    """Driver crash mid-search: the adopter resumes from the journaled
    trial history, no rank runs a mixed vector, and the final vector is
    the fault-free run's (about 15 s)."""
    from horovod_tpu_torch.tools import chaos_soak as cs

    res = cs.run_scenario("autotune", timeout=120.0)
    assert cs.check_invariants(res) == []
    assert res["adopted_history_len"] >= 1


def test_tune_config_source_is_the_references_kv_view(monkeypatch):
    """Inside an elastic world the worker's source is a KVConfigSource on
    the launcher's KV client, keyed by this host's id, as the JAX
    package's; outside one it is None (the step runs its local search)."""
    from horovod_tpu.elastic import worker as jworker
    from horovod_tpu_torch.elastic import worker as tworker

    assert tworker.tune_config_source() is None
    assert jworker.tune_config_source() is None
    monkeypatch.setenv("HVDTPU_ELASTIC", "1")
    monkeypatch.setenv("HVDTPU_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HVDTPU_RENDEZVOUS_PORT", "1")
    monkeypatch.setenv("HVDTPU_HOST_ID", "hostA")
    src = tworker.tune_config_source()
    assert isinstance(src, _ro.KVConfigSource) and src.host_id == "hostA"
    assert src.kv is not None
