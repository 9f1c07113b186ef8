"""The port's elastic launcher end to end, on gloo worlds of CPU processes
over one to three loopback "hosts" (``localhost``, ``127.0.0.1``,
``127.0.0.2``): twins of tests/test_elastic_integration.py (scale up and
down, crash -> blacklist -> recover, stragglers, a late failure, the drain
deadline and its opt-out) and of tests/test_elastic.py's reset paths run
inside an elastic world, plus the slice as a whole:

* GPT-2 tiny, from seeded flax parameters (``convert``), trained with
  ZeRO-1 fused AdamW through ``run_elastic`` on two hosts, one crashed at
  its third commit (``worker.step:crash@step=3;host=127.0.0.1;spawn=0``),
  blacklisted, re-admitted after a one-second cooldown (the driver holds
  the round below ``min_np=2``) and respawned: the respawn syncs the
  survivor's last commit (step 2) and trains on, and the final parameters
  equal the uninterrupted launched run's bit for bit, and the JAX package's
  training of the same batches within test_torch_port_train.py's
  tolerances (losses to rtol 2e-5, each parameter's movement within 1e-2
  relative L2);
* a gloo survivor of a killed peer raises ``HorovodInternalError``.

The harness is ``horovod_tpu_torch.tools.chaos_soak.run_elastic_scenario``
(the twin of tests/elastic_harness.py).
"""

import os
import pickle
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from horovod_tpu_torch.tools.chaos_soak import (
    BASE_ENV,
    run_elastic_scenario,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- twins of tests/test_elastic_integration.py -------------------------

WORKER = textwrap.dedent(
    """
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.ops import collectives as C

    hvt.init(device="cpu", backend="gloo")
    state = elastic.ObjectState(step=0, phase=0, acc=0.0)

    @elastic.run
    def train(st):
        while True:
            size = hvt.size()
            out = C.allreduce(torch.ones(4), op=C.Sum)
            assert float(out[0]) == size, (float(out[0]), size)
            st.step += 1
            st.acc += float(out[0])
            log({"host": host_id, "rank": hvt.rank(), "size": size,
                 "step": st.step, "phase": st.phase})
            if hvt.rank() == 0:
                if st.phase == 0 and st.step >= 3:
                    st.phase = 1
                    set_hosts(["localhost:1", "127.0.0.1:1"])
                elif st.phase == 1 and size == 2 and st.step >= 6:
                    st.phase = 2
                    set_hosts(["localhost:1"])
                elif st.phase == 2 and size == 1 and st.step >= 9:
                    log({"host": host_id, "final_step": st.step,
                         "final_acc": st.acc})
                    return st.step
            st.commit()
            time.sleep(0.02)

    train(state)
    hvt.shutdown()
    """
)


def test_elastic_scale_up_down(tmp_path):
    rc, records = run_elastic_scenario(
        str(tmp_path), WORKER, initial_hosts=["localhost:1"], timeout=90.0)
    assert rc == 0, f"elastic job failed rc={rc}"
    steps = [r for r in records if "step" in r]
    finals = [r for r in records if "final_step" in r]
    assert finals and finals[-1]["final_step"] >= 9
    assert {r["host"] for r in steps if r["size"] == 2} == {
        "localhost", "127.0.0.1"}
    last_size2 = max(i for i, r in enumerate(steps) if r["size"] == 2)
    assert any(r["size"] == 1 for r in steps[last_size2 + 1:])
    per_host = {}
    for r in steps:
        assert r["step"] > per_host.get(r["host"], 0), r
        per_host[r["host"]] = r["step"]
    joiner = [r["step"] for r in steps if r["host"] == "127.0.0.1"]
    assert joiner and joiner[0] > 1, joiner


WORKER_CRASH = textwrap.dedent(
    """
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.ops import collectives as C

    hvt.init(device="cpu", backend="gloo")
    state = elastic.ObjectState(step=0)
    state.register_reset_callbacks([lambda: log({"host": host_id,
                                                 "reset": True})])

    @elastic.run
    def train(st):
        while True:
            size = hvt.size()
            C.allreduce(torch.ones(4), op=C.Sum)
            st.step += 1
            log({"host": host_id, "rank": hvt.rank(), "size": size,
                 "step": st.step})
            if host_id == "127.0.0.1" and st.step >= 5:
                os._exit(1)
            st.commit()
            if hvt.rank() == 0 and size == 1 and st.step >= 10:
                log({"host": host_id, "final_step": st.step})
                return st.step
            time.sleep(0.02)

    train(state)
    hvt.shutdown()
    """
)


def test_elastic_worker_crash_blacklist_and_recover(tmp_path):
    """A worker dies mid-collective: the driver blacklists its host and
    publishes a shrunken round; the survivor recovers its committed state
    through HorovodInternalError -> restore -> rejoin and finishes at
    world size 1."""
    rc, records = run_elastic_scenario(
        str(tmp_path), WORKER_CRASH,
        initial_hosts=["localhost:1", "127.0.0.1:1"], timeout=90.0)
    assert rc == 0, f"rc={rc}"
    steps = [r for r in records if "step" in r]
    finals = [r for r in records if "final_step" in r]
    assert finals and finals[-1]["final_step"] >= 10
    assert {r["host"] for r in steps if r["size"] == 2} == {
        "localhost", "127.0.0.1"}
    survivor = [r for r in steps if r["host"] == "localhost"]
    assert survivor[-1]["size"] == 1
    seq = [r["step"] for r in survivor]
    assert seq == sorted(seq), "step regressed"
    assert any(r.get("reset") and r["host"] == "localhost" for r in records)


WORKER_STRAGGLER = textwrap.dedent(
    """
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import collectives as C

    hvt.init(device="cpu", backend="gloo")
    rank = hvt.rank()
    C.allreduce(torch.ones(2), op=C.Sum)
    hvt.shutdown()
    if rank != 0:
        time.sleep(3.0)
    log({"host": host_id, "rank": rank, "done": True})
    """
)


def test_elastic_completion_waits_for_stragglers(tmp_path):
    rc, records = run_elastic_scenario(
        str(tmp_path), WORKER_STRAGGLER,
        initial_hosts=["localhost:1", "127.0.0.1:1"], timeout=60.0)
    assert rc == 0, f"rc={rc}"
    assert {r["rank"] for r in records if r.get("done")} == {0, 1}


WORKER_LATE_FAILURE = textwrap.dedent(
    """
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import collectives as C

    hvt.init(device="cpu", backend="gloo")
    rank = hvt.rank()
    C.allreduce(torch.ones(2), op=C.Sum)
    hvt.shutdown()
    if rank != 0:
        time.sleep(2.0)
        log({"host": host_id, "rank": rank, "failing": True})
        os._exit(7)
    log({"host": host_id, "rank": rank, "done": True})
    """
)


def test_elastic_late_failure_not_reported_as_success(tmp_path):
    rc, records = run_elastic_scenario(
        str(tmp_path), WORKER_LATE_FAILURE,
        initial_hosts=["localhost:1", "127.0.0.1:1"], timeout=60.0)
    assert rc == 7, f"late failure silently dropped: rc={rc}"
    assert any(r.get("failing") for r in records)


WORKER_HUNG = textwrap.dedent(
    """
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import collectives as C

    hvt.init(device="cpu", backend="gloo")
    rank = hvt.rank()
    C.allreduce(torch.ones(2), op=C.Sum)
    hvt.shutdown()
    if rank != 0:
        log({"host": host_id, "rank": rank, "hung": True})
        while True:
            time.sleep(1.0)
    log({"host": host_id, "rank": rank, "done": True})
    """
)


@pytest.mark.parametrize("strict", ["1", "0"], ids=["strict", "lenient"])
def test_elastic_drain_deadline(tmp_path, monkeypatch, strict):
    """Twins of test_elastic_drain_deadline_is_a_failure and
    ..._lenient_optout: a worker killed at the drain deadline makes the
    job fail, unless HVDTPU_ELASTIC_DRAIN_STRICT=0 (read by the driver)."""
    monkeypatch.setenv("HVDTPU_ELASTIC_DRAIN_STRICT", strict)
    rc, records = run_elastic_scenario(
        str(tmp_path), WORKER_HUNG,
        initial_hosts=["localhost:1", "127.0.0.1:1"], timeout=60.0,
        drain_timeout=4.0)
    assert (rc != 0) if strict == "1" else (rc == 0), rc
    assert any(r.get("hung") for r in records)


# ---- twins of tests/test_elastic.py's reset paths, inside a launch --------

WORKER_RESET = textwrap.dedent(
    """
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.exceptions import (
        HorovodInternalError,
        HostsUpdatedInterrupt,
    )
    from horovod_tpu_torch.ops import collectives as C

    hvt.init(device="cpu", backend="gloo")
    st = elastic.ObjectState(attempts=0, progress=0)
    calls = {"n": 0}

    @elastic.run
    def train(s):
        calls["n"] += 1
        C.allreduce(torch.ones(1), op=C.Sum)
        log({"host": host_id, "call": calls["n"], "size": hvt.size(),
             "attempts": s.attempts, "progress": s.progress})
        s.attempts += 1
        s.progress += 10
        if calls["n"] == 1:
            s.commit()
            s.attempts += 100  # uncommitted: the restore drops it
            raise HorovodInternalError("collective failed")
        if calls["n"] == 2:
            raise HostsUpdatedInterrupt(skip_sync=True)
        return s.attempts

    out = train(st)
    log({"host": host_id, "final": out, "progress": st.progress,
         "rank": hvt.rank()})
    hvt.shutdown()
    """
)


def test_reset_paths_rejoin_the_round(tmp_path):
    """test_elastic_run_restores_on_internal_error and
    ..._hosts_updated_keeps_state inside an elastic world: a
    HorovodInternalError restores the last commit, a HostsUpdatedInterrupt
    keeps the live state, and each reset tears the gloo world down and
    rejoins the driver's round before the retry runs."""
    rc, records = run_elastic_scenario(
        str(tmp_path), WORKER_RESET, initial_hosts=["localhost:1"],
        timeout=60.0)
    assert rc == 0
    calls = [r for r in records if "call" in r]
    assert [(r["call"], r["size"], r["attempts"], r["progress"])
            for r in calls] == [(1, 1, 0, 0), (2, 1, 1, 10), (3, 1, 2, 20)]
    final = [r for r in records if "final" in r]
    assert final == [{"host": "localhost", "final": 3, "progress": 30,
                      "rank": 0}]


SURVIVOR = textwrap.dedent(
    """
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.exceptions import HorovodInternalError
    from horovod_tpu_torch.ops import collectives as C

    hvt.init(device="cpu", backend="gloo")
    C.allreduce(torch.ones(1), op=C.Sum)
    if hvt.rank() == 1:
        os._exit(0)  # a clean exit: the launcher kills nobody
    try:
        C.allreduce(torch.ones(4), op=C.Sum)
        log({"got": "no error"})
    except HorovodInternalError as e:
        log({"got": "HorovodInternalError",
             "cause": type(e.__cause__).__name__})
    """
)


def test_gloo_survivor_of_a_killed_peer_raises_internal_error(tmp_path):
    from horovod_tpu_torch.runner.launch import run_commandline
    from horovod_tpu_torch.tools.chaos_soak import (
        WORKER_PRELUDE,
        read_records,
    )

    script = tmp_path / "w.py"
    script.write_text(WORKER_PRELUDE + SURVIVOR)
    env = dict(BASE_ENV, HVDTPU_TEST_WORKDIR=str(tmp_path),
               HVDTPU_HOST_ID="h")
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        rc = run_commandline(["-np", "2", "-H", "localhost:2", "--",
                              sys.executable, str(script)])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert rc == 0
    got = read_records(str(tmp_path))
    assert len(got) == 1 and got[0]["got"] == "HorovodInternalError", got
    assert got[0]["cause"] in ("RuntimeError", "DistBackendError",
                               "DistNetworkError"), got


# ---- the slice: GPT-2 tiny, crashed, respawned, resumed -------------------

STEPS = 5
LR = 1e-2
CRASH = "worker.step:crash@step=3;host=127.0.0.1;spawn=0"

SLICE_WORKER = textwrap.dedent(
    """
    import pickle
    import torch.nn.functional as F
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch import convert, elastic
    from horovod_tpu_torch import optimizer as topt
    from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
    from horovod_tpu_torch.parallel import dp

    STEPS = int(os.environ["HVDTPU_TEST_SOAK_STEPS"])
    with open(os.path.join(workdir, "data.pkl"), "rb") as f:
        params, tokens, lr = pickle.load(f)

    hvt.init(device="cpu", backend="gloo")
    cfg = GPT2Config.tiny(dtype=torch.float32, use_flash=True)
    model = GPT2LMModel(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax({"params": params}))

    def loss_fn(p, t):
        logits = torch.func.functional_call(model, p, (t[:, :-1],))
        return F.cross_entropy(logits.flatten(0, 1), t[:, 1:].flatten())

    step, opt = dp.make_train_step(loss_fn, topt.fused_adamw(lr),
                                   device="cpu", sharded=True,
                                   fused_update=True)
    ts = dp.init_state(model, opt)
    state = elastic.TrainState(params=ts.params, opt_state=ts.opt_state,
                               step=ts.step)
    spawn = int(os.environ["HVDTPU_SPAWN_ROUND"])

    @elastic.run
    def train(st):
        while int(st.step) < STEPS:
            r = hvt.rank()
            rows = torch.from_numpy(tokens[2 * r:2 * r + 2]).long()
            new, loss = step(dp.TrainState(st.params, st.opt_state, st.step),
                             rows)
            st.params, st.opt_state, st.step = (new.params, new.opt_state,
                                                new.step)
            log({"host": host_id, "spawn": spawn, "rank": r,
                 "size": hvt.size(), "step": int(new.step),
                 "loss": float(loss)})
            st.commit()

    train(state)
    if hvt.rank() == 0:
        with open(os.path.join(workdir, "final.pkl"), "wb") as f:
            pickle.dump({k: v.detach().numpy().copy()
                         for k, v in state.params.items()}, f)
    log({"host": host_id, "rank": hvt.rank(), "final_step": int(state.step)})
    hvt.shutdown()
    """
)


def _data():
    from horovod_tpu.models import gpt2 as jgpt2

    cfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 33)).astype(np.int32)
    params = jgpt2.GPT2LMModel(cfg).init(
        jax.random.PRNGKey(0), jnp.asarray(tokens[:1, :32]))["params"]
    return jax.tree.map(np.asarray, params), tokens


def _jax_reference(params, tokens, out):
    """The JAX package's ZeRO-1 fused AdamW on a world of 2 CPU devices,
    the same global batch every step."""
    import horovod_tpu as hvd
    from horovod_tpu.models import gpt2 as jgpt2
    from horovod_tpu.optimizer import fused_adamw
    from horovod_tpu.parallel import dp as jdp

    hvd.init(devices=jax.devices("cpu")[:2])
    try:
        cfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, use_flash=True)
        model = jgpt2.GPT2LMModel(cfg)

        def loss_fn(p, batch):
            (t,) = batch
            logits = model.apply({"params": p}, t[:, :-1])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, t[:, 1:]).mean()

        step, wopt = jdp.make_train_step(loss_fn, fused_adamw(LR),
                                         sharded=True, fused_update=True)
        state = jdp.init_state(jax.tree.map(jnp.array, params), wopt)
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, (jnp.asarray(tokens),))
            losses.append(float(loss))
        out["losses"] = losses
        out["params"] = jax.tree.map(np.asarray, state.params)
    finally:
        hvd.shutdown()


def _launched(workdir, params, tokens, chaos):
    os.makedirs(workdir)
    with open(os.path.join(workdir, "data.pkl"), "wb") as f:
        pickle.dump((params, tokens, LR), f)
    rc, records = run_elastic_scenario(
        workdir, SLICE_WORKER, initial_hosts=["localhost:1", "127.0.0.1:1"],
        extra_env={"HVDTPU_TEST_SOAK_STEPS": str(STEPS)},
        driver_env={"HVDTPU_BLACKLIST_COOLDOWN": "1"}, min_np=2,
        chaos=chaos, timeout=120.0)
    assert rc == 0, (rc, records)
    with open(os.path.join(workdir, "final.pkl"), "rb") as f:
        final = pickle.load(f)
    losses = {}
    for r in records:
        if "loss" in r:
            losses[r["step"]] = r["loss"]
    return final, [losses[s] for s in range(1, STEPS + 1)], records


def _leaves(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_gpt2_crash_respawn_resumes_bit_for_bit(tmp_path):
    import torch

    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models import GPT2Config

    params, tokens = _data()
    ref: dict = {}
    t = threading.Thread(target=_jax_reference, args=(params, tokens, ref))
    t.start()
    clean, clean_losses, _ = _launched(str(tmp_path / "clean"), params,
                                       tokens, None)
    chaos, chaos_losses, records = _launched(str(tmp_path / "chaos"), params,
                                             tokens, CRASH)
    t.join(timeout=120.0)
    # The crash landed at commit 3, before the survivor's commit 3 could
    # complete (its snapshot gathers the ZeRO-1 shards from the dead
    # peer): the survivor restored commit 2, the respawn synced it, and
    # the two trained steps 3-5 at world size 2.
    victim = [(r["spawn"], r["step"]) for r in records
              if r.get("host") == "127.0.0.1" and "step" in r]
    assert [st for sp, st in victim if sp == 0] == [1, 2, 3], records
    assert [st for sp, st in victim if sp > 0] == [3, 4, 5], records
    assert {r["size"] for r in records if "size" in r} == {2}
    # Bit for bit the uninterrupted launched run.
    assert sorted(chaos) == sorted(clean)
    for k in clean:
        np.testing.assert_array_equal(chaos[k], clean[k], err_msg=k)
    assert chaos_losses == clean_losses
    # Within the reference's tolerances of the JAX package's training.
    np.testing.assert_allclose(clean_losses, ref["losses"], rtol=2e-5)
    assert clean_losses[-1] < clean_losses[0]
    got = _leaves(convert.params_to_flax(
        {k: torch.from_numpy(v) for k, v in clean.items()},
        GPT2Config.tiny().n_heads)["params"])
    want, p0 = _leaves(ref["params"]), _leaves(params)
    assert sorted(got) == sorted(want) == sorted(p0)
    for name, w in want.items():
        g = got[name]
        assert np.abs(g - p0[name]).max() <= STEPS * LR * 1.01, name
        if "['key']['bias']" in name:
            continue
        moved = np.linalg.norm(w - p0[name])
        err = np.linalg.norm((g - p0[name]) - (w - p0[name]))
        assert err <= 1e-2 * moved, (name, err, moved)
