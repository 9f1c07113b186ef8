"""The dynamic-enqueue runtime and its frontends across elastic rounds, on
gloo worlds of CPU processes over loopback "hosts" (``localhost``,
``127.0.0.1``, ``127.0.0.2``) under the port's launcher
(``horovod_tpu_torch.tools.chaos_soak.run_elastic_scenario``):

* the reference's native scenario (tests/test_elastic_integration.py::
  test_elastic_scale_up_down) line for line on ``horovod_tpu_torch.native``:
  sizes 1, 2, 1, every allreduce equal to the live size, the step counter
  never regressing, the joiner syncing the committed state. Each reset
  restarts the runtime on the new round (``rejoin_world``);
* the torch frontend: ``hvd.DistributedOptimizer(AdamW)`` under
  ``hvd.elastic.run`` with ``TorchState`` and ``ElasticSampler``, scaled
  1 -> 2 -> 1: after every sync all ranks hold the same parameters and
  AdamW state bit for bit, every step's reduced gradient is the mean of
  the ranks' local gradients at the live size, and the sampler shards over
  the live world; and scaled 2 -> 3 -> 2, which the same scenario under
  the JAX package's launcher and frontend (``horovod_tpu.torch`` on its
  C++ runtime), its twin, passes too;
* the TensorFlow frontend: ``DistributedGradientTape`` inside a
  ``tf.function`` traced at size 1, then rescaled in place to 2 with
  ``TensorFlowKerasState``: the averaged gradient divides by the live size;
* the Keras scale-up of tests/test_elastic_keras.py (slow, as the
  reference's);
* in this process: a shutdown whose peer never comes, the optimizer's
  handles across a restart, and the launcher's C19 repairs.
"""

import textwrap

import pytest

from horovod_tpu_torch.tools.chaos_soak import run_elastic_scenario


def _steps_never_regress(steps):
    per_host = {}
    for r in steps:
        assert r["step"] > per_host.get(r["host"], 0), r
        per_host[r["host"]] = r["step"]


def _sizes_in_order(steps):
    """The live sizes in the order the steps ran, repeats folded."""
    out = []
    for r in steps:
        if not out or out[-1] != r["size"]:
            out.append(r["size"])
    return out


# ---- the runtime's restart, in this process -------------------------------


def _pair_of_runtimes():
    """Two runtimes of one world of 2 in this process, each on a gloo
    group of its own over one in-process store."""
    import threading
    from datetime import timedelta

    import torch.distributed as dist

    from horovod_tpu_torch.native.runtime import Runtime

    store, groups = dist.HashStore(), {}

    def group(rank):
        groups[rank] = dist.ProcessGroupGloo(
            dist.PrefixStore("pair", store), rank, 2, timedelta(seconds=60))

    threads = [threading.Thread(target=group, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    import torch

    rts = [Runtime(r, 2, groups[r], None, torch.device("cpu"))
           for r in (0, 1)]
    for rt in rts:
        rt.start()
    return rts


def test_shutdown_abandons_a_runtime_whose_peer_never_comes():
    """A rank that shuts down while its peer waits on a collective it will
    never join (the peer not yet at the commit that resets it) waits its
    bound, not the data plane's timeout: its pending handles fail, and the
    abort of its groups fails the peer's exchange, whose handle fails in
    turn (HorovodInternalError)."""
    import time

    import torch

    from horovod_tpu_torch import native
    from horovod_tpu_torch.exceptions import HorovodInternalError
    from horovod_tpu_torch.native import messages as msg
    from horovod_tpu_torch.native.runtime import Entry

    rt0, rt1 = _pair_of_runtimes()
    x = torch.ones(3)
    mine = rt0.enqueue(Entry(name="mine", type=msg.RequestType.ALLREDUCE,
                             input=x, output=torch.empty_like(x)),
                       msg.Request(type=msg.RequestType.ALLREDUCE,
                                   name="mine", dtype=msg.dtype_code(x.dtype),
                                   shape=(3,), device="cpu"))
    theirs = rt1.enqueue(Entry(name="theirs",
                               type=msg.RequestType.ALLREDUCE, input=x,
                               output=torch.empty_like(x)),
                         msg.Request(type=msg.RequestType.ALLREDUCE,
                                     name="theirs",
                                     dtype=msg.dtype_code(x.dtype),
                                     shape=(3,), device="cpu"))
    t0 = time.monotonic()
    rt0.shutdown(timeout=1.0)
    assert 0.9 <= time.monotonic() - t0 < 10.0
    assert not rt0.alive and "without its peers" in rt0.error
    for rt, h in ((rt0, mine), (rt1, theirs)):
        assert rt.handles.wait(h, 30.0)
        with pytest.raises(HorovodInternalError):
            native._wait_check(rt, h)
    assert time.monotonic() - t0 < 30.0
    rt1.shutdown(timeout=1.0)


def test_handles_of_a_restarted_runtime_are_forgotten():
    """A reset between a backward and its step restarts the runtime: the
    wrapped optimizer forgets the old runtime's handles at its next
    zero_grad, and the step taken again is the unwrapped one's."""
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import native

    def build():
        torch.manual_seed(0)
        m = torch.nn.Linear(4, 2)
        return m, torch.optim.SGD(m.parameters(), lr=0.1)

    x = torch.arange(8.0).reshape(2, 4)
    plain, plain_opt = build()
    plain(x).sum().backward()
    plain_opt.step()
    hvd.init(device="cpu")
    try:
        model, base = build()
        opt = hvd.DistributedOptimizer(
            base, named_parameters=model.named_parameters())
        gen = native.generation()
        model(x).sum().backward()  # the hooks enqueue; no step follows
        native.shutdown()
        native.init(device="cpu")
        assert native.generation() == gen + 1
        opt.zero_grad()
        model(x).sum().backward()
        opt.step()
        for a, b in zip(model.parameters(), plain.parameters()):
            assert torch.equal(a, b)
    finally:
        hvd.shutdown()


# ---- the reference's native scenario, on the port's runtime ---------------

NATIVE_WORKER = textwrap.dedent(
    """
    import horovod_tpu_torch.native as native
    from horovod_tpu_torch import elastic

    native.init(device="cpu")
    state = elastic.ObjectState(step=0, phase=0, acc=0.0)

    @elastic.run
    def train(st):
        while True:
            size = native.size()
            out = native.allreduce(torch.ones(4), name="grad")
            assert float(out[0]) == size, (float(out[0]), size)
            st.step += 1
            st.acc += float(out[0])
            log({"host": host_id, "rank": native.rank(), "size": size,
                 "step": st.step, "phase": st.phase,
                 "generation": native.generation()})
            if native.rank() == 0:
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
    native.shutdown()
    """
)


def test_native_runtime_restarts_on_every_round(tmp_path):
    rc, records = run_elastic_scenario(
        str(tmp_path), NATIVE_WORKER, initial_hosts=["localhost:1"],
        timeout=90.0)
    assert rc == 0, f"elastic job failed rc={rc}: {records}"
    steps = [r for r in records if "step" in r]
    finals = [r for r in records if "final_step" in r]
    assert finals and finals[-1]["final_step"] >= 9
    assert {r["host"] for r in steps if r["size"] == 2} == {
        "localhost", "127.0.0.1"}
    last_size2 = max(i for i, r in enumerate(steps) if r["size"] == 2)
    assert any(r["size"] == 1 for r in steps[last_size2 + 1:])
    _steps_never_regress(steps)
    joiner = [r["step"] for r in steps if r["host"] == "127.0.0.1"]
    assert joiner and joiner[0] > 1, joiner
    # The survivor's runtime was started anew at each of its two rounds
    # after the first.
    first = [r for r in steps if r["host"] == "localhost"]
    assert _sizes_in_order(first) == [1, 2, 1]
    assert [r["generation"] for r in first if r["size"] == 2][0] == 2
    assert first[-1]["generation"] == 3


# ---- the torch frontend: DistributedOptimizer(AdamW) under elastic.run ----

TORCH_WORKER = textwrap.dedent(
    """
    import hashlib
    import importlib

    import torch

    hvd = importlib.import_module(FRONTEND)
    hvd.init(**INIT)
    torch.set_num_threads(1)
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 1))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-2),
        named_parameters=model.named_parameters())
    gen = torch.Generator().manual_seed(1)
    X = torch.randn(96, 8, generator=gen)
    Y = X.sum(1, keepdim=True)
    sampler = hvd.elastic.ElasticSampler(list(range(96)), shuffle=False)
    state = hvd.elastic.TorchState(model, opt, step=0, phase=0)
    state.register_reset_callbacks([sampler.reset])
    BATCH = 4

    def digest():
        h = hashlib.sha256()
        for t in model.state_dict().values():
            h.update(t.detach().numpy().tobytes())
        for group in opt.state_dict()["state"].values():
            for k in sorted(group):
                h.update(torch.as_tensor(group[k]).numpy().tobytes())
        return h.hexdigest()

    def loss_of(idx):
        return torch.nn.functional.mse_loss(model(X[idx]), Y[idx])

    @hvd.elastic.run
    def train(st):
        # After every sync (elastic.run's, before each attempt) all ranks
        # hold the same model and AdamW state.
        got = hvd.allgather_object(digest())
        log({"host": host_id, "rank": hvd.rank(), "size": hvd.size(),
             "synced_equal": len(set(got)) == 1, "ranks": len(got),
             "at": st.step})
        while True:
            size, rank = hvd.size(), hvd.rank()
            assert (sampler.num_replicas, sampler.rank) == (size, rank)
            mine = list(sampler)
            assert len(mine) == sampler.num_samples
            k = (st.step * BATCH) % len(mine)
            idx = [mine[(k + i) % len(mine)] for i in range(BATCH)]
            params = list(model.parameters())
            local = torch.autograd.grad(loss_of(idx), params)
            flat = torch.cat([g.reshape(-1) for g in local])
            every = hvd.allgather(flat.unsqueeze(0), name="local.grads")
            opt.zero_grad()
            loss_of(idx).backward()
            opt.synchronize()
            reduced = torch.cat([p.grad.reshape(-1) for p in params])
            mean = every.mean(0)
            mean_err = float((reduced - mean).abs().max() / mean.abs().max())
            with opt.skip_synchronize():
                opt.step()
            st.step += 1
            log({"host": host_id, "pid": os.getpid(), "rank": rank,
                 "size": size, "step": st.step, "mean_err": mean_err,
                 "shard": len(mine), "phase": st.phase})
            # The phase is committed state: every rank moves alike, rank 0
            # rewrites the discovery.
            if st.phase == 0 and st.step >= 3:
                st.phase = 1
                if rank == 0:
                    set_hosts(HOSTS[1])
            elif st.phase == 1 and size == len(HOSTS[1]) and st.step >= 6:
                st.phase = 2
                if rank == 0:
                    set_hosts(HOSTS[2])
            elif st.phase == 2 and size == len(HOSTS[2]) and st.step >= 9:
                log({"host": host_id, "final_step": st.step})
                return st.step
            st.commit()
            time.sleep(0.02)

    train(state)
    hvd.shutdown()
    """
)


TWO = ["localhost:1", "127.0.0.1:1"]
SCALINGS = {"1-2-1": [TWO[:1], TWO, TWO[:1]],
            "2-3-2": [TWO, TWO + ["127.0.0.2:1"], TWO]}


def _torch_scenario(tmp_path, side, hosts):
    head = f"HOSTS = {hosts!r}\n"
    if side == "port":
        body = (head + 'FRONTEND = "horovod_tpu_torch.torch"\n'
                'INIT = {"device": "cpu"}\n' + TORCH_WORKER)
        return run_elastic_scenario(
            str(tmp_path), body, initial_hosts=hosts[0], timeout=120.0)
    from elastic_harness import run_elastic_scenario as ref_scenario

    body = head + 'FRONTEND = "horovod_tpu.torch"\nINIT = {}\n' + TORCH_WORKER
    return ref_scenario(tmp_path, body, initial_hosts=hosts[0],
                        timeout=120.0)


# The JAX package's optimizer cannot pass through a world of one: wrapped
# at one rank it registers no hooks (horovod_tpu/torch/optimizer.py:71)
# and never reduces after a scale-up; wrapped at two, its synchronize at
# one returns before clearing the hooks' handles (:128), and the next
# zero_grad raises. Its twin runs the scaling that never reaches one
# (ROADMAP.md C20).
@pytest.mark.parametrize("side,scaling", [("port", "1-2-1"),
                                          ("port", "2-3-2"),
                                          ("ref", "2-3-2")])
def test_torch_frontend_rescales_in_place(tmp_path, side, scaling):
    hosts = SCALINGS[scaling]
    rc, records = _torch_scenario(tmp_path, side, hosts)
    assert rc == 0, f"{side}: elastic job failed rc={rc}: {records}"
    steps = [r for r in records if "step" in r]
    syncs = [r for r in records if "synced_equal" in r]
    finals = [r for r in records if "final_step" in r]
    assert finals and finals[-1]["final_step"] >= 9
    first = [r for r in steps if r["host"] == "localhost"]
    sizes = [len(h) for h in hosts]
    assert _sizes_in_order(first) == sizes, first
    big = max(hosts, key=len)
    assert {r["host"] for r in steps if r["size"] == len(big)} == {
        h.split(":")[0] for h in big}
    _steps_never_regress(steps)
    # The first process of each host after the start synced the committed
    # state: its first step follows rank 0's progress.
    first_step = {}
    for r in steps:
        first_step.setdefault(r["pid"], r["step"])
    assert sorted(first_step.values())[:len(hosts[0])] == [1] * len(
        hosts[0])
    assert len(first_step) > len(hosts[0])
    assert all(v > 1 for v in sorted(first_step.values())[len(hosts[0]):])
    # Every sync left the ranks equal, at every size.
    assert syncs and all(r["synced_equal"] for r in syncs), syncs
    assert {r["ranks"] for r in syncs} == set(sizes)
    # Every step reduced the mean of the live ranks' local gradients: bit
    # for bit at one and two ranks, where the sum and the halving are
    # exact; at three the sum's order and the runtime's 1/3 postscale
    # (rounded from double) move the last bits.
    for r in steps:
        assert r["mean_err"] <= (0.0 if r["size"] <= 2 else 1e-6), r
    # The sampler sharded 96 indices over the live world.
    assert {(r["size"], r["shard"]) for r in steps} == {
        (n, 96 // n) for n in sizes}


# ---- the TensorFlow frontend: a tf.function traced at size 1 --------------

TF_WORKER = textwrap.dedent(
    """
    import tensorflow as tf

    import horovod_tpu_torch.tensorflow as hvd

    hvd.init(device="cpu")
    model = tf.keras.Sequential([
        tf.keras.Input((4,)),
        tf.keras.layers.Dense(1, use_bias=False, kernel_initializer="ones"),
    ])
    state = hvd.TensorFlowKerasState(model=model, step=0)

    @tf.function
    def averaged_grad(x):
        with tf.GradientTape() as tape:
            loss = tf.reduce_sum(model(x))
        tape = hvd.DistributedGradientTape(tape)
        return tape.gradient(loss, model.trainable_variables)[0]

    @hvd.elastic.run
    def train(st):
        while True:
            size, rank = hvd.size(), hvd.rank()
            # Rank r's local gradient is r + 1 everywhere: the average over
            # the live world is (size + 1) / 2.
            g = averaged_grad(tf.fill([1, 4], float(rank + 1)))
            st.step += 1
            log({"host": host_id, "rank": rank, "size": size,
                 "step": st.step, "grad": float(g[0, 0]),
                 "traces": averaged_grad.experimental_get_tracing_count()})
            if rank == 0 and st.step == 3:
                set_hosts(["localhost:1", "127.0.0.1:1"])
            if size == 2 and st.step >= 6:
                return st.step
            st.commit()
            time.sleep(0.02)

    train(state)
    log({"host": host_id, "final_step": state.step})
    hvd.shutdown()
    """
)


def test_tf_function_traced_at_one_averages_over_the_live_size(tmp_path):
    rc, records = run_elastic_scenario(
        str(tmp_path), TF_WORKER, initial_hosts=["localhost:1"],
        extra_env={"TF_CPP_MIN_LOG_LEVEL": "3"}, timeout=150.0)
    assert rc == 0, f"elastic job failed rc={rc}: {records}"
    steps = [r for r in records if "step" in r]
    assert {r["host"] for r in records if "final_step" in r} == {
        "localhost", "127.0.0.1"}
    first = [r for r in steps if r["host"] == "localhost"]
    assert _sizes_in_order(first) == [1, 2], first
    _steps_never_regress(steps)
    for r in steps:
        assert r["grad"] == (r["size"] + 1) / 2, r
    # The first worker's function was traced once, at size 1, and ran on
    # at size 2 without a retrace.
    assert {r["traces"] for r in first} == {1}
    assert any(r["size"] == 2 for r in first)


# ---- the Keras scale-up (the reference's slow twin) -----------------------

KERAS_WORKER = textwrap.dedent(
    """
    import tensorflow as tf

    import horovod_tpu_torch.tensorflow as hvd
    from horovod_tpu_torch import native
    from horovod_tpu_torch.elastic import run as elastic_run
    from horovod_tpu_torch.keras.elastic import (
        CommitStateCallback, UpdateEpochStateCallback,
    )

    hvd.init(device="cpu")
    tf.keras.utils.set_random_seed(11)
    model = tf.keras.Sequential([
        tf.keras.layers.Dense(8, activation="relu"),
        tf.keras.layers.Dense(1),
    ])
    model.build((None, 4))
    opt = hvd.DistributedOptimizer(tf.keras.optimizers.SGD(0.02))
    model.compile(optimizer=opt, loss="mse")

    state = hvd.TensorFlowKerasState(model=model, optimizer=opt,
                                     epoch=0, batch=0)

    rng = np.random.RandomState(0)
    X = rng.randn(64, 4).astype(np.float32)
    y = X.sum(axis=1, keepdims=True).astype(np.float32)

    class LogEpochs(tf.keras.callbacks.Callback):
        def on_epoch_end(self, epoch, logs=None):
            log({"host": host_id, "epoch": epoch, "size": native.size(),
                 "loss": float(logs.get("loss", -1))})
            if host_id == "localhost" and epoch == 2 and native.size() == 1:
                set_hosts(["localhost:1", "127.0.0.1:1"])
                time.sleep(1.0)

    @elastic_run
    def train(st):
        hvd.broadcast_variables(st.model.variables, root_rank=0)
        st.model.fit(
            X, y, batch_size=16, initial_epoch=st.epoch, epochs=8,
            verbose=0,
            callbacks=[
                CommitStateCallback(st, batches_per_commit=2),
                UpdateEpochStateCallback(st),
                LogEpochs(),
            ],
        )
        return st.epoch

    final = train(state)
    log({"host": host_id, "final_epoch": final})
    hvd.shutdown()
    """
)


@pytest.mark.slow
def test_keras_elastic_scale_up(tmp_path):
    rc, records = run_elastic_scenario(
        str(tmp_path), KERAS_WORKER, initial_hosts=["localhost:1"],
        extra_env={"TF_CPP_MIN_LOG_LEVEL": "3"}, timeout=300.0)
    assert rc == 0, f"rc={rc}"
    epochs = [r for r in records if "epoch" in r]
    finals = [r for r in records if "final_epoch" in r]
    assert finals and max(f["final_epoch"] for f in finals) >= 8
    assert any(r["size"] == 1 for r in epochs)
    size2_hosts = {r["host"] for r in epochs if r["size"] == 2}
    assert size2_hosts == {"localhost", "127.0.0.1"}, size2_hosts
    joiner = [r for r in epochs if r["host"] == "127.0.0.1"]
    assert joiner and min(r["epoch"] for r in joiner) >= 2, joiner


# ---- C19: what a blown scenario deadline reports --------------------------


def test_timeout_diagnostics_leave_out_backtraces(tmp_path):
    """A worker log's tail in a deadline's diagnostics shows each
    incarnation's last messages: the C++ backtrace of a failed world
    formation (dozens of ``frame #`` lines) is left out of it."""
    from horovod_tpu_torch.tools.chaos_soak import timeout_diagnostics

    log_dir = tmp_path / "logs" / "rank.1"
    log_dir.mkdir(parents=True)
    lines = ["first incarnation: joined round 0\n"]
    for attempt in range(40):
        lines.append("Exception raised from recvBytes at tcputils.hpp\n")
        lines += [f"frame #{i}: c10d::TCPStore::wait + 0x2f\n"
                  for i in range(30)]
        lines.append(f"elastic join attempt failed (attempt {attempt}); "
                     "retrying\n")
    (log_dir / "stderr").write_text("".join(lines))
    tail = timeout_diagnostics(str(tmp_path))["logs"]["rank.1/stderr"]
    assert "frame #" not in tail and "Exception raised" not in tail
    assert tail.endswith("(attempt 39); retrying\n")
    assert "(attempt 30)" in tail


def test_a_failed_world_formation_leaves_no_trace_in_the_next(tmp_path,
                                                               monkeypatch):
    """C19b: every failed init_process_group advanced torch's count of
    unnamed groups, which names the world's rendezvous keys, and nothing
    reset it (only destroying a formed world does). A rank that had failed
    more formation attempts than its peer waited on other keys than the
    peer's at every later attempt (``/1//cpu//0/1`` against ``/0//...``),
    so the two never formed a world (a survivor and its respawned peer,
    as in the crash/respawn soaks under load). After ``context.shutdown``
    the next attempt names its group as a fresh process's first does."""
    from torch.distributed import distributed_c10d as c10d

    import horovod_tpu_torch as hvt

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    monkeypatch.setenv("HVT_DATA_TIMEOUT_SECS", "1")
    for attempt in range(2):
        hvt.context.shutdown(abort=True)
        assert c10d._world.group_count == 0, attempt
        with pytest.raises(RuntimeError):  # no peer comes
            hvt.init(device="cpu", backend="gloo",
                     init_method=f"file://{tmp_path}/store{attempt}")
        assert c10d._world.group_count == 1
    hvt.context.shutdown(abort=True)
    assert c10d._world.group_count == 0
