"""The port's dynamic-enqueue runtime (``horovod_tpu_torch.native``) against
the JAX package's native runtime (``horovod_tpu.native``).

Twins of ``tests/test_native_core.py``: its single-process cases, in this
process, and its multi-process cases that do not measure the TCP ring, the
shared-memory plane, the sanitizers or the autotuner (lines 187-423 and
499), each side on a world of 4, 3 and 2 worker processes running every
case of its suite once (``tests/torch_eager_ranks.py``): the port's on its
gloo group, the JAX package's on its TCP runtime. Tolerances: bit for bit
at world 1 and 2 and for integers (Adasum included); fp32 at 3 and 4
ranks within 1e-6 relative (gloo's and the ring's sums add in their own
orders). Join's last rank depends on arrival order: each side's must lie
in the world and agree across its ranks.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_eager_ranks as R
from horovod_tpu_torch import native
from horovod_tpu_torch.exceptions import HorovodInternalError, HorovodTpuError
from horovod_tpu_torch.native import cache as ncache
from horovod_tpu_torch.native import controller as nctl
from horovod_tpu_torch.native import messages as msg

SIZES = (4, 3, 2)
CASES = [(size, case.__name__) for size in SIZES
         for case in R.NATIVE_SUITES[size]]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    def run_ref(size):
        R.shared(tmp_path_factory, "refbuild", lambda: R.reference_build())
        return R.run_world("ref", size, size)

    return {
        (side, size): R.shared(
            tmp_path_factory, f"native_{side}_{size}",
            (lambda s=size: R.run_world("port", s, s)) if side == "port"
            else (lambda s=size: run_ref(s)))
        for side in ("port", "ref") for size in SIZES}


def _assert_close(port, ref, size, where):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, \
        (where, port.shape, ref.shape, port.dtype, ref.dtype)
    if size <= 2 or ref.dtype.kind in "iub":
        np.testing.assert_array_equal(port, ref, err_msg=where)
    else:
        np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-6 * max(
            1.0, float(np.abs(ref.astype(np.float64)).max())), err_msg=where)


@pytest.mark.parametrize("size,case", CASES)
def test_world_case_matches_the_reference(worlds, size, case):
    port, ref = worlds[("port", size)], worlds[("ref", size)]
    lasts = {"port": set(), "ref": set()}
    for rank in range(size):
        p, r = port[rank][case], ref[rank][case]
        assert set(p) == set(r), (rank, set(p) ^ set(r))
        for key, want in r.items():
            where = f"world {size} rank {rank} {case}.{key}"
            got = p[key]
            if key == "_seconds":
                continue
            if key == "last":
                lasts["port"].add(got)
                lasts["ref"].add(want)
            elif key == "error":  # the first rank to ask may be either
                assert got.split(":")[0] == want.split(":")[0], (
                    where, got, want)
            elif isinstance(want, np.ndarray):
                _assert_close(got, want, size, where)
            else:
                assert got == want, (where, got, want)
    for side, seen in lasts.items():
        if seen:  # one last rank a world, inside it
            assert len(seen) == 1 and 0 <= seen.pop() < size, (side, seen)


def test_the_cache_serves_repeats_from_the_second_step(worlds):
    """The fusion case rides the cache from its second step: 40 names
    missed once, then hit 3 x 40 times, on every rank of both sides."""
    for size in (4, 2):
        for side in ("port", "ref"):
            for rank in range(size):
                res = worlds[(side, size)][rank]["c_fusion_cache"]
                assert (res["cache_hits"], res["cache_misses"]) == (120, 40)
    repeated = worlds[("port", 2)][0]["c_grouped_repeated"]
    assert repeated["cache_hits"] == \
        worlds[("ref", 2)][0]["c_grouped_repeated"]["cache_hits"] == 6


@pytest.mark.parametrize("case,texts", [
    ("c_mismatch_shape", [
        "Mismatched ALLREDUCE tensor shapes: rank 0 has [1] but rank 1 has "
        "[2] for tensor bad.",
        "Mismatched ALLREDUCE tensor shapes: rank 1 has [2] but rank 0 has "
        "[1] for tensor bad."]),
    ("c_mismatch_dtype", [
        "Mismatched data types: rank 0 has float32 but rank 1 has float64 "
        "for tensor bad_dt.",
        "Mismatched data types: rank 1 has float64 but rank 0 has float32 "
        "for tensor bad_dt."]),
    ("c_broadcast_root_joined", ["broadcast root rank 1 has joined"]),
])
def test_errors_carry_the_reference_messages(worlds, case, texts):
    """The text names the rank whose request the coordinator saw first."""
    for side in ("port", "ref"):
        for rank in range(2):
            res = worlds[(side, 2)][rank][case]
            if "error" in res:
                assert res["error"] in texts, (side, rank, res["error"])
    assert "error" in worlds[("port", 2)][0][case]


def test_joins_return_a_rank_of_the_world(worlds):
    for size, case in ((3, "c_join_cached"), (3, "c_join_rank0"),
                       (3, "c_join_fusion_partition"), (2, "c_join_uneven"),
                       (2, "c_package_join")):
        for rank in range(size):
            assert 0 <= worlds[("port", size)][rank][case]["last"] < size
    # A joined rank took part with zeros: the subset's sums.
    sub = worlds[("port", 3)][0]["c_join_cached"]["subset"]
    np.testing.assert_array_equal(sub, np.full((2, 4), 2.0, np.float32))
    big = worlds[("port", 3)][1]["c_join_fusion_partition"]["big"]
    np.testing.assert_array_equal(big[:, 0], [2.0, 4.0])


# ---------------------------------------------------------------------------
# The single-process tier, in this process (world of one, on the CPU).
# ---------------------------------------------------------------------------


@pytest.fixture()
def runtime():
    native.init(0, 1, device="cpu")
    yield native
    native.shutdown()


@pytest.fixture()
def reference():
    from horovod_tpu import native as jn

    jn.init(0, 1)
    yield jn
    jn.shutdown()


class TestSingleProcess:
    def test_init_rank_size(self, runtime):
        assert native.is_initialized()
        assert (native.rank(), native.size()) == (0, 1)
        assert not native.shm_enabled()

    @pytest.mark.parametrize("op", ["SUM", "AVERAGE", "MIN", "MAX",
                                    "PRODUCT", "ADASUM"])
    def test_allreduce_ops_match_the_reference(self, runtime, reference, op):
        x = np.random.default_rng(0).standard_normal((2, 3)).astype(
            np.float32)
        got = native.allreduce(torch.from_numpy(x), op=getattr(native, op),
                               name=f"op.{op}")
        want = reference.allreduce(x, op=getattr(reference, op),
                                   name=f"op.{op}")
        np.testing.assert_array_equal(got.numpy(), want)

    def test_allreduce_prescale_postscale(self, runtime, reference):
        x = np.arange(5, dtype=np.float32) / 7
        got = native.synchronize(native.allreduce_async(
            "scaled", torch.from_numpy(x), prescale=2.0, postscale=1 / 3))
        want = reference.synchronize(reference.allreduce_async(
            "scaled", x, prescale=2.0, postscale=1 / 3))
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("dt", [torch.int32, torch.int64, torch.float16,
                                    torch.float32, torch.float64,
                                    torch.uint8, torch.int8, torch.bool,
                                    torch.bfloat16, torch.int16])
    def test_allreduce_dtypes(self, runtime, dt):
        x = torch.ones(5, dtype=dt)
        got = native.allreduce(x, name=f"dt.{dt}")
        assert got.dtype == dt
        assert torch.equal(got, x)

    def test_allgather_broadcast_alltoall_reducescatter(self, runtime):
        x = torch.arange(6, dtype=torch.int32).reshape(3, 2)
        assert torch.equal(native.allgather(x, name="ag"), x)
        y = torch.arange(4, dtype=torch.float64)
        assert torch.equal(native.broadcast(y, name="bc"), y)
        out, splits = native.alltoall(torch.arange(3), [3], name="a2a")
        assert out.tolist() == [0, 1, 2] and splits.tolist() == [3]
        z = torch.arange(8, dtype=torch.float32)
        assert torch.equal(native.reducescatter(z, name="rs"), z)

    def test_join_and_barrier(self, runtime):
        native.barrier()
        assert native.join() == 0

    def test_package_join_goes_to_the_runtime(self, runtime):
        import horovod_tpu_torch as hvt

        assert hvt.join() == 0

    def test_package_join_without_runtime_is_minus_one(self):
        import horovod_tpu_torch as hvt

        assert not native.is_initialized()
        assert hvt.join() == -1

    def test_duplicate_name_rejected(self, runtime):
        # The first "dup" waits for its group's second member, so it is
        # still in flight when the second "dup" arrives.
        x = torch.zeros(2)
        h1 = native.allreduce_async("dup", x, group_name="g", group_size=2)
        h2 = native.allreduce_async("dup", x)
        with pytest.raises(HorovodTpuError, match="already in flight"):
            native.synchronize(h2)
        h3 = native.allreduce_async("other", x, group_name="g", group_size=2)
        native.synchronize(h1)
        native.synchronize(h3)

    def test_grouped_allreduce(self, runtime):
        x = torch.ones(3)
        hs = [native.allreduce_async(f"grp.{i}", x * i, group_name="grp",
                                     group_size=3) for i in range(3)]
        for i, h in enumerate(hs):
            assert torch.equal(native.synchronize(h), x * i)

    def test_inplace_writes_the_callers_tensor(self, runtime):
        t = torch.full((6,), 3.0)
        ptr = t.data_ptr()
        native.synchronize(native.allreduce_async("inpl", t, out=t,
                                                  postscale=2.0))
        assert t.data_ptr() == ptr and torch.equal(t, torch.full((6,), 6.0))

    def test_reinit_after_shutdown(self):
        x = torch.ones(2)
        for _ in range(2):
            native.init(0, 1, device="cpu")
            assert torch.equal(native.allreduce(x, name="a"), x)
            native.shutdown()
        assert not native.is_initialized()

    def test_timeline_written(self, tmp_path, monkeypatch):
        import json

        path = tmp_path / "timeline.json"
        monkeypatch.setenv("HVT_TIMELINE", str(path))
        native.init(0, 1, device="cpu")
        native.allreduce(torch.ones(4), name="traced")
        native.shutdown()
        events = json.loads(path.read_text())
        names = {e.get("name") for e in events}
        assert {"NEGOTIATE", "ALLREDUCE"} <= names

    def test_cache_hits_from_the_second_step(self, runtime):
        c0 = native.metrics_counters()
        for step in range(3):
            hs = [native.allreduce_async(f"s.{i}", torch.ones(4) * step)
                  for i in range(5)]
            for h in hs:
                native.synchronize(h)
        c1 = native.metrics_counters()
        assert c1["cache_misses"] - c0["cache_misses"] == 5
        assert c1["cache_hits"] - c0["cache_hits"] == 10
        assert c1["cycles"] > c0["cycles"]
        assert c1["fused_tensors"] - c0["fused_tensors"] == 15
        assert c1["shm_bytes"] == 0

    def test_counter_names_are_the_references(self, runtime, reference):
        from horovod_tpu.obs.native_bridge import read_native as jread

        from horovod_tpu_torch.obs.native_bridge import read_native

        assert native.METRICS_ABI == reference.METRICS_ABI
        assert set(native.metrics_counters()) == set(
            reference.metrics_counters())
        native.allreduce(torch.ones(2), name="nb")
        reference.allreduce(np.ones(2, np.float32), name="nb")
        assert set(read_native()) == set(jread())

    def test_integer_average_is_a_floor_division(self, runtime):
        # The JAX package's eager path floors (ops/eager.py); its native
        # runtime scales by 1/n and truncates, which differs for negative
        # sums. The port floors (ROADMAP §C).
        got = native.allreduce(torch.tensor([-3, 3, 5], dtype=torch.int32),
                               op=native.AVERAGE, name="iavg")
        assert got.tolist() == [-3, 3, 5]  # a world of one divides by 1

    def test_wait_timeout_and_poll(self, runtime):
        h = native.allreduce_async("p", torch.ones(3))
        while not native.poll(h):
            pass
        assert torch.equal(native.synchronize(h, timeout=5.0), torch.ones(3))


class TestNoFallback:
    def test_init_without_cuda_raises(self):
        if torch.cuda.is_available():
            pytest.skip("this box has CUDA")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            native.init(0, 1)
        assert not native.is_initialized()

    def test_a_device_tensor_on_a_cpu_runtime_raises(self, runtime):
        with pytest.raises(HorovodTpuError, match="initialized for the CPU"):
            native.allreduce_async("meta", torch.empty(2, device="meta"))

    def test_a_runtime_of_several_needs_a_rendezvous(self, monkeypatch):
        for k in ("HVT_COORD_PORT", "HVDTPU_RENDEZVOUS_ADDR",
                  "HVDTPU_RENDEZVOUS_PORT", "MASTER_ADDR"):
            monkeypatch.delenv(k, raising=False)
        monkeypatch.setattr(torch.distributed, "is_initialized",
                            lambda: False)
        with pytest.raises(HorovodTpuError, match="needs HVT_COORD_PORT"):
            native.init(0, 2, device="cpu")

    def test_calls_before_init_raise(self):
        with pytest.raises(HorovodInternalError, match="not initialized"):
            native.allreduce_async("x", torch.ones(1))


def test_the_eager_modules_import_no_jax_in_a_fresh_interpreter():
    code = (
        "import sys\n"
        "import horovod_tpu_torch.native, horovod_tpu_torch.torch\n"
        "import horovod_tpu_torch.ops.eager, horovod_tpu_torch.utils.stall\n"
        "import horovod_tpu_torch.obs.native_bridge\n"
        "from horovod_tpu_torch import native\n"
        "native.init(0, 1, device='cpu')\n"
        "native.allreduce(__import__('torch').ones(2), name='x')\n"
        "native.shutdown()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'horovod_tpu')]\n"
        "maps = open('/proc/self/maps').read()\n"
        "print('BAD', bad, 'libhvtcore' in maps)\n")
    env = dict(os.environ, PYTHONPATH=R.REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD [] False" in out.stdout, out.stdout


# ---------------------------------------------------------------------------
# The pieces, held to the reference's semantics.
# ---------------------------------------------------------------------------


def _req(name, **kw):
    base = dict(name=name, dtype=msg.F32, shape=(4,))
    base.update(kw)
    return msg.Request(**base)


class TestResponseCache:
    def test_hit_miss_invalid_and_lru_eviction(self):
        c = ncache.ResponseCache(capacity=2)
        a, b, d = _req("a"), _req("b"), _req("d")
        assert c.lookup(a) == ncache.CacheState.MISS
        c.put(a, msg.Response(names=["a"]))
        c.put(b, msg.Response(names=["b"]))
        assert c.lookup(a) == ncache.CacheState.HIT
        assert c.lookup(_req("a", shape=(5,))) == ncache.CacheState.INVALID
        c.touch(c.bit_of("a"))  # b is now the least recently used
        c.put(d, msg.Response(names=["d"]))
        assert c.bit_of("b") == -1 and c.bit_of("a") >= 0
        assert c.bit_of("d") == 1  # b's freed slot reused

    def test_bit_vectors_round_trip(self):
        c = ncache.ResponseCache()
        for i in range(130):
            c.put(_req(f"t{i}"), msg.Response(names=[f"t{i}"]))
        vec = c.make_bitvector([0, 63, 64, 129])
        assert len(vec) == 3
        assert c.bits_from_vector(vec) == [0, 63, 64, 129]

    def test_evict_by_name_and_capacity_zero(self):
        c = ncache.ResponseCache(capacity=0)
        c.put(_req("a"), msg.Response(names=["a"]))
        assert len(c) == 0
        c = ncache.ResponseCache()
        c.put(_req("a"), msg.Response(names=["a"]))
        c.evict_by_name("a")
        assert c.lookup(_req("a")) == ncache.CacheState.MISS


class TestCoordinator:
    def _coord(self, size=2):
        return nctl.Coordinator(size, ncache.ResponseCache())

    def test_readiness_accumulates_across_cycles(self):
        c = self._coord()
        c.ingest(msg.RequestList(requests=[_req("x")]), 0)
        assert c.compute(1 << 20, 1000).responses == []
        c.ingest(msg.RequestList(), 1)
        c.ingest(msg.RequestList(requests=[_req("x")]), 1)
        out = c.compute(1 << 20, 1000)
        assert [r.names for r in out.responses] == [["x"]]
        assert out.responses[0].fusion_bytes == 16

    @pytest.mark.parametrize("other,text", [
        (dict(type=msg.RequestType.BROADCAST), "Mismatched collective "
         "operations: rank 0 requested ALLREDUCE but rank 1 requested "
         "BROADCAST for tensor x."),
        (dict(dtype=msg.F64), "Mismatched data types: rank 0 has float32 "
         "but rank 1 has float64 for tensor x."),
        (dict(shape=(2, 2)), "Mismatched ALLREDUCE tensor shapes: rank 0 "
         "has [4] but rank 1 has [2, 2] for tensor x."),
        (dict(reduce_op=msg.MAX), "Mismatched reduce op or scale factors "
         "across ranks for tensor x."),
    ])
    def test_mismatches_answer_an_error(self, other, text):
        c = self._coord()
        c.ingest(msg.RequestList(requests=[_req("x")]), 0)
        c.ingest(msg.RequestList(requests=[_req("x", **other)]), 1)
        (resp,) = c.compute(1 << 20, 1000).responses
        assert resp.type == msg.ResponseType.ERROR
        assert resp.error_message == text

    def test_groups_wait_for_every_member(self):
        c = nctl.Coordinator(1, ncache.ResponseCache())
        g = dict(group_name="g", group_size=2)
        c.ingest(msg.RequestList(requests=[_req("g.0", **g)]), 0)
        assert c.compute(1 << 20, 1000).responses == []
        c.ingest(msg.RequestList(requests=[_req("g.1", **g)]), 0)
        assert [r.names for r in c.compute(1 << 20, 1000).responses] == [
            ["g.0"], ["g.1"]]

    def test_join_narrows_the_participants(self):
        c = self._coord(3)
        c.ingest(msg.RequestList(requests=[msg.Request(
            type=msg.RequestType.JOIN, name=msg.JOIN_NAME)]), 2)
        for r in (0, 1):
            c.ingest(msg.RequestList(requests=[_req("t")]), r)
        (resp,) = c.compute(1 << 20, 1000).responses
        assert resp.participants == [0, 1]


class TestFuseResponses:
    def _resp(self, name, **kw):
        return msg.Response(names=[name], **kw)

    def test_threshold_dtype_and_device_split_buckets(self):
        rs = [self._resp("a"), self._resp("b"), self._resp("c", dtype=msg.F16),
              self._resp("d", device="cuda"), self._resp("e")]
        nbytes = {"a": 100, "b": 100, "c": 10, "d": 10, "e": 100}
        out = nctl.fuse_responses(rs, 256, False, nbytes, {})
        assert [r.names for r in out] == [["a", "b"], ["c"], ["d"], ["e"]]

    def test_groups_always_fuse_and_stay_apart_when_disabled(self):
        rs = [self._resp("x"), self._resp("g0"), self._resp("g1")]
        nbytes = {"x": 64, "g0": 1 << 20, "g1": 1 << 20}
        groups = {"g0": "g", "g1": "g"}
        out = nctl.fuse_responses(rs, 128, False, nbytes, groups)
        assert [r.names for r in out] == [["x"], ["g0", "g1"]]
        out = nctl.fuse_responses(rs, 1 << 30, True, nbytes, groups)
        assert [r.names for r in out] == [["x"], ["g0", "g1"]]
        out = nctl.fuse_responses(rs, 1 << 30, False, nbytes, groups)
        assert [r.names for r in out] == [["x", "g0", "g1"]]

    def test_non_allreduce_responses_keep_their_place(self):
        rs = [self._resp("a"), self._resp("b", type=msg.ResponseType.BROADCAST)]
        out = nctl.fuse_responses(rs, 1 << 20, False, {"a": 4, "b": 4}, {})
        assert [r.type for r in out] == [msg.ResponseType.BROADCAST,
                                         msg.ResponseType.ALLREDUCE]
