"""The port's live weight stream (``horovod_tpu_torch.stream``), held
against the JAX package's (``horovod_tpu.stream``; the twin of
``tests/test_weight_stream.py``): the wire framing, the guard-gated
publisher and the torn-set-proof subscriber, on torch tensors.

Across the two packages: the frames and the whole KV a publisher writes
byte for byte the JAX package's for the same parameters (fp32 and bf16
leaves); the JAX publisher's versions applied by the port's subscriber
and the other way round on a GPT-2 tiny tree, bit for bit; a capture
held behind the guard gate keeps its own step's bytes though the
optimizer updates the parameters in place; a flat trainer dict packs in
the nested serving tree's order; ``DecodeEngine.attach_stream`` on a tiny
``CacheLM``; the int8 subscriber re-quantizing only the changed buckets.
The end-to-end proof is the ``stream`` soak (last test, ~20 s). Every
comparison is exact (bytes or ``torch.equal``).
"""

import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch import chaos
from horovod_tpu_torch import checkpoint as ckptlib
from horovod_tpu_torch.guard import ConsistencyAuditor, fingerprint
from horovod_tpu_torch.guard import inject as guard_inject
from horovod_tpu_torch.stream import (
    StreamSubscriber,
    TornSetError,
    WeightPublisher,
    protocol,
)


@pytest.fixture(autouse=True)
def _chaos_clean():
    chaos._reset_for_tests()
    yield
    chaos._reset_for_tests()


class MemKV:
    """put/delete/scope_items duck-type of the rendezvous server
    (in-process)."""

    def __init__(self):
        self.store = {}
        self.puts = []  # (scope, key) in write order
        self.deletes = []  # (scope, key) in delete order

    def put(self, scope, key, value):
        self.store.setdefault(scope, {})[key] = value
        self.puts.append((scope, key))

    def delete(self, scope, key):
        self.store.get(scope, {}).pop(key, None)
        self.deletes.append((scope, key))

    def scope_items(self, scope):
        return dict(self.store.get(scope, {}))


def _params(step, n=64):
    """Two leaves big enough to land in separate pack buckets under a
    small threshold; ``b`` never changes — the delta-encoding probe."""
    return {
        "a": torch.full((n,), float(step), dtype=torch.float32),
        "b": torch.arange(n, dtype=torch.float32),
    }


THRESH = 64 * 4  # one leaf per bucket


def _mk_sub(kv, template, applied, **kw):
    kw.setdefault("poll_secs", 0.01)
    kw.setdefault("staleness_secs", 1e9)
    return StreamSubscriber(
        None,
        template_params=template,
        kv=kv,
        apply=lambda tree, v: applied.append((v, tree)),
        **kw,
    )


# ---- wire protocol ------------------------------------------------------


class TestProtocol:
    def test_blob_roundtrip(self):
        blob = protocol.frame_blob({"kind": "bucket", "index": 3}, b"abc")
        header, payload = protocol.unframe_blob(blob)
        assert payload == b"abc"
        assert header["index"] == 3 and header["nbytes"] == 3

    def test_missing_and_magic(self):
        with pytest.raises(TornSetError, match="missing"):
            protocol.unframe_blob(None)
        with pytest.raises(TornSetError, match="magic"):
            protocol.unframe_blob(b"not a frame at all")

    def test_payload_corruption_caught(self):
        blob = protocol.frame_blob({"kind": "bucket"}, b"payload-bytes")
        flipped = bytearray(blob)
        flipped[-1] ^= 0xFF
        with pytest.raises(TornSetError, match="crc"):
            protocol.unframe_blob(bytes(flipped))

    def test_truncation_caught(self):
        blob = protocol.frame_blob({"kind": "bucket"}, b"payload-bytes")
        with pytest.raises(TornSetError):
            protocol.unframe_blob(blob[:-4])

    def test_header_corruption_caught(self):
        blob = protocol.frame_blob({"kind": "bucket"}, b"xyz")
        i = len(protocol.MAGIC) + 12  # inside the header json
        flipped = bytearray(blob)
        flipped[i] ^= 0xFF
        with pytest.raises(TornSetError):
            protocol.unframe_blob(bytes(flipped))

    def test_manifest_roundtrip_and_kind_check(self):
        m = protocol.frame_manifest(
            version=7, epoch=2, step=7, layout={"n_buckets": 1},
            buckets=[{"index": 0, "key": "v7/0", "crc": 1, "nbytes": 4}],
        )
        got = protocol.unframe_manifest(m)
        assert got["version"] == 7 and got["epoch"] == 2
        not_manifest = protocol.frame_blob({"kind": "bucket"}, b"")
        with pytest.raises(TornSetError, match="manifest"):
            protocol.unframe_manifest(not_manifest)

    def test_verify_bucket_rejects_substitution(self):
        blob = protocol.frame_blob({"kind": "bucket", "index": 0}, b"old")
        header, payload = protocol.unframe_blob(blob)
        with pytest.raises(TornSetError, match="manifest entry"):
            protocol.verify_bucket(
                header, payload,
                {"index": 0, "crc": header["crc"] + 1, "nbytes": 3},
            )


# ---- publisher → subscriber ---------------------------------------------


class TestPublishSubscribe:
    def test_end_to_end_apply(self):
        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH
        )
        applied = []
        sub = _mk_sub(kv, _params(0), applied)
        assert pub.maybe_publish(_params(1), 1) == 1
        assert sub.poll_once() == 1
        v, tree = applied[-1]
        assert v == 1
        assert torch.equal(tree["a"], _params(1)["a"])
        # Same head again: no re-apply.
        assert sub.poll_once() is None
        assert sub.n_applied == 1

    def test_cadence_respected(self):
        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=3, epoch=0, threshold_bytes=THRESH
        )
        for s in range(1, 7):
            pub.maybe_publish(_params(s), s)
        versions = {
            protocol.unframe_manifest(v)["version"]
            for k, v in kv.store["stream"].items() if k == "head"
        }
        assert versions == {6}
        assert pub.n_published == 2  # steps 3 and 6

    def test_delta_reuses_unchanged_bucket_key(self):
        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH
        )
        pub.maybe_publish(_params(1), 1)
        n_puts_v1 = len(kv.puts)
        pub.maybe_publish(_params(2), 2)
        manifest = protocol.unframe_manifest(kv.store["stream"]["head"])
        keys = {e["index"]: e["key"] for e in manifest["buckets"]}
        # Leaf "a" changed (its bucket re-uploaded under v2); leaf "b"
        # did not (its manifest entry still points at the v1 copy).
        assert any(k.startswith("v2/") for k in keys.values())
        assert any(k.startswith("v1/") for k in keys.values())
        # Only the changed bucket + the manifest hit the wire.
        assert len(kv.puts) - n_puts_v1 == 2
        applied = []
        sub = _mk_sub(kv, _params(0), applied)
        assert sub.poll_once() == 2

    def test_disabled_cadence_publishes_nothing(self):
        kv = MemKV()
        pub = WeightPublisher(kv, publish_every=0, epoch=0)
        assert pub.maybe_publish(_params(1), 1) is None
        assert kv.store == {}


# ---- torn sets ----------------------------------------------------------


class TestTornSet:
    def test_chaos_torn_set_rejected_wholesale(self):
        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH
        )
        applied = []
        sub = _mk_sub(kv, _params(0), applied)
        pub.maybe_publish(_params(1), 1)
        assert sub.poll_once() == 1
        chaos.plan("publish.delta:torn@step=2;n=1", seed=3)
        pub.maybe_publish(_params(2), 2)
        assert pub.n_torn_injected == 1
        chaos.clear()
        assert sub.poll_once() is None
        assert sub.n_torn == 1
        assert [v for v, _ in applied] == [1]  # previous weights serve on
        # A torn head is counted ONCE, not once per poll tick.
        assert sub.poll_once() is None
        assert sub.n_torn == 1
        # The stream heals on the next complete version.
        pub.maybe_publish(_params(3), 3)
        assert sub.poll_once() == 3

    def test_chaos_corrupt_blob_rejected(self):
        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH
        )
        applied = []
        sub = _mk_sub(kv, _params(0), applied)
        chaos.plan("publish.delta:corrupt@step=1", seed=5)
        pub.maybe_publish(_params(1), 1)
        chaos.clear()
        assert sub.poll_once() is None
        assert sub.n_torn == 1 and applied == []
        # The corrupt copy never entered the publisher's written-cache,
        # so the next version re-writes the bucket and delivery heals.
        pub.maybe_publish(_params(2), 2)
        assert sub.poll_once() == 2

    def test_layout_mismatch_rejected(self):
        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH
        )
        pub.maybe_publish(_params(1), 1)
        applied = []
        wrong_template = {"a": torch.zeros(3)}
        sub = _mk_sub(kv, wrong_template, applied)
        assert sub.poll_once() is None
        assert sub.n_torn == 1 and applied == []


# ---- epochs -------------------------------------------------------------


class TestEpochGuard:
    def test_stale_epoch_rejected(self):
        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=1, threshold_bytes=THRESH
        )
        applied = []
        sub = _mk_sub(kv, _params(0), applied)
        pub.maybe_publish(_params(5), 5)
        assert sub.poll_once() == 5
        # A dead predecessor's late write: lower epoch, higher version.
        kv.put("stream", protocol.HEAD_KEY, protocol.frame_manifest(
            version=9, epoch=0, step=9, layout={}, buckets=[],
        ))
        assert sub.poll_once() is None
        assert sub.n_epoch_rejected == 1
        assert [v for v, _ in applied] == [5]

    def test_epoch_bump_resets_version_floor(self):
        kv = MemKV()
        applied = []
        sub = _mk_sub(kv, _params(0), applied)
        WeightPublisher(
            kv, publish_every=1, epoch=1, threshold_bytes=THRESH
        ).maybe_publish(_params(5), 5)
        assert sub.poll_once() == 5
        # The respawned trainer resumed from a restored checkpoint: its
        # versions restart below 5 but under a HIGHER epoch — accepted.
        WeightPublisher(
            kv, publish_every=1, epoch=2, threshold_bytes=THRESH
        ).maybe_publish(_params(3), 3)
        assert sub.poll_once() == 3
        assert [(v, e) for v, e in sub.applied_log] == [(5, 1), (3, 2)]

    def test_same_epoch_replay_ignored(self):
        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH
        )
        applied = []
        sub = _mk_sub(kv, _params(0), applied)
        pub.maybe_publish(_params(2), 2)
        assert sub.poll_once() == 2
        head_v2 = kv.store["stream"]["head"]
        pub.maybe_publish(_params(3), 3)
        assert sub.poll_once() == 3
        kv.put("stream", "head", head_v2)  # same-epoch lower version
        assert sub.poll_once() is None
        assert sub.n_applied == 2


# ---- the guard gate -----------------------------------------------------


class _AuditWorld:
    """3-rank in-process audit transport (the test_guard idiom): rank
    trees registered up front, allgather/broadcast read them directly."""

    def __init__(self, tree):
        self.trees = [
            {k: v.clone() for k, v in tree.items()} for _ in range(3)
        ]
        self.hosts = ["h0", "h1", "h2"]

    def auditor(self, rank):
        def allgather_object(obj):
            return [
                {
                    "rank": r,
                    "host": self.hosts[r],
                    "crc": fingerprint(self.trees[r]),
                }
                for r in range(len(self.trees))
            ]

        def broadcast_leaf(arr, root, name):
            i = int(name.rsplit(".", 1)[1])
            return [self.trees[root][k] for k in sorted(self.trees[root])][i]

        return ConsistencyAuditor(
            rank=rank,
            host_id=self.hosts[rank],
            allgather_object=allgather_object,
            broadcast_leaf=broadcast_leaf,
            on_report=lambda host, count: None,
        )


class _GateRuntime:
    """What the publisher gate reads off a real GuardRuntime, backed by
    a real auditor."""

    audit_armed = True

    def __init__(self, auditor):
        self._auditor = auditor

    @property
    def last_verified_step(self):
        return self._auditor.last_verified_step

    @property
    def last_report(self):
        return self._auditor.last_report


class TestGuardGatedPublish:
    def test_bitflip_blocks_publish_until_audit_heals(self):
        """A ``grad.bitflip`` fired between audit windows corrupts one
        rank silently; every publish captured after it must stay inside
        the training plane until the next audit heals the world — and
        the capture taken from pre-heal state is discarded, never
        published."""
        world = _AuditWorld(_params(1))
        auditor = world.auditor(0)
        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH,
            guard_runtime=_GateRuntime(auditor),
        )
        # Audit window at step 1: clean world, step 1 attested.
        auditor.audit(world.trees[0], step=1)
        assert pub.maybe_publish(world.trees[0], 1) == 1

        # The silent fault, between audit windows: the real chaos site,
        # through the real post-commit injection hook, flips one bit of
        # rank 1's params. No guard scalar trips; only the audit can see.
        chaos.plan("grad.bitflip:bitflip@step=2;rank=1;n=1", seed=11)
        for r in range(3):
            world.trees[r] = guard_inject.maybe_corrupt_params(
                world.trees[r], 2, r
            )
        chaos.clear()
        assert fingerprint(world.trees[1]) != fingerprint(world.trees[0])

        # The next publish is BLOCKED: the audit has only verified
        # through step 1, and the capture is from step 2.
        assert pub.maybe_publish(world.trees[0], 2) is None
        assert pub.n_blocked >= 1 and pub.last_version == 1
        head = protocol.unframe_manifest(kv.store["stream"]["head"])
        assert head["version"] == 1

        # Audit window at step 3: divergence found, healed by resync.
        healed, report = auditor.audit(world.trees[0], step=3)
        assert report.diverged and report.healed == "resync"
        assert auditor.last_verified_step == 3
        world.trees[0] = healed

        # The gate is open again — but the step-2 capture predates the
        # heal and is PURGED, not published: pre-heal bytes must never
        # reach the fleet.
        assert pub.flush() is None
        assert pub.last_version == 1
        assert len(pub._pending) == 0

        # Post-heal state flows the moment the audit covers it.
        assert pub.maybe_publish(world.trees[0], 3) == 3
        versions = sorted(
            protocol.unframe_manifest(v)["version"]
            for k, v in kv.store["stream"].items()
            if protocol.unframe_blob(v)[0].get("kind") == "manifest"
        )
        assert versions == [3]  # head overwrote v1; v2 never existed

    def test_unarmed_guard_publishes_ungated(self):
        class Unarmed:
            audit_armed = False
            last_verified_step = None
            last_report = None

        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH,
            guard_runtime=Unarmed(),
        )
        assert pub.maybe_publish(_params(1), 1) == 1

    def test_armed_but_unaudited_blocks_every_publish(self):
        """With the guard armed but no audit landed yet
        (``last_verified_step is None``), NOTHING may publish — "armed
        but unverified" must read as a closed gate, not as ungated.
        The first attested step opens it."""
        class Armed:
            audit_armed = True
            last_verified_step = None
            last_report = None

        gate = Armed()
        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH,
            guard_runtime=gate,
        )
        assert pub.maybe_publish(_params(1), 1) is None
        assert pub.maybe_publish(_params(2), 2) is None
        assert pub.n_blocked >= 2 and "stream" not in kv.store
        # First audit attests step 1: exactly the covered delta flows.
        gate.last_verified_step = 1
        assert pub.flush() == 1
        assert [p[0] for p in pub._pending] == [2]

    def test_max_pending_cap_drops_oldest(self):
        class NothingVerified:
            audit_armed = True
            last_verified_step = None
            last_report = None

        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH,
            guard_runtime=NothingVerified(), max_pending=2,
        )
        for s in range(1, 6):
            assert pub.maybe_publish(_params(s), s) is None
        assert [p[0] for p in pub._pending] == [4, 5]
        assert "stream" not in kv.store  # nothing leaked past the gate


# ---- staleness fallback -------------------------------------------------


class TestStalenessFallback:
    def test_stalled_stream_falls_back_to_checkpoint(self, tmp_path):
        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH
        )
        applied = []
        ckdir = str(tmp_path / "serve_ckpt")
        sub = _mk_sub(
            kv, _params(0), applied,
            staleness_secs=0.05, ckpt_dir=ckdir,
        )
        pub.maybe_publish(_params(1), 1)
        assert sub.poll_once() == 1
        # The trainer goes quiet past the staleness budget while a
        # newer whole checkpoint lands on disk.
        ckptlib.save_checkpoint(ckdir, _params(9), step=9, force=True)
        time.sleep(0.08)
        assert sub.poll_once() is None
        assert sub.n_fallbacks == 1
        v, tree = applied[-1]
        assert v is None  # checkpoint fallback, not a stream version
        assert torch.equal(tree["a"], _params(9)["a"])

    def test_fresh_stream_does_not_fall_back(self, tmp_path):
        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH
        )
        applied = []
        ckdir = str(tmp_path / "serve_ckpt")
        ckptlib.save_checkpoint(ckdir, _params(9), step=9, force=True)
        sub = _mk_sub(
            kv, _params(0), applied,
            staleness_secs=30.0, ckpt_dir=ckdir,
        )
        pub.maybe_publish(_params(1), 1)
        assert sub.poll_once() == 1
        assert sub.poll_once() is None
        assert sub.n_fallbacks == 0  # stream is live: no fallback


# ---- KV outage ----------------------------------------------------------


class TestKVOutage:
    def test_publish_survives_transient_outage(self):
        class FlakyKV(MemKV):
            def __init__(self, fail_n):
                super().__init__()
                self.fail_n = fail_n

            def put(self, scope, key, value):
                if self.fail_n > 0:
                    self.fail_n -= 1
                    raise OSError("kv down")
                super().put(scope, key, value)

        kv = FlakyKV(fail_n=2)  # inside the per-put retry budget
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH
        )
        assert pub.maybe_publish(_params(1), 1) == 1

    def test_pending_retained_across_hard_outage(self):
        class DeadKV(MemKV):
            def __init__(self):
                super().__init__()
                self.dead = True

            def put(self, scope, key, value):
                if self.dead:
                    raise OSError("kv down")
                super().put(scope, key, value)

        kv = DeadKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH
        )
        assert pub.maybe_publish(_params(1), 1) is None
        assert len(pub._pending) == 1  # capture survives the outage
        kv.dead = False
        assert pub.flush() == 1


# ---- malformed manifests -------------------------------------------------


class TestMalformedManifest:
    def _pub_sub(self):
        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH
        )
        applied = []
        sub = _mk_sub(kv, _params(0), applied)
        pub.maybe_publish(_params(1), 1)
        assert sub.poll_once() == 1
        return kv, sub, applied

    def _republish(self, kv, buckets, layout):
        kv.put("stream", protocol.HEAD_KEY, protocol.frame_manifest(
            version=2, epoch=0, step=2, layout=layout, buckets=buckets,
        ))

    def test_duplicate_bucket_index_rejected_as_torn(self):
        """A CRC-valid manifest whose bucket list names index 0 twice
        (and index 1 never) must reject through the torn-set path —
        not leave a ``None`` buffer that escapes as a generic
        exception with no ``stream.torn_rejected`` accounting."""
        kv, sub, applied = self._pub_sub()
        m = protocol.unframe_manifest(kv.store["stream"]["head"])
        buckets = m["buckets"]
        buckets[1] = dict(buckets[0])  # index 0 twice, same key/crc
        self._republish(kv, buckets, m["layout"])
        assert sub.poll_once() is None
        assert sub.n_torn == 1
        assert [v for v, _ in applied] == [1]

    def test_out_of_range_bucket_index_rejected_as_torn(self):
        kv, sub, applied = self._pub_sub()
        m = protocol.unframe_manifest(kv.store["stream"]["head"])
        buckets = m["buckets"]
        buckets[1] = dict(buckets[1], index=5)
        self._republish(kv, buckets, m["layout"])
        assert sub.poll_once() is None
        assert sub.n_torn == 1
        assert [v for v, _ in applied] == [1]


# ---- guard walk-back -----------------------------------------------------


class TestGuardWalkBack:
    def test_failed_walkback_retries_until_checkpoint_appears(self, tmp_path):
        """A guard strike covering the served version must not be
        consumed by a FAILED restore (no intact checkpoint yet, or a
        transient FS error): every later poll retries the walk-back
        until it lands — disowned weights never keep serving on the
        strength of one log line."""
        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH
        )
        applied = []
        ckdir = str(tmp_path / "serve_ckpt")  # nothing saved here yet
        sub = _mk_sub(kv, _params(0), applied, ckpt_dir=ckdir)
        pub.maybe_publish(_params(5), 5)
        assert sub.poll_once() == 5
        # The training plane disowns step 5; the restore fails (empty
        # checkpoint dir) — the strike must stay pending.
        kv.put("guard", "divergent/h1", b"1:5")
        assert sub.poll_once() is None
        assert sub.n_rollbacks == 0
        # An intact checkpoint lands: the NEXT poll retries the same
        # strike and the walk-back succeeds.
        ckptlib.save_checkpoint(ckdir, _params(4), step=4, force=True)
        sub.poll_once()
        assert sub.n_rollbacks == 1
        v, tree = applied[-1]
        assert v is None  # checkpoint walk-back, not a stream version
        assert torch.equal(tree["a"], _params(4)["a"])
        # Now consumed: the same report never strikes twice.
        sub.poll_once()
        assert sub.n_rollbacks == 1

    def test_stale_strike_consumed_without_rollback(self, tmp_path):
        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH
        )
        ckdir = str(tmp_path / "serve_ckpt")
        ckptlib.save_checkpoint(ckdir, _params(1), step=1, force=True)
        applied = []
        sub = _mk_sub(kv, _params(0), applied, ckpt_dir=ckdir)
        pub.maybe_publish(_params(5), 5)
        assert sub.poll_once() == 5
        # A strike from BEFORE what we serve: no action owed, and it
        # must not linger as pending work either.
        kv.put("guard", "divergent/h1", b"1:3")
        sub.poll_once()
        assert sub.n_rollbacks == 0
        assert sub._guard_seen.get("divergent/h1") == b"1:3"


# ---- superseded-blob GC --------------------------------------------------


class TestBlobGC:
    def test_unreachable_buckets_deleted_after_two_manifests(self):
        """Each publish rewrites only changed buckets; copies no longer
        named by the current OR previous manifest are deleted so the
        journaled KV does not grow without bound. The immediately
        previous manifest's keys stay protected for in-flight readers,
        and delta-reused keys (leaf "b" never changes) live forever."""
        kv = MemKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH
        )

        def head_keys():
            m = protocol.unframe_manifest(kv.store["stream"]["head"])
            return {e["key"] for e in m["buckets"]}

        pub.maybe_publish(_params(1), 1)
        keys1 = head_keys()
        pub.maybe_publish(_params(2), 2)
        keys2 = head_keys()
        superseded = keys1 - keys2  # v1's copy of the changed bucket
        reused = keys1 & keys2  # the never-rewritten delta bucket
        assert superseded and reused
        # v1's changed-bucket copy is still protected (previous head).
        assert kv.deletes == []
        pub.maybe_publish(_params(3), 3)
        # Now no manifest reaches it: retired.
        assert kv.deletes == [("stream", k) for k in superseded]
        for k in superseded:
            assert k not in kv.store["stream"]
        # Still-referenced keys survive: the delta-reused bucket and
        # the previous manifest's copy of the changed one.
        assert reused <= set(kv.store["stream"])
        assert keys2 <= set(kv.store["stream"])
        # The stream still serves end to end after the GC pass.
        applied = []
        sub = _mk_sub(kv, _params(0), applied)
        assert sub.poll_once() == 3

    def test_delete_less_kv_grows_but_keeps_serving(self):
        class PutOnlyKV(MemKV):
            delete = None  # a KV with no per-key delete (GC skipped)

        kv = PutOnlyKV()
        pub = WeightPublisher(
            kv, publish_every=1, epoch=0, threshold_bytes=THRESH
        )
        for s in range(1, 4):
            pub.maybe_publish(_params(s), s)
        # Every copy ever written is still there (head + 2 v1 buckets +
        # the changed bucket's v2 and v3 copies): growth, made visible
        # by the stream.kv_retained_keys gauge instead of a GC pass.
        assert len(kv.store["stream"]) == 5
        applied = []
        sub = _mk_sub(kv, _params(0), applied)
        assert sub.poll_once() == 3


# ---- the dp commit-path cadence clock ------------------------------------


class TestDpStreamClock:
    def test_cadence_clock_reanchors_after_rewind(self):
        """An elastic restore or guard walk-back rewinds ``state.step``
        after the host-side cadence clock anchored; the clock must
        re-anchor on its next cadence hit (where the real step is read
        anyway) -- a silently desynced hint would stop streaming for the
        rest of the run."""
        import dataclasses

        from horovod_tpu_torch import optimizer as topt
        from horovod_tpu_torch.parallel import dp

        def loss_fn(params, batch):
            x, y = batch
            return torch.mean((x @ params["w"] - y) ** 2)

        step, opt = dp.make_train_step(loss_fn, topt.adamw(0.01), publish=2,
                                       device="cpu")
        pub = step.stream_publisher
        assert pub is not None
        pub.kv = MemKV()  # no elastic KV in-process: inject one
        state = dp.init_state({"w": torch.ones(4, 2)}, opt)
        batch = (torch.ones(8, 4), torch.zeros(8, 2))
        for _ in range(4):
            state, _ = step(state, batch)
        assert pub.last_version == 4 and pub.n_published == 2  # 2, 4
        # A restore rewinds the committed step to 1 -- a distance that
        # is NOT a multiple of the cadence.
        state = dataclasses.replace(
            state, step=torch.tensor(1, dtype=state.step.dtype))
        for _ in range(5):  # real steps 2..6
            state, _ = step(state, batch)
        assert pub.last_version == 6
        assert int(state.step) == 6


# ---- across the two packages --------------------------------------------


def _gpt2_tiny_tree(bf16: bool):
    """GPT-2 tiny's flax parameter tree as numpy (the JAX package's
    layout), every second 2-D leaf in bf16 when ``bf16``."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from horovod_tpu.models import gpt2 as jgpt2

    cfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, use_flash=False)
    params = jgpt2.GPT2LMModel(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    leaves, treedef = jax.tree.flatten(jax.tree.map(np.asarray, params))
    if bf16:
        leaves = [x.astype(ml_dtypes.bfloat16) if x.ndim == 2 and i % 2
                  else x for i, x in enumerate(leaves)]
    return jax.tree.unflatten(treedef, leaves)


def _to_torch(tree):
    """The same tree as torch tensors, bf16 leaves bit for bit."""
    import jax

    def conv(x):
        if str(x.dtype) == "bfloat16":
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(x))

    return jax.tree.map(conv, tree)


def _bytes(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _np_bytes(x):
    return np.asarray(x).tobytes()


def _bump(tree, path_key):
    """A copy of the numpy tree with the leaves under ``path_key`` + 1."""
    import jax

    def f(path, x):
        if path_key in jax.tree_util.keystr(path):
            return (x.astype(np.float32) + 1).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(f, tree)


class TestAcrossPackages:
    def test_frames_byte_for_byte_the_reference(self):
        from horovod_tpu.stream import protocol as jproto

        meta = {"kind": "bucket", "version": 3, "epoch": 1, "index": 2,
                "dtype": "bfloat16", "size": 5}
        payload = bytes(range(10))
        assert protocol.frame_blob(meta, payload) == jproto.frame_blob(
            meta, payload)
        kw = dict(version=3, epoch=1, step=3,
                  layout={"threshold": None, "n_buckets": 1,
                          "dtypes": ["float32"], "sizes": [4]},
                  buckets=[{"index": 0, "crc": 7, "nbytes": 16,
                            "dtype": "float32", "size": 4, "key": "v3/0"}])
        assert protocol.frame_manifest(**kw) == jproto.frame_manifest(**kw)
        assert protocol.MAGIC == jproto.MAGIC
        assert protocol.bucket_key(3, 2) == jproto.bucket_key(3, 2)

    @pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
    def test_publisher_writes_the_reference_bytes(self, bf16):
        """The same GPT-2 tiny versions through either publisher leave the
        same KV, key for key and byte for byte (delta keys included)."""
        from horovod_tpu.stream import WeightPublisher as JPublisher

        tree = _gpt2_tiny_tree(bf16)
        v2 = _bump(tree, "h_1")
        kvs = []
        for pub_cls, conv in ((WeightPublisher, _to_torch),
                              (JPublisher, lambda t: t)):
            kv = MemKV()
            pub = pub_cls(kv, publish_every=1, epoch=4,
                          threshold_bytes=16 * 1024)
            assert pub.maybe_publish(conv(tree), 1) == 1
            assert pub.maybe_publish(conv(v2), 2) == 2
            kvs.append(kv)
        ours, theirs = kvs
        assert ours.puts == theirs.puts
        assert ours.store == theirs.store
        head = protocol.unframe_manifest(ours.store["stream"]["head"])
        assert len(head["buckets"]) > 2
        assert ("bfloat16" in head["layout"]["dtypes"]) == bf16

    @pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
    def test_each_subscriber_applies_the_other_publishers_versions(
            self, bf16):
        import jax

        from horovod_tpu.stream import StreamSubscriber as JSubscriber
        from horovod_tpu.stream import WeightPublisher as JPublisher

        tree = _gpt2_tiny_tree(bf16)
        v2 = _bump(tree, "wte")
        want = jax.tree.leaves(v2)
        # JAX publisher -> port subscriber.
        kv = MemKV()
        pub = JPublisher(kv, publish_every=1, epoch=0,
                         threshold_bytes=16 * 1024)
        pub.maybe_publish(tree, 1)
        pub.maybe_publish(v2, 2)
        applied = []
        sub = _mk_sub(kv, _to_torch(tree), applied,
                      threshold_bytes=16 * 1024)
        assert sub.poll_once() == 2
        got = jax.tree.leaves(applied[-1][1])
        assert [_bytes(g) for g in got] == [_np_bytes(w) for w in want]
        assert [str(g.dtype).split(".")[1] for g in got] == [
            str(w.dtype) for w in want]
        # Port publisher -> JAX subscriber.
        kv = MemKV()
        pub = WeightPublisher(kv, publish_every=1, epoch=0,
                              threshold_bytes=16 * 1024)
        pub.maybe_publish(_to_torch(tree), 1)
        pub.maybe_publish(_to_torch(v2), 2)
        japplied = []
        jsub = JSubscriber(None, template_params=tree, kv=kv,
                           poll_secs=0.01, staleness_secs=1e9,
                           threshold_bytes=16 * 1024,
                           apply=lambda t, v: japplied.append((v, t)))
        assert jsub.poll_once() == 2
        jgot = jax.tree.leaves(japplied[-1][1])
        assert [_np_bytes(g) for g in jgot] == [_np_bytes(w) for w in want]

    def test_held_capture_keeps_its_own_steps_bytes(self):
        """The optimizer updates the parameters in place; a publish held
        behind the guard gate and flushed two in-place steps later must
        carry the bytes of the step it was captured at."""
        from horovod_tpu_torch import optimizer as topt
        from horovod_tpu_torch.parallel import dp

        class Gate:
            audit_armed = True
            last_verified_step = None
            last_report = None

        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
        y = torch.from_numpy(rng.randn(16, 4).astype(np.float32))

        def loss_fn(p, b):
            return ((b[0] @ p["w"] + p["b"] - b[1]) ** 2).mean()

        step, opt = dp.make_train_step(loss_fn, topt.adamw(1e-1),
                                       publish=1, device="cpu")
        pub = step.stream_publisher
        kv, gate = MemKV(), Gate()
        pub.kv, pub.guard_runtime = kv, gate
        params = {"w": torch.zeros(8, 4), "b": torch.zeros(4)}
        state = dp.init_state(params, opt)
        seen = {}
        for _ in range(3):
            state, _ = step(state, (x, y))
            seen[int(state.step)] = {k: v.detach().clone()
                                     for k, v in state.params.items()}
        assert state.params["w"] is params["w"]  # trained in place
        assert [p[0] for p in pub._pending] == [1, 2, 3]
        assert "stream" not in kv.store
        gate.last_verified_step = 1
        assert pub.flush() == 1
        applied = []
        sub = _mk_sub(kv, seen[1], applied)
        assert sub.poll_once() == 1
        got = applied[-1][1]
        for k in ("w", "b"):
            assert torch.equal(got[k], seen[1][k])
            assert not torch.equal(got[k], state.params[k])

    def test_flat_trainer_dict_packs_in_the_serving_trees_order(self):
        """A trainer's flat dict of dotted names (what make_train_step
        trains) publishes in the nested serving tree's order -- numeric
        layer order, not string order ("layers.10" after "layers.9") --
        byte for byte what the JAX package publishes for that tree, and a
        subscriber holding the nested tree applies it."""
        import jax

        from horovod_tpu.stream import WeightPublisher as JPublisher
        from horovod_tpu_torch.serve import CacheLM, CacheLMConfig

        model = CacheLM(CacheLMConfig(vocab=16, n_layers=12, n_heads=2,
                                      head_dim=4, max_positions=32),
                        block_size=4)
        nested = model.init_params(0, device="cpu")
        flat = {"emb": nested["emb"], "pos": nested["pos"]}
        for i, layer in enumerate(nested["layers"]):
            for k, v in layer.items():
                flat[f"layers.{i}.{k}"] = v.clone() + 1.0
        from horovod_tpu_torch.stream import as_tree

        assert [list(d) for d in as_tree(flat)["layers"]][0] == [
            "wq", "wk", "wv", "wo"]
        kv, jkv = MemKV(), MemKV()
        WeightPublisher(kv, publish_every=1, epoch=0,
                        threshold_bytes=1024).maybe_publish(flat, 1)
        jtree = jax.tree.map(lambda t: t.numpy(), as_tree(flat))
        JPublisher(jkv, publish_every=1, epoch=0,
                   threshold_bytes=1024).maybe_publish(jtree, 1)
        assert kv.store == jkv.store
        applied = []
        sub = _mk_sub(kv, nested, applied, threshold_bytes=1024)
        assert sub.poll_once() == 1
        got = applied[-1][1]
        for i in range(12):
            assert torch.equal(got["layers"][i]["wq"],
                               flat[f"layers.{i}.wq"])
        # A flat template gets a flat dict back.
        applied = []
        sub = _mk_sub(kv, flat, applied, threshold_bytes=1024)
        assert sub.poll_once() == 1
        assert set(applied[-1][1]) == set(flat)
        assert all(torch.equal(applied[-1][1][k], flat[k]) for k in flat)

    def test_int8_subscriber_requantizes_only_changed_buckets(
            self, monkeypatch):
        from horovod_tpu_torch.ops import quantization as tq

        calls = []
        real = tq.quantize_params

        def spy(tree, *a, **k):
            calls.append(1)
            return real(tree, *a, **k)

        monkeypatch.setattr(tq, "quantize_params", spy)
        rng = np.random.RandomState(0)

        def params(step):
            return {
                "a": torch.from_numpy(rng.randn(64, 64).astype(np.float32))
                if step == 0 else torch.full((64, 64), float(step)),
                "b": torch.arange(64 * 64, dtype=torch.float32).reshape(
                    64, 64) / 100.0,
            }

        kv = MemKV()
        pub = WeightPublisher(kv, publish_every=1, epoch=0,
                              threshold_bytes=64 * 64 * 4)
        applied = []
        sub = _mk_sub(kv, params(0), applied, weight_dtype="int8")
        pub.maybe_publish(params(1), 1)
        assert sub.poll_once() == 1
        assert len(calls) == 2  # first version: every bucket
        pub.maybe_publish(params(2), 2)
        assert sub.poll_once() == 2
        assert len(calls) == 3  # only "a" changed
        got = applied[-1][1]
        want = real(params(2))
        for k in ("a", "b"):
            assert torch.equal(got[k].q, want[k].q)
            assert torch.equal(got[k].scales, want[k].scales)


# ---- the engine ----------------------------------------------------------


def test_attach_stream_on_a_tiny_cachelm():
    """A DecodeEngine attached to a live StreamSubscriber: versions flip in
    whole between rounds, every worker's version log is a subsequence of
    the engine's, and the answers after the last flip are a fresh engine's
    on the last published parameters, token for token."""
    from horovod_tpu_torch.ops.batching import tree_map
    from horovod_tpu_torch.serve import CacheLM, CacheLMConfig, DecodeEngine

    model = CacheLM(CacheLMConfig(vocab=32, n_layers=2, n_heads=2,
                                  head_dim=8, max_positions=128),
                    block_size=8)
    base = model.init_params(0, device="cpu")

    def at(step):
        return tree_map(lambda x: x + 0.01 * step, base)

    def engine(params):
        return DecodeEngine(model, params, workers=2, rows=2, kv_blocks=32,
                            kv_block_size=8, max_seq_len=64, device="cpu")

    kv = MemKV()
    pub = WeightPublisher(kv, publish_every=1, epoch=0)
    eng = engine(at(0)).start()
    sub = StreamSubscriber(eng, kv=kv, poll_secs=0.01, staleness_secs=1e9)
    eng.attach_stream(sub)
    sub.start()
    try:
        for v in range(1, 4):
            futs = [eng.submit([1 + i, 2, 3], 8) for i in range(4)]
            pub.maybe_publish(at(v), v)
            for f in futs:
                f.result(timeout=60)
        deadline = time.time() + 30
        while eng.stream_version != 3 and time.time() < deadline:
            time.sleep(0.01)
        assert eng.stream_version == 3
        final = [list(eng.submit([1 + i, 2, 3], 8).result(timeout=60))
                 for i in range(4)]
        log = eng.stream_version_log
        assert log == sorted(set(log)) and log[-1] == 3
        for w in eng._workers.values():
            it = iter(log)
            assert all(v in it for v in w.version_log)
        for k in ("emb", "pos"):
            assert torch.equal(eng.params[k], at(3)[k])
    finally:
        eng.stop()
    assert sub._stop.is_set()  # stopped with the engine
    fresh = engine(at(3)).start()
    try:
        want = [list(fresh.submit([1 + i, 2, 3], 8).result(timeout=60))
                for i in range(4)]
    finally:
        fresh.stop()
    assert final == want


def test_stream_soak_scenario():
    """The soak: a trainer killed mid-publish, a torn publish, a driver
    crash and adoption, a stale-epoch manifest and a starved stream --
    no torn apply, the stale epoch rejected, the checkpoint fallback
    taken, decode finals token for token the fault-free run's."""
    from horovod_tpu_torch.tools import chaos_soak as cs

    res = cs.run_scenario("stream", timeout=120.0)
    assert cs.check_invariants(res) == []
    assert res["n_torn"] >= 1 and res["n_epoch_rejected"] == 1


def test_a_flip_while_idle_reaches_the_next_prefill():
    """Workers parked with nothing to decode still take a version flipped
    meanwhile for the next stream's prefill: its tokens are a fresh
    engine's on the new parameters, from the first one."""
    from horovod_tpu_torch.serve import CacheLM, CacheLMConfig, DecodeEngine

    model = CacheLM(CacheLMConfig(vocab=32, n_layers=2, n_heads=2,
                                  head_dim=8, max_positions=128),
                    block_size=8)

    def engine(params):
        return DecodeEngine(model, params, workers=1, rows=2, kv_blocks=32,
                            kv_block_size=8, max_seq_len=64,
                            device="cpu").start()

    new = model.init_params(7, device="cpu")
    eng = engine(model.init_params(0, device="cpu"))
    try:
        old = [list(eng.submit([1 + i, 2, 3], 8).result(timeout=60))
               for i in range(4)]
        time.sleep(0.1)  # the worker parks on the empty queue
        eng.hot_swap(new, version=1)
        got = [list(eng.submit([1 + i, 2, 3], 8).result(timeout=60))
               for i in range(4)]
    finally:
        eng.stop()
    fresh = engine(new)
    try:
        want = [list(fresh.submit([1 + i, 2, 3], 8).result(timeout=60))
                for i in range(4)]
    finally:
        fresh.stop()
    assert got == want and got != old


def test_state_commit_publishes_through_the_active_publisher():
    """``State.commit`` fires ``stream.on_commit`` after the save: an
    activated publisher captures the committed parameters at the state's
    step; deactivated, a commit publishes nothing."""
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch import stream

    kv = MemKV()
    pub = stream.activate(WeightPublisher(kv, publish_every=1, epoch=0))
    try:
        st = elastic.ObjectState(params=_params(3), step=3)
        st.commit()
        head = protocol.unframe_manifest(kv.store["stream"]["head"])
        assert head["version"] == 3 and pub.n_published == 1
    finally:
        stream.deactivate()
    st.step = 4
    st.commit()
    assert pub.n_published == 1 and not stream.enabled()


def test_autotuned_publisher_layout_reaches_a_default_env_subscriber(
        monkeypatch):
    """An autotuned replicated step that publishes: the tuner rewrites
    ``HVDTPU_FUSION_THRESHOLD`` in the trainer between trials, so the
    publisher's buckets change from trial to trial. A subscriber in
    another process, whose environment holds the default threshold,
    rebuilds the layout from the manifest's and applies every version
    bit for bit (left None, it rebuilt one bucket from its own default
    and rejected each trial's set as torn)."""
    from horovod_tpu_torch import optimizer as topt
    from horovod_tpu_torch import tune
    from horovod_tpu_torch.elastic import worker as _worker
    from horovod_tpu_torch.parallel import dp
    from horovod_tpu_torch.utils import env as _env

    kv = MemKV()
    monkeypatch.setattr(_worker, "_kv_client", lambda: kv)
    # Restored after the test, whatever the tuner wrote meanwhile.
    monkeypatch.setenv(_env.FUSION_THRESHOLD,
                       str(_env.DEFAULT_FUSION_THRESHOLD))
    rng = np.random.RandomState(0)
    # Four 1 MiB leaves: one bucket at the default, several at ~1 MiB.
    params = {f"w{i}": torch.from_numpy(
        (rng.randn(256, 1024) * 0.01).astype(np.float32)) for i in range(4)}
    x = torch.from_numpy(rng.randn(8, 256).astype(np.float32))

    def loss_fn(p, b):
        return sum(torch.mean((b @ p[k]) ** 2) for k in sorted(p))

    step, opt = dp.make_train_step(
        loss_fn, topt.adamw(1e-3), publish=1, device="cpu",
        autotune=tune.AutotuneConfig(window_steps=1, warmup_steps=0,
                                     max_trials=4, patience=4, seed=0))
    state = dp.init_state({k: v.clone() for k, v in params.items()}, opt)
    applied = []
    sub = _mk_sub(kv, params, applied,
                  threshold_bytes=_env.DEFAULT_FUSION_THRESHOLD)
    n_buckets = set()
    for n in range(1, 9):
        state, _ = step(state, x)
        head = protocol.unframe_manifest(kv.store["stream"]["head"])
        assert head["version"] == n
        n_buckets.add(head["layout"]["n_buckets"])
        assert sub.poll_once() == n, sub.last_error
        version, tree = applied[-1]
        assert version == n
        for k in params:
            assert torch.equal(tree[k], state.params[k]), (n, k)
    # The trials did move the layout (else the test proves nothing).
    assert len(n_buckets) > 1 and sub.n_torn == 0
