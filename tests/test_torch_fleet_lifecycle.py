"""Fleet lifecycle parity: WAL, snapshots, restart, compaction, merge.

One reference fleet (``repro.fleet``) and one port fleet
(``repro_torch.fleet``, with a draw hook replaying the reference's
``jax.random`` draws) take the same shards and the same insert batches at
the reference's ``small_cfg()`` size, each with durable storage.  Their
write-ahead logs are byte-identical, each package opens the fleet the other
saved with the same answers, a restart of the port reproduces the
never-stopped fleet bit for bit, and seals, merges and retirements land as
the reference's do.  Gids are exact; squared distances agree within
1e-5·(‖q‖² + ‖x‖²) across packages (ROADMAP queue 3).
"""
import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.fleet import FleetConfig as JFleetConfig  # noqa: E402
from repro.fleet import IndexFleet as JIndexFleet  # noqa: E402
from repro.fleet.lifecycle import wal as j_wal  # noqa: E402
from repro.fleet.lifecycle.merge import MergePolicy as JMergePolicy  # noqa: E402
from repro.utils.config import ClimberConfig as JConfig  # noqa: E402
from repro_torch.core import index as t_index  # noqa: E402
from repro_torch.fleet import (FleetConfig, FleetDraws, FleetEngine,  # noqa: E402
                               IndexFleet, MergePolicy)
from repro_torch.fleet.lifecycle import wal as t_wal  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.utils.config import ClimberConfig  # noqa: E402

K = 10
CFG = dict(series_len=64, paa_segments=8, num_pivots=32, prefix_len=5,
           capacity=128, sample_frac=0.3, max_centroids=12, k=K,
           candidate_groups=4, adaptive_factor=4)
TOL = 1e-5 * 2 * CFG["series_len"]      # ‖q‖² = ‖x‖² = n for z-normalised rows
SEAL_AT = 300


class JaxDraws(FleetDraws):
    """Replays the reference fleet's ``fold_in(PRNGKey(seed), fold)`` draws."""

    def build(self, seed, fold, n_rec, cfg):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
        k_sample, k_pivot, _ = jax.random.split(key, 3)
        s = t_index.sample_size(n_rec, cfg)
        return (np.array(jax.random.choice(k_sample, n_rec, shape=(s,), replace=False)),
                np.array(jax.random.choice(k_pivot, s, shape=(cfg.num_pivots,),
                                           replace=False)))

    def router(self, seed, n_sample, r):
        return np.array(jax.random.choice(jax.random.PRNGKey(seed), n_sample,
                                          shape=(r,), replace=False))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=-1)
    return ((x - x.mean(-1, keepdims=True))
            / (x.std(-1, keepdims=True) + 1e-8)).astype(np.float32)


def assert_answers_match(port_ans, ref_ans):
    (dt, gt, _), (dj, gj, _) = port_ans, ref_ans
    np.testing.assert_array_equal(gt, gj)
    assert np.abs(dt.astype(np.float64) ** 2 - np.asarray(dj, np.float64) ** 2).max() <= TOL


def assert_bit_equal(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """Both packages: 2 shards, 3 inserts of 100 (a seal at 300, in the
    background on the port), a 60-row tail in the delta, saved."""
    root = tmp_path_factory.mktemp("lifecycle")
    data = random_walks(0, 1600, CFG["series_len"])
    batches = [random_walks(10 + i, 100, CFG["series_len"]) for i in range(3)]
    tail = random_walks(20, 60, CFG["series_len"])
    ref = JIndexFleet(JFleetConfig(shard_cfg=JConfig(**CFG), fanout=2,
                                   delta_capacity=SEAL_AT), storage_dir=root / "ref")
    port = IndexFleet(FleetConfig(shard_cfg=ClimberConfig(**CFG), fanout=2,
                                  delta_capacity=SEAL_AT, background_compaction=True),
                      device="cpu", mesh=["cpu"], storage_dir=root / "port",
                      draws=JaxDraws())
    for f in (ref, port):
        f.add_shard("t0", data[:800])
        f.add_shard("t1", data[800:])
        for b in batches:
            f.insert(b)
    ticket = port._seal_ticket
    if ticket is not None:
        ticket.wait()
    for f in (ref, port):
        f.insert(tail)
        f.save()
    rng = np.random.default_rng(3)
    queries = np.concatenate([data[rng.choice(1600, 3, replace=False)], tail[:2]])
    queries = queries + 0.1 * random_walks(4, len(queries), CFG["series_len"])
    ref_ans = ref.query(queries, K, routing="exhaustive", variant="adaptive")
    return dict(root=root, ref=ref, port=port, queries=queries, ref_ans=ref_ans,
                tail=tail)


def test_seal_lands_as_the_reference(fleets):
    ref, port = fleets["ref"], fleets["port"]
    assert [s.key for s in port.shards] == [s.key for s in ref.shards] \
        == ["t0", "t1", "sealed:1"]
    assert port.stats.compactions == ref.stats.compactions == 1
    for js, ts in zip(ref.shards, port.shards):
        np.testing.assert_array_equal(ts.global_ids, js.global_ids)
        for name in js.index.store._fields:
            np.testing.assert_array_equal(getattr(ts.index.store, name).numpy(),
                                          np.asarray(getattr(js.index.store, name)))
    assert port.delta.occupancy == ref.delta.occupancy == 60
    assert port.stats.wal_bytes == ref.stats.wal_bytes
    assert_answers_match(port.query(fleets["queries"], K, routing="exhaustive",
                                    variant="adaptive"), fleets["ref_ans"])


def test_wal_segments_byte_identical(fleets):
    ref_wal = sorted((fleets["root"] / "ref" / "wal").glob("seg_*.wal"))
    port_wal = sorted((fleets["root"] / "port" / "wal").glob("seg_*.wal"))
    assert [p.name for p in port_wal] == [p.name for p in ref_wal]
    for a, b in zip(ref_wal, port_wal):
        assert a.read_bytes() == b.read_bytes()
    # and the pending frames are exactly the tail, as the reference reads them
    frames = j_wal.WriteAheadLog(fleets["root"] / "port" / "wal").replay()
    assert len(frames) == 1
    np.testing.assert_array_equal(frames[0][2], fleets["tail"])


def test_snapshots_match_the_reference_layout(fleets):
    root = fleets["root"]
    ref_m = json.loads((root / "ref" / "FLEET_MANIFEST.json").read_text())
    port_m = json.loads((root / "port" / "FLEET_MANIFEST.json").read_text())
    for m in (ref_m, port_m):
        m["fleet"].pop("background_compaction")     # set on the port only
        for entry in m["shards"]:
            entry.pop("created_at")
    assert port_m == ref_m
    for entry in ref_m["shards"]:
        a = np.load(root / "ref" / "shards" / entry["dir"] / "arrays.npz")
        b = np.load(root / "port" / "shards" / entry["dir"] / "arrays.npz")
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(b[name], a[name].astype(b[name].dtype))
    for name in ("pivots", "summaries"):
        np.testing.assert_array_equal(np.load(root / "port" / "ROUTER.npz")[name],
                                      np.load(root / "ref" / "ROUTER.npz")[name])


def test_each_package_opens_the_others_fleet(fleets, tmp_path):
    import shutil
    for src, name in ((fleets["root"] / "ref", "ref"), (fleets["root"] / "port", "port")):
        shutil.copytree(src, tmp_path / name)
    port_of_ref = IndexFleet.open(tmp_path / "ref", device="cpu", draws=JaxDraws())
    assert_answers_match(port_of_ref.query(fleets["queries"], K, routing="exhaustive",
                                           variant="adaptive"), fleets["ref_ans"])
    ref_of_port = JIndexFleet.open(tmp_path / "port")
    dj, gj, _ = ref_of_port.query(fleets["queries"], K, routing="exhaustive",
                                  variant="adaptive")
    np.testing.assert_array_equal(gj, fleets["ref_ans"][1])
    np.testing.assert_array_equal(dj, fleets["ref_ans"][0])


def test_restart_is_bit_identical(fleets, tmp_path):
    import shutil
    shutil.copytree(fleets["root"] / "port", tmp_path / "port")
    port = fleets["port"]
    reopened = IndexFleet.open(tmp_path / "port", device="cpu", mesh=["cpu"],
                               draws=JaxDraws())
    assert reopened.delta.occupancy == 60 and reopened.delta.rebuilds == 1
    assert reopened.stats.wal_bytes == port.stats.wal_bytes
    q = fleets["queries"]
    for routing, variant, placement in (("signature", "adaptive", "host"),
                                        ("signature", "adaptive", "mesh"),
                                        ("exhaustive", "exhaustive", "mesh")):
        assert_bit_equal(reopened.query(q, K, routing=routing, variant=variant,
                                        placement=placement),
                         port.query(q, K, routing=routing, variant=variant,
                                    placement=placement))
    # a restart after more inserts replays them to the same delta
    more = random_walks(30, 40, CFG["series_len"])
    reopened.insert(more)
    again = IndexFleet.open(tmp_path / "port", device="cpu", draws=JaxDraws())
    assert again.delta.occupancy == 100
    assert_bit_equal(again.query(more[:3], K), reopened.query(more[:3], K))


def _write_frames(root, n, roll_after=None):
    wal = t_wal.WriteAheadLog(root)
    frames = [(np.arange(3 * i, 3 * i + 3, dtype=np.int32),
               random_walks(40 + i, 3, CFG["series_len"])) for i in range(n)]
    for i, (g, b) in enumerate(frames):
        wal.append(g, b)
        if roll_after is not None and i == roll_after:
            wal.roll()
    wal.close()
    return frames


def test_torn_tail_stops_at_the_last_complete_frame(tmp_path):
    frames = _write_frames(tmp_path / "wal", 3)
    seg = sorted((tmp_path / "wal").glob("seg_*.wal"))[-1]
    raw = seg.read_bytes()
    seg.write_bytes(raw[:-17])                      # a crash mid-append
    for mod in (t_wal, j_wal):
        got = mod.WriteAheadLog(tmp_path / "wal").replay()
        assert len(got) == 2
        for (_, g, b), (g0, b0) in zip(got, frames):
            np.testing.assert_array_equal(g, g0)
            np.testing.assert_array_equal(b, b0)


def test_torn_frame_before_the_last_segment_raises(tmp_path):
    _write_frames(tmp_path / "wal", 3, roll_after=1)
    first = sorted((tmp_path / "wal").glob("seg_*.wal"))[0]
    first.write_bytes(first.read_bytes()[:-5])
    with pytest.raises(t_wal.WalCorruptError, match="before the tail"):
        t_wal.WriteAheadLog(tmp_path / "wal").replay()
    with pytest.raises(j_wal.WalCorruptError):
        j_wal.WriteAheadLog(tmp_path / "wal").replay()


def test_fleet_replays_up_to_a_torn_tail(tmp_path):
    fleet = IndexFleet(FleetConfig(shard_cfg=ClimberConfig(**CFG), auto_compact=False),
                       device="cpu", storage_dir=tmp_path / "f", draws=JaxDraws())
    a, b = (random_walks(50 + i, 50, CFG["series_len"]) for i in range(2))
    fleet.insert(a)
    fleet.insert(b)
    seg = sorted((tmp_path / "f" / "wal").glob("seg_*.wal"))[-1]
    seg.write_bytes(seg.read_bytes()[:-100])        # the second append never finished
    reopened = IndexFleet.open(tmp_path / "f", device="cpu", draws=JaxDraws())
    assert reopened.delta.occupancy == 50
    np.testing.assert_array_equal(reopened.delta.data, a)


def test_engine_ticks_compact_in_the_background():
    data = random_walks(60, 800, CFG["series_len"])
    fleet = IndexFleet(FleetConfig(shard_cfg=ClimberConfig(**CFG), delta_capacity=120,
                                   auto_compact=False), device="cpu", draws=JaxDraws())
    fleet.add_shard("t0", data)
    fleet.insert(random_walks(61, 130, CFG["series_len"]))    # over capacity
    # auto_compact on only now, so the engine's tick makes the seal
    fleet.cfg = FleetConfig(shard_cfg=ClimberConfig(**CFG), delta_capacity=120)
    eng = FleetEngine(fleet, batch_size=4, k=K, maintenance_every=1)
    q = data[:4]
    before = fleet.query(q, K, routing="exhaustive", variant="exhaustive")
    d, g, _ = eng.run(q)                 # the direct API runs no maintenance
    assert fleet._seal_ticket is None and fleet.delta.occupancy == 130
    from repro_torch.serve import QueryRequest
    for i in range(4):
        eng.submit_request(QueryRequest(series=q[i], k=K, request_id=i))
    eng.step()                           # a queue tick runs maintenance
    ticket = fleet._seal_ticket
    if ticket is not None:
        ticket.wait()
    assert fleet.stats.compactions == 1 and fleet.delta.occupancy == 0
    assert_bit_equal(fleet.query(q, K, routing="exhaustive", variant="exhaustive"), before)


def test_queries_and_inserts_during_background_compaction():
    """Every answer observed while a seal runs on the worker thread equals
    the answer before it; a batch inserted meanwhile lands in the fresh
    delta and stays visible through the swap."""
    data = random_walks(70, 800, CFG["series_len"])
    fleet = IndexFleet(FleetConfig(shard_cfg=ClimberConfig(**CFG), auto_compact=False),
                       device="cpu", mesh=["cpu"], draws=JaxDraws())
    fleet.add_shard("t0", data)
    fleet.insert(random_walks(71, 100, CFG["series_len"]))
    q = data[:3] + 0.1 * random_walks(72, 3, CFG["series_len"])
    ref = fleet.query(q, K, routing="exhaustive", variant="exhaustive")
    results, errors, stop = [], [], threading.Event()

    def hammer():
        try:
            while not stop.is_set():
                results.append(fleet.query(q, K, routing="exhaustive",
                                           variant="exhaustive", placement="mesh"))
        except BaseException as exc:        # noqa: BLE001 — reported below
            errors.append(exc)

    t = threading.Thread(target=hammer)
    t.start()
    try:
        ticket = fleet.compact_async()
        fresh = random_walks(73, 3, CFG["series_len"])
        gids = fleet.insert(fresh)
        handle = ticket.wait(timeout=300)
    finally:
        stop.set()
        t.join(timeout=300)
    assert not t.is_alive() and not errors and results
    assert handle.key == "sealed:1" and fleet.delta.occupancy == 3
    for snap in results:
        assert_bit_equal(snap, ref)
    _, g, _ = fleet.query(fresh[:1], K, routing="exhaustive", variant="exhaustive")
    assert gids[0] in g[0]


def test_launch_counts_survive_concurrent_threads():
    """The kernel wrappers' launch counters are bumped from the serving
    thread and the compactor thread at once: no increment may be lost."""
    counted = type("Wrapper", (), {"launches": 0})
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_lib.count_launch(counted)
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert counted.launches == 16 * 2000


def test_maintenance_merges_and_retires_as_the_reference(fleets):
    ref, port = fleets["ref"], fleets["port"]
    q = fleets["queries"]
    before = port.query(q, K, routing="exhaustive", variant="exhaustive")
    reports = [f.maintenance(P(small_shard_records=1000, max_merged_records=1200))
               for f, P in ((ref, JMergePolicy), (port, MergePolicy))]
    assert reports[0] == reports[1] == {"retired": [], "merged": ["merged:1"]}
    assert [s.key for s in port.shards] == [s.key for s in ref.shards] \
        == ["t0", "merged:1"]
    for js, ts in zip(ref.shards, port.shards):
        np.testing.assert_array_equal(ts.global_ids, js.global_ids)
        for name in js.index.store._fields:
            np.testing.assert_array_equal(getattr(ts.index.store, name).numpy(),
                                          np.asarray(getattr(js.index.store, name)))
    after = port.query(q, K, routing="exhaustive", variant="exhaustive")
    np.testing.assert_array_equal(np.sort(after[1], 1), np.sort(before[1], 1))
    assert np.abs(after[0] - before[0]).max() <= TOL
    for f in (ref, port):
        f.shards[0].created_at = 1.0
    reports = [f.maintenance(P(retire_after=10.0), now=100.0)
               for f, P in ((ref, JMergePolicy), (port, MergePolicy))]
    assert reports[0] == reports[1] == {"retired": ["t0"], "merged": []}
    assert [s.key for s in port.shards] == [s.key for s in ref.shards] == ["merged:1"]
    assert port.router.keys == ref.router.keys == ["merged:1"]
    assert port.stats.merges == ref.stats.merges == 1
    assert port.stats.retired_shards == ref.stats.retired_shards == 1
