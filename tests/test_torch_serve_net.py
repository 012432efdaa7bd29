"""Network plane parity: ``repro_torch.serve.net`` and the engine's
admission hooks against ``repro.serve.net``.

* Frames: every ``MsgType`` encodes to the same bytes in both packages (the
  zip entries' timestamps pinned), and each package decodes the other's.
* Typed refusals: bad magic, bad CRC, version mismatch, truncation,
  oversize, bad payload; over a live port server, BAD_REQUEST, BAD_FRAME,
  VERSION_MISMATCH, QUOTA_EXCEEDED, RETRY_LATER and SHUTTING_DOWN.
* Engine hooks: ``make_ticket``'s trace handoff and tenant counts,
  ``execute_prepared`` on another thread under the admitting trace,
  ``fail_tickets``, and the legacy ``submit`` (warns once, writes back).
* Sockets: the port's client against a port server, the reference's
  client against a port server, and the port's client against a reference
  server each return the serving fleet's own ``IndexFleet.query`` answers
  bit for bit; across packages gids are equal and d² agrees within the
  fleet tests' ``TOL``.

Socket tests assert no latency, bound every wait (client timeouts,
``join(timeout=...)``) and retry on typed ``RETRY_LATER``.
"""
import socket
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.fleet import FleetConfig as JFleetConfig  # noqa: E402
from repro.fleet import FleetEngine as JFleetEngine  # noqa: E402
from repro.fleet import IndexFleet as JIndexFleet  # noqa: E402
from repro.serve import api as j_api  # noqa: E402
from repro.serve import net as j_net  # noqa: E402
from repro.utils.config import ClimberConfig as JConfig  # noqa: E402
from repro_torch.fleet import FleetConfig, FleetEngine, IndexFleet  # noqa: E402
from repro_torch.obs import REGISTRY, TRACER, TraceContext  # noqa: E402
from repro_torch.serve import api  # noqa: E402
from repro_torch.serve import knn_engine as knn_engine_mod  # noqa: E402
from repro_torch.serve.net import (AsyncClimberClient, ClimberClient,  # noqa: E402
                                   ClimberServer, FrameError, MsgType,
                                   RetryLater, ServerError, decode_message,
                                   decode_payload, encode_frame,
                                   encode_message, serve_in_thread)
from repro_torch.serve.net import codec, schema  # noqa: E402
from repro_torch.utils.config import ClimberConfig  # noqa: E402
from test_torch_fleet import CFG, K, TOL, JaxDraws, random_walks  # noqa: E402

WAIT = 60          # seconds: the bound on every join and client read


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    data = random_walks(0, 1200, CFG["series_len"])
    rng = np.random.default_rng(4)
    queries = data[rng.choice(len(data), 8, replace=False)]
    queries += 0.2 * rng.standard_normal(queries.shape).astype(np.float32)
    return data, queries


def port_fleet(data):
    fleet = IndexFleet(FleetConfig(shard_cfg=ClimberConfig(**CFG), fanout=2,
                                   delta_capacity=4096, auto_compact=False),
                       device="cpu", draws=JaxDraws())
    for i in range(2):
        fleet.add_shard(f"tenant{i}", data[i * 600:(i + 1) * 600])
    return fleet


@pytest.fixture(scope="module")
def fleet(corpus):
    return port_fleet(corpus[0])


def engine_for(fleet, **kw):
    cfg = dict(batch_size=4, k=K, variant="adaptive", routing="signature")
    cfg.update(kw)
    return FleetEngine(fleet, config=api.ServingConfig(**cfg))


def query_retrying(client, series, k=K, **kw):
    """One query, retried on typed backpressure (bounded)."""
    deadline = time.monotonic() + WAIT
    while True:
        try:
            return client.query(series, k, **kw)
        except RetryLater as exc:
            if time.monotonic() > deadline:
                raise
            time.sleep(max(exc.retry_after_ms, 1.0) / 1e3)


# ---------------------------------------------------------------------------
# frames: byte-equal, decodable across packages, typed failures
# ---------------------------------------------------------------------------
def messages(a):
    """One message of every type, built from package ``a``'s api."""
    rng = np.random.default_rng(3)
    return {
        MsgType.HELLO: {"client": "climber-client"},
        MsgType.SERVER_INFO: a.ServerInfo(
            series_len=64, k_max=10, batch_size=8, engine="fleet",
            variant="adaptive", routing="signature", shards=3,
            max_pending=64, tenant_quota=4),
        MsgType.QUERY: a.QueryRequest(
            series=rng.standard_normal(64).astype(np.float32), k=5,
            tenant="αβγ-tenant", request_id=2 ** 40 + 7,
            trace_id=2 ** 62 + 5, parent_span_id=9),
        MsgType.RESULT: a.QueryResult(
            request_id=7, dist=rng.random(10).astype(np.float32),
            gid=rng.integers(0, 1000, 10).astype(np.int32),
            partitions_touched=3, candidates_scanned=128, latency_ms=1.25,
            batch_fill=0.5, trace_id=11, parent_span_id=12),
        MsgType.ERROR: a.ErrorReply(request_id=3, code="RETRY_LATER",
                                    message="admission buffers full",
                                    retry_after_ms=2.5),
        MsgType.BYE: {},
        MsgType.METRICS: {"page": "# TYPE repro_x gauge\nrepro_x 1\n"},
        MsgType.HEALTH: {key: i for i, key in enumerate(schema._HEALTH_FIELDS)},
        MsgType.TRACES: {"limit": 3, "count": 1,
                         "traces_jsonl": '{"reason": "error:INTERNAL"}\n'},
    }


@pytest.fixture
def frozen_clock(monkeypatch):
    """``np.savez`` stamps each zip entry with the wall clock: pin it."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


@pytest.mark.parametrize("mtype", list(MsgType), ids=lambda m: m.name)
def test_frames_byte_equal_and_cross_decode(mtype, frozen_clock):
    t_msg, j_msg = messages(api)[mtype], messages(j_api)[mtype]
    frame = encode_message(mtype, t_msg)
    assert frame == j_net.encode_message(j_net.MsgType(int(mtype)), j_msg)
    body = frame[codec.HEADER_LEN:]
    got_type, got = decode_message(int(mtype), body)
    j_type, j_got = j_net.decode_message(int(mtype), body)
    assert got_type == mtype and int(j_type) == int(mtype)
    if isinstance(t_msg, dict):
        assert got == j_got
        if mtype not in (MsgType.HELLO, MsgType.BYE):
            assert got == t_msg
    else:
        for field in t_msg.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(t_msg, field))
            np.testing.assert_array_equal(getattr(j_got, field),
                                          getattr(t_msg, field))


def test_payload_helpers_equal(frozen_clock):
    fields = {"a": np.arange(5, dtype=np.int32), "s": np.asarray("x"),
              "f": np.asarray(2.5)}
    blob = codec.encode_payload(fields)
    assert blob == j_net.encode_payload(fields)
    out = decode_payload(blob)
    assert set(out) == set(fields) and out["a"].dtype == np.int32
    assert encode_frame(3, blob) == j_net.encode_frame(3, blob)


def frame_error(fn):
    with pytest.raises(FrameError) as ei:
        fn()
    return ei.value


def test_codec_refusals_are_typed():
    bye = bytearray(encode_message(MsgType.BYE, {}))
    bye[0] ^= 0xFF
    assert frame_error(lambda: codec.decode_header(bytes(bye))).code == "BAD_MAGIC"
    assert frame_error(lambda: codec.decode_header(b"\x00" * 4)).code == "TRUNCATED"
    newer = encode_frame(int(MsgType.BYE), b"", version=api.WIRE_VERSION + 1)
    err = frame_error(lambda: codec.decode_header(newer))
    assert err.code == "VERSION_MISMATCH" and err.peer_version == api.WIRE_VERSION + 1
    big = codec.HEADER.pack(codec.MAGIC, api.WIRE_VERSION, 1, 0,
                            codec.MAX_PAYLOAD + 1, 0)
    assert frame_error(lambda: codec.decode_header(big)).code == "TOO_LARGE"
    assert frame_error(lambda: decode_message(int(MsgType.QUERY),
                                              b"not an npz")).code == "BAD_PAYLOAD"
    assert frame_error(lambda: decode_message(
        int(MsgType.QUERY), codec.encode_payload({"k": np.asarray(3)}))).code \
        == "BAD_PAYLOAD"
    assert frame_error(lambda: decode_message(99, b"")).code == "BAD_PAYLOAD"
    with pytest.raises(TypeError):
        codec.encode_payload({"evil": object()})


@pytest.mark.parametrize("offset", [0, 17, 101])
def test_flipped_payload_bit_fails_crc(offset):
    frame = bytearray(encode_message(MsgType.QUERY, api.QueryRequest(
        series=np.zeros(32, np.float32))))
    frame[codec.HEADER_LEN + offset % (len(frame) - codec.HEADER_LEN)] ^= 0x01
    a, b = socket.socketpair()
    try:
        a.sendall(bytes(frame))
        assert frame_error(lambda: codec.read_frame_sync(b)).code == "BAD_CRC"
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# the engine's admission hooks
# ---------------------------------------------------------------------------
def test_make_ticket_trace_handoff_and_tenants(fleet, corpus):
    _, queries = corpus
    engine = engine_for(fleet)
    wire = engine.make_ticket(api.QueryRequest(
        series=queries[0], k=K, tenant="a", trace_id=77, parent_span_id=5))
    assert wire.trace == TraceContext(77, 5)
    with TRACER.span("caller") as sp:
        local = engine.make_ticket(api.QueryRequest(series=queries[1], tenant="a"))
    assert local.trace == TraceContext(sp.trace_id, sp.span_id)
    assert engine.make_ticket(api.QueryRequest(series=queries[2])).trace is None
    assert engine.tenant_inflight("a") == 2 and engine.tenant_inflight("") == 1
    with pytest.raises(ValueError):
        engine.make_ticket(api.QueryRequest(series=np.zeros(3, np.float32)))
    with pytest.raises(ValueError):
        engine.make_ticket(api.QueryRequest(series=queries[0], k=K + 1))
    tickets = [wire, local]
    engine.fail_tickets(tickets, api.ErrorReply(request_id=0, code="INTERNAL",
                                                message="boom"))
    assert engine.tenant_inflight("a") == 0
    assert all(t.done and not t.ok and t.result.code == "INTERNAL" for t in tickets)


def test_execute_prepared_on_another_thread(fleet, corpus):
    _, queries = corpus
    engine = engine_for(fleet)
    tickets = [engine.make_ticket(api.QueryRequest(
        series=q, k=K, request_id=i, tenant="t", trace_id=4242, parent_span_id=7))
        for i, q in enumerate(queries[:3])]
    qbatch = engine.prepare_batch(tickets)
    assert qbatch.shape == (4, CFG["series_len"]) and not qbatch[3].any()
    box = {}
    worker = threading.Thread(target=lambda: box.setdefault(
        "n", engine.execute_prepared(qbatch, tickets)))
    worker.start()
    worker.join(timeout=WAIT)
    assert not worker.is_alive() and box["n"] == 3
    tick = next(s for s in reversed(TRACER.spans()) if s.name == "serve.tick")
    assert tick.trace_id == 4242 and tick.parent_id == 7 and tick.attrs["traces"] == 1
    dist, gid, _ = fleet.query(queries[:3], K, routing="signature")
    for i, t in enumerate(tickets):
        assert t.ok and t.result.trace_id == 4242
        assert t.result.parent_span_id == tick.span_id
        np.testing.assert_array_equal(t.result.gid, gid[i])
        np.testing.assert_array_equal(t.result.dist, dist[i])
    assert engine.tenant_inflight("t") == 0


def test_legacy_submit_warns_once_and_writes_back(fleet, corpus, monkeypatch):
    _, queries = corpus
    engine = engine_for(fleet, batch_size=2)
    monkeypatch.setattr(knn_engine_mod, "_LEGACY_SUBMIT_WARNED", False)
    legacy = knn_engine_mod.QueryRequest
    first = legacy(rid=0, series=queries[0], k=K)
    with pytest.warns(DeprecationWarning):
        engine.submit(first)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        second = legacy(rid=1, series=queries[1], k=K)
        ticket = engine.submit(second)
    assert not [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert engine.step() == 2 and not engine.queue
    dist, gid, _ = fleet.query(queries[:2], K, routing="signature")
    for i, req in enumerate((first, second)):
        assert req.done and req.metrics.partitions_touched > 0
        np.testing.assert_array_equal(req.gid, gid[i])
        np.testing.assert_array_equal(req.dist, dist[i])
    assert ticket.ok and engine.tenant_inflight("") == 0


# ---------------------------------------------------------------------------
# a live port server
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def net(fleet):
    engine = engine_for(fleet, sentinel_rate=1.0)
    server, stop = serve_in_thread(engine)
    yield engine, server
    stop()
    fleet.sentinel = None


def test_handshake_and_bit_identity(net, fleet, corpus):
    _, queries = corpus
    engine, server = net
    with ClimberClient("127.0.0.1", server.port, timeout=WAIT) as c:
        assert (c.info.series_len, c.info.k_max, c.info.engine,
                c.info.shards, c.info.wire_version) == \
            (CFG["series_len"], K, "fleet", 2, api.WIRE_VERSION)
        got = c.query_batch(list(queries), k=K)
        one = query_retrying(c, queries[0], k=3)
    dist, gid, _ = fleet.query(queries, K, routing="signature", variant="adaptive")
    np.testing.assert_array_equal(np.stack([r.gid for r in got]), gid)
    np.testing.assert_array_equal(np.stack([r.dist for r in got]), dist)
    assert one.gid.shape == (3,) and (one.gid == gid[0, :3]).all()
    assert all(r.candidates_scanned > 0 and 0 < r.batch_fill <= 1 for r in got)


def test_bad_requests_and_frames_are_typed(net, corpus):
    _, queries = corpus
    _, server = net
    with ClimberClient("127.0.0.1", server.port, timeout=WAIT) as c:
        for series, k in ((np.zeros(13, np.float32), K), (queries[0], K + 1)):
            with pytest.raises(ServerError) as ei:
                c.query(series, k)
            assert ei.value.code == "BAD_REQUEST" and not isinstance(ei.value, RetryLater)
        assert query_retrying(c, queries[0]).gid.shape == (K,)   # still open
    for frame, code in (
            (encode_frame(int(MsgType.HELLO), codec.encode_payload(
                {"wire_version": np.asarray(99)}), version=api.WIRE_VERSION + 1),
             "VERSION_MISMATCH"),
            (None, "BAD_FRAME")):
        sock = socket.create_connection(("127.0.0.1", server.port), timeout=WAIT)
        try:
            if frame is None:             # handshake, then a flipped payload bit
                sock.sendall(encode_message(MsgType.HELLO, {"client": "t"}))
                codec.read_frame_sync(sock)
                bad = bytearray(encode_message(MsgType.QUERY,
                                               api.QueryRequest(series=queries[0])))
                bad[-1] ^= 0x01
                frame = bytes(bad)
            sock.sendall(frame)
            mtype, reply = decode_message(*codec.read_frame_sync(sock))
            assert mtype == MsgType.ERROR and reply.code == code
        finally:
            sock.close()


def test_admin_plane(net, corpus):
    _, queries = corpus
    engine, server = net
    with ClimberClient("127.0.0.1", server.port, timeout=WAIT) as c:
        c.query_batch(list(queries[:4]), k=K)
        engine.sentinel.drain()
        page = c.metrics()
        for series in ("repro_net_queries_total", "repro_net_connections_total",
                       "repro_net_frames_in_total", "repro_net_rtt_ms",
                       "repro_fleet_online_recall", "repro_serve_latency_ms"):
            assert series in page
        health = c.health()
        assert (health["ready"], health["draining"], health["shards"],
                health["compaction_in_flight"]) == (1, 0, 2, 0)
        with pytest.raises(ServerError):
            c.query(np.zeros(13, np.float32), k=K)
        traces = c.traces()
        bad = [t for t in traces if t["reason"] == "error:BAD_REQUEST"]
        assert bad and any(s["name"] == "net.admit" for s in bad[-1]["spans"])
        assert len(c.traces(limit=1)) == 1


def test_one_trace_across_the_socket(net, corpus):
    _, queries = corpus
    _, server = net
    with ClimberClient("127.0.0.1", server.port, timeout=WAIT) as c:
        res = query_retrying(c, queries[2])
    rtt = next(s for s in reversed(TRACER.spans()) if s.name == "net.rtt")
    assert res.trace_id == rtt.trace_id
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        names = {s.name for s in TRACER.trace(rtt.trace_id)}
        if {"net.admit", "serve.tick", "fleet.query"} <= names:
            break
        time.sleep(0.01)
    assert {"net.rtt", "net.admit", "serve.tick", "fleet.query"} <= names


def test_async_client(net, fleet, corpus):
    import asyncio
    _, queries = corpus
    _, server = net

    async def run():
        client = await AsyncClimberClient.connect("127.0.0.1", server.port)
        try:
            return await asyncio.wait_for(asyncio.gather(
                *(client.query(q, K) for q in queries[:4])), WAIT)
        finally:
            await client.close()

    got = asyncio.run(run())
    _, gid, _ = fleet.query(queries[:4], K, routing="signature")
    np.testing.assert_array_equal(np.stack([r.gid for r in got]), gid)


def _slowed(engine, seconds):
    """Every tick holds the executor for ``seconds`` first."""
    inner = engine._execute

    def slow(qbatch, nlive):
        time.sleep(seconds)
        return inner(qbatch, nlive)

    engine._execute = slow
    return engine


def test_backpressure_and_quota_refuse_typed(fleet, corpus):
    _, queries = corpus
    series = [queries[i % len(queries)] for i in range(6)]
    for cfg, tenant, code in ((dict(batch_size=2, admission_depth=1, max_pending=2),
                               "", "RETRY_LATER"),
                              (dict(batch_size=4, tenant_quota=1), "hog",
                               "QUOTA_EXCEEDED")):
        engine = _slowed(engine_for(fleet, **cfg), 0.25)
        server, stop = serve_in_thread(engine)
        try:
            with ClimberClient("127.0.0.1", server.port, tenant=tenant,
                               timeout=WAIT) as c:
                with pytest.raises(RetryLater) as ei:
                    c.query_batch(series, k=K)
            assert ei.value.code == code and ei.value.retry_after_ms >= 1.0
        finally:
            stop()
        assert engine.tenant_inflight(tenant) == 0


def test_hot_tenant_share_halves_quota(fleet):
    engine = engine_for(fleet, tenant_quota=4, hot_tenant_share=0.5)
    server = ClimberServer(engine)
    engine.tenant_load = lambda tenant: 0.9
    assert server._effective_quota("hog") == 2
    engine.tenant_load = lambda tenant: 0.1
    assert server._effective_quota("cold") == 4


def test_overlap_drain_and_refusal_after_shutdown(fleet, corpus):
    """Three clients stream queries (retrying typed backpressure) into 50 ms
    ticks, so admissions land while a tick runs; stop() then answers every
    admitted request before closing, and refuses what comes after."""
    _, queries = corpus
    engine = _slowed(engine_for(fleet, batch_size=2, admission_depth=2), 0.05)
    server, stop = serve_in_thread(engine)
    results, box = [], {}

    def worker(w):
        with ClimberClient("127.0.0.1", server.port, timeout=WAIT) as c:
            for i in range(4):
                results.append(query_retrying(c, queries[(w + i) % len(queries)]))

    def pipelined():
        with ClimberClient("127.0.0.1", server.port, timeout=WAIT) as c:
            box["batch"] = c.query_batch(list(queries[:2]), k=K)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == 12 and all(isinstance(r, api.QueryResult)
                                          for r in results)
        assert server.overlap_admissions > 0
        # the batch goes out as two frames: stop only once the server has
        # admitted both (``_pending`` can fall back to 0 between them)
        admitted = server._n_queries.value + 2
        tail = threading.Thread(target=pipelined)
        tail.start()
        deadline = time.monotonic() + WAIT
        while server._n_queries.value < admitted and tail.is_alive() \
                and time.monotonic() < deadline:
            time.sleep(0.002)
    finally:
        stop()
    tail.join(timeout=WAIT)
    assert not tail.is_alive() and len(box["batch"]) == 2
    assert not server._exec_thread.is_alive() and server._pending == 0

    class FakeConn:
        posted = []

        def post(self, mtype, msg):
            FakeConn.posted.append((mtype, msg))

    server._admit(api.QueryRequest(series=queries[0], k=K), FakeConn())
    (mtype, reply), = FakeConn.posted
    assert mtype == MsgType.ERROR and reply.code == "SHUTTING_DOWN"


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_net(corpus):
    data, _ = corpus
    ref = JIndexFleet(JFleetConfig(shard_cfg=JConfig(**CFG), fanout=2,
                                   delta_capacity=4096, auto_compact=False))
    for i in range(2):
        ref.add_shard(f"tenant{i}", data[i * 600:(i + 1) * 600])
    engine = JFleetEngine(ref, config=j_api.ServingConfig(
        batch_size=4, k=K, variant="adaptive", routing="exhaustive",
        placement="host", flush_interval_ms=200.0))
    server, stop = j_net.serve_in_thread(engine)
    yield ref, server
    stop()


def test_port_client_against_reference_server(ref_net, fleet, corpus):
    ref, server = ref_net
    _, queries = corpus
    with ClimberClient("127.0.0.1", server.port, timeout=WAIT) as c:
        assert c.info.engine == "fleet" and c.info.routing == "exhaustive"
        got = [c.query_batch(list(queries[a:a + 4]), k=K) for a in (0, 4)]
    got = [r for batch in got for r in batch]
    want = [ref.query(queries[a:a + 4], K, routing="exhaustive", placement="host")
            for a in (0, 4)]
    dist, gid = (np.concatenate([w[i] for w in want]) for i in (0, 1))
    np.testing.assert_array_equal(np.stack([r.gid for r in got]), gid)
    np.testing.assert_array_equal(np.stack([r.dist for r in got]), dist)
    d_port, g_port, _ = fleet.query(queries, K, routing="exhaustive")
    np.testing.assert_array_equal(g_port, gid)
    np.testing.assert_allclose(d_port.astype(np.float64) ** 2,
                               dist.astype(np.float64) ** 2, atol=TOL)


def test_reference_client_against_port_server(fleet, corpus):
    _, queries = corpus
    engine = engine_for(fleet, routing="exhaustive")
    server, stop = serve_in_thread(engine)
    try:
        with j_net.ClimberClient("127.0.0.1", server.port, timeout=WAIT) as c:
            assert c.info.engine == "fleet" and c.info.shards == 2
            got = c.query_batch(list(queries), k=K)
            assert "repro_net_queries_total" in c.metrics()
    finally:
        stop()
    dist, gid, _ = fleet.query(queries, K, routing="exhaustive")
    np.testing.assert_array_equal(np.stack([r.gid for r in got]), gid)
    np.testing.assert_array_equal(np.stack([r.dist for r in got]), dist)
    assert all(isinstance(r, j_api.QueryResult) for r in got)
    assert REGISTRY.counter("net.queries").value >= len(queries)
