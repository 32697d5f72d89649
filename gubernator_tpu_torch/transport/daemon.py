"""Daemon: gRPC server + HTTP-JSON gateway + metrics + lifecycle.

The port's copy of the JAX package's ``transport/daemon`` (reference
``daemon.go``): one grpc.aio server exposing ``V1`` (with the raw-frame
quota-lease methods ``LeaseGrant`` / ``LeaseSync`` and the federation
envelope exchange ``FederationSync``) and ``PeersV1``, an aiohttp JSON
gateway with grpc-gateway's snake_case marshaling (``/v1/GetRateLimits``,
``/v1/HealthCheck``, ``/healthz`` (503 when a majority of peers sit
behind open breakers), ``/readyz``, ``/metrics``, and with
GUBER_DEBUG_ENDPOINTS ``/debug/pipeline``, ``/debug/traces``,
``/debug/state``, ``POST /debug/reshard`` and ``/debug/autoscaler``),
TLS and mTLS with AutoTLS and the plaintext status listener
(``daemon.go:305-334``), the five discovery pools
(``daemon.go:208-243``) and ``wait_for_connect`` readiness.  Not
ported: the edge plane and the profile debug route.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import List, Optional, Sequence

import grpc
import grpc.aio
import numpy as np
from aiohttp import web
from google.protobuf import json_format

from gubernator_tpu_torch.admission import (
    DEADLINE_METADATA_KEY,
    deadline_from_header,
)
from gubernator_tpu_torch.config import (
    DISCOVERY_TYPES, DaemonConfig, env_knob)
from gubernator_tpu_torch.ops.reqcols import IngestOverloadError
from gubernator_tpu_torch.parallel.reshard import ReshardError
from gubernator_tpu_torch.pb import gubernator_pb2 as pb
from gubernator_tpu_torch.pb import peers_pb2 as peers_pb
from gubernator_tpu_torch.resilience.supervisor import spawn_supervised
from gubernator_tpu_torch.service.instance import (
    MESH_ALONE,
    BatchTooLargeError,
    InstanceConfig,
    V1Instance,
)
from gubernator_tpu_torch.transport import convert, fastwire
from gubernator_tpu_torch.transport.grpc_api import (
    V1Stub, peers_handler, v1_handler)
from gubernator_tpu_torch.transport.tlsutil import TLSBundle, setup_tls
from gubernator_tpu_torch.types import GlobalUpdate, PeerInfo
from gubernator_tpu_torch.utils import flightrec, tracing
from gubernator_tpu_torch.utils.metrics import Metrics

log = logging.getLogger("gubernator.daemon")

MAX_RECV_BYTES = 1024 * 1024  # 1 MiB, daemon.go:120-126


class _StatsInterceptor(grpc.aio.ServerInterceptor):
    """Per-RPC count / duration metrics (reference grpc_stats.go:41-121)."""

    def __init__(self, metrics: Metrics):
        self.metrics = metrics

    async def intercept_service(self, continuation, handler_call_details):
        handler = await continuation(handler_call_details)
        if handler is None or handler.unary_unary is None:
            return handler
        method = handler_call_details.method
        inner = handler.unary_unary
        metrics = self.metrics

        async def wrapped(request, context):
            t0 = time.perf_counter()
            failed = False
            try:
                return await inner(request, context)
            except Exception:
                failed = True
                raise
            finally:
                dt = time.perf_counter() - t0
                metrics.grpc_request_duration.labels(method=method).observe(dt)
                metrics.grpc_duration_hist.labels(method=method).observe(dt)
                metrics.grpc_request_counts.labels(
                    status="failed" if failed else "success", method=method
                ).inc()

        return grpc.unary_unary_rpc_method_handler(
            wrapped,
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )


class _TraceInterceptor(grpc.aio.ServerInterceptor):
    """A server span per RPC, continuing a caller's W3C ``traceparent``
    from the request metadata (reference daemon.go:125)."""

    async def intercept_service(self, continuation, handler_call_details):
        handler = await continuation(handler_call_details)
        if handler is None or handler.unary_unary is None:
            return handler
        if not tracing.enabled():
            return handler
        method = handler_call_details.method
        parent = tracing.extract(
            {k: v for k, v in (handler_call_details.invocation_metadata or ())
             if isinstance(v, str)})
        inner = handler.unary_unary

        async def wrapped(request, context):
            with tracing.maybe_span(f"grpc.recv{method.replace('/', '.')}",
                                    parent=parent):
                return await inner(request, context)

        return grpc.unary_unary_rpc_method_handler(
            wrapped,
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )


async def _parse_pb(msg_type, raw: bytes, context):
    """Protobuf-parse raw request bytes; malformed input aborts with
    INVALID_ARGUMENT."""
    try:
        return msg_type.FromString(raw)
    except Exception as e:
        await context.abort(
            grpc.StatusCode.INVALID_ARGUMENT,
            f"failed to parse {msg_type.DESCRIPTOR.name}: {e}")


def _item_responses(mat, errs):
    """Per-item pb responses of a columnar batch with per-item errors."""
    status, limit, remaining, reset = (mat[r].tolist() for r in range(4))
    return [
        pb.RateLimitResp(error=errs[i]) if i in errs
        else pb.RateLimitResp(status=status[i], limit=limit[i],
                              remaining=remaining[i], reset_time=reset[i])
        for i in range(len(status))
    ]


def _edge_deadline(context, default_timeout: float):
    """The absolute admission deadline of one inbound RPC: a
    ``guber-deadline-ms`` budget header, else the caller's gRPC deadline,
    else the GUBER_REQUEST_TIMEOUT default (None only when it is 0)."""
    now = time.monotonic()
    value = None
    try:
        for k, v in context.invocation_metadata() or ():
            if k == DEADLINE_METADATA_KEY:
                value = v
                break
    except Exception:
        pass
    d = deadline_from_header(value, now)
    if d is not None:
        return d
    try:
        rem = context.time_remaining()
    except Exception:
        rem = None
    if rem is not None:
        return now + rem
    if default_timeout > 0:
        return now + default_timeout
    return None


def _sync_arena_metrics(arena, metrics) -> None:
    """Mirror the arena's fallback counter into gubernator_tpu_arena_fallbacks."""
    if arena is None or metrics is None:
        return
    synced = getattr(arena, "_synced_fallbacks", 0)
    if arena.metric_fallbacks > synced:
        metrics.arena_fallbacks.inc(arena.metric_fallbacks - synced)
        arena._synced_fallbacks = arena.metric_fallbacks


async def _raw_columns_edge(raw, context, gate_ok, tick, msg_type,
                            arena=None, deadline=None, metrics=None):
    """The raw-bytes fast path of both rate-limit edges: native wire parse
    -> columns -> device tick -> native wire encode, with no protobuf
    objects.  Returns ``(result, msg)``: ``result`` is the response bytes,
    a per-item response list (a batch with per-item engine errors), or
    None when the batch takes the object path; ``msg`` is the protobuf
    message if one was parsed on the way.  An arena-decoded batch that
    leaves for the object path, or is rejected before the tick loop saw
    it, releases its slab here; the tick loop releases the others."""
    msg = None
    if gate_ok:
        fr = flightrec.get()
        t0 = time.perf_counter() if fr is not None else 0.0
        try:
            parsed = fastwire.parse_req(raw, arena)
        except IngestOverloadError as e:
            if metrics is not None:
                metrics.admission_shed.labels(reason="backpressure").inc()
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        _sync_arena_metrics(arena, metrics)
        if fr is not None:
            fr.edge("decode", time.perf_counter() - t0)
        if parsed is None:  # malformed bytes: protobuf names the fault
            msg = await _parse_pb(msg_type, raw, context)
            parsed = convert.columns_from_pb(msg.requests)
        cols, errors, special = parsed
        if not special and not errors:
            try:
                mat, errs = await tick(cols, deadline=deadline)
            except BatchTooLargeError as e:
                cols.release()
                await context.abort(grpc.StatusCode.OUT_OF_RANGE, str(e))
            if not errs:
                t1 = time.perf_counter() if fr is not None else 0.0
                out = fastwire.encode_resp(mat)
                if fr is not None:
                    fr.edge("encode", time.perf_counter() - t1)
                return out, msg
            return _item_responses(mat, errs), msg
        cols.release()
    return None, msg


class V1Servicer:
    """pb <-> dataclass edge of the public service.  ``GetRateLimits``
    receives the raw request bytes: the fast path never builds protobuf
    messages; GLOBAL items, metadata and per-item errors take the object
    path, parsed with protobuf."""

    def __init__(self, instance: V1Instance):
        self.instance = instance

    async def GetRateLimits(self, raw: bytes, context):
        deadline = _edge_deadline(
            context, self.instance.tick_loop.admission.request_timeout)
        fast, msg = await _raw_columns_edge(
            raw, context,
            self.instance.columns_fast_path_ok(),
            self.instance.get_rate_limits_columns,
            pb.GetRateLimitsReq,
            arena=self.instance.ingest_arena,
            deadline=deadline,
            metrics=self.instance.metrics,
        )
        if fast is not None:
            if isinstance(fast, bytes):
                return fast
            return pb.GetRateLimitsResp(responses=fast)
        if msg is None:
            msg = await _parse_pb(pb.GetRateLimitsReq, raw, context)
        reqs = convert.reqs_from_pb(msg.requests)
        for r in reqs:
            r.deadline = deadline
        try:
            out = await self.instance.get_rate_limits(reqs)
        except BatchTooLargeError as e:
            await context.abort(grpc.StatusCode.OUT_OF_RANGE, str(e))
        return pb.GetRateLimitsResp(responses=convert.resps_to_pb(out))

    async def HealthCheck(self, request, context):
        h = self.instance.health_check()
        return pb.HealthCheckResp(
            status=h.status, message=h.message, peer_count=h.peer_count)

    async def LeaseGrant(self, raw: bytes, context):
        """Quota-lease grant edge (docs/leases.md): raw frame in, raw
        frame out; lease traffic never touches protobuf."""
        specs = fastwire.parse_lease_grant_req(raw)
        if specs is None:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "malformed LeaseGrant frame")
        tokens = await self.instance.lease_grant(specs)
        return fastwire.encode_lease_grant_resp(tokens)

    async def LeaseSync(self, raw: bytes, context):
        """Quota-lease reconcile edge: consumed counts in, acks out."""
        syncs = fastwire.parse_lease_sync_req(raw)
        if syncs is None:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "malformed LeaseSync frame")
        acks = await self.instance.lease_sync(syncs)
        return fastwire.encode_lease_sync_resp(acks)

    async def FederationSync(self, raw: bytes, context):
        """Inter-region envelope edge (docs/federation.md): GFE1 frame
        in, GFA1 ack out.  A node without federation rejects the RPC; the
        sender's breaker treats it like any dead peer."""
        env = fastwire.parse_federation_envelope(raw)
        if env is None:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "malformed FederationSync frame")
        if self.instance.federation is None:
            await context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "federation is not enabled on this node")
        ack = await self.instance.federation.receive(env)
        return fastwire.encode_federation_ack(ack)


class PeersServicer:
    """pb <-> dataclass edge of the peer service (GetPeerRateLimitsReq
    has GetRateLimitsReq's wire shape, so the native codec parses it)."""

    def __init__(self, instance: V1Instance):
        self.instance = instance

    async def GetPeerRateLimits(self, raw: bytes, context):
        deadline = _edge_deadline(
            context, self.instance.tick_loop.admission.request_timeout)
        fast, msg = await _raw_columns_edge(
            raw, context,
            self.instance.peer_columns_fast_path_ok(),
            self.instance.get_peer_rate_limits_columns,
            peers_pb.GetPeerRateLimitsReq,
            arena=self.instance.ingest_arena,
            deadline=deadline,
            metrics=self.instance.metrics,
        )
        if fast is not None:
            if isinstance(fast, bytes):
                return fast  # GetRateLimitsResp's wire shape
            return peers_pb.GetPeerRateLimitsResp(rate_limits=fast)
        if msg is None:
            msg = await _parse_pb(peers_pb.GetPeerRateLimitsReq, raw, context)
        reqs = convert.reqs_from_pb(msg.requests)
        for r in reqs:
            r.deadline = deadline
        try:
            out = await self.instance.get_peer_rate_limits(reqs)
        except BatchTooLargeError as e:
            await context.abort(grpc.StatusCode.OUT_OF_RANGE, str(e))
        return peers_pb.GetPeerRateLimitsResp(
            rate_limits=convert.resps_to_pb(out))

    async def UpdatePeerGlobals(self, request, context):
        updates = [
            GlobalUpdate(
                key=g.key,
                status=convert.resp_from_pb(g.status),
                algorithm=int(g.algorithm),
                duration=g.duration,
                created_at=g.created_at,
            )
            for g in request.globals
        ]
        await self.instance.update_peer_globals(updates)
        return peers_pb.UpdatePeerGlobalsResp()


def _json(msg) -> dict:
    return json_format.MessageToDict(
        msg, preserving_proto_field_name=True,
        always_print_fields_with_no_presence=True)


class Daemon:
    """One running node: instance + listeners + discovery."""

    def __init__(self, conf: DaemonConfig, engine=None, global_mesh=None,
                 global_mesh_node: int = 0):
        if conf.peer_discovery_type not in DISCOVERY_TYPES:
            raise ValueError(
                f"unknown peer discovery type {conf.peer_discovery_type!r}; "
                f"choose one of {DISCOVERY_TYPES}")
        self.conf = conf
        self.metrics = Metrics()
        self.instance: Optional[V1Instance] = None
        self._engine = engine
        # A shared MeshGlobalEngine (parallel/global_mesh.py) and this
        # node's index on it: GLOBAL items ride the mesh, not the loops.
        self._global_mesh = global_mesh
        self._global_mesh_node = global_mesh_node
        self._grpc_server: Optional[grpc.aio.Server] = None
        self._http_runner: Optional[web.AppRunner] = None
        self._status_runner: Optional[web.AppRunner] = None
        self._pool = None
        self.tls: Optional[TLSBundle] = None
        self.peer_info: List[PeerInfo] = []
        # /readyz is 503 until the startup restore completed and again
        # from the moment the drain begins; /healthz stays liveness.
        self._ready = False
        self._draining = False
        # GUBER_DEBUG_ENDPOINTS installs the flight recorder and an
        # in-memory trace exporter for /debug/*; the slow-window watchdog
        # installs the recorder alone.
        self._debug_enabled = bool(
            env_knob("GUBER_DEBUG_ENDPOINTS", 0, parse=int))
        self._slow_window_ms = env_knob(
            "GUBER_SLOW_WINDOW_MS", 0.0, parse=float)
        self._flight_recorder: Optional[flightrec.FlightRecorder] = None
        self._debug_exporter: Optional[tracing.InMemoryExporter] = None
        self._watchdog_task: Optional[asyncio.Task] = None

    @property
    def advertise_address(self) -> str:
        return self.conf.advertise_address or self.conf.grpc_listen_address

    async def start(self) -> None:
        """Bring up the gRPC listener, the gateway and the instance
        (daemon.go:83-366); a failure closes what came up."""
        try:
            await self._start()
        except BaseException:
            await self.close()
            raise

    async def _start(self) -> None:
        self.tls = setup_tls(self.conf.tls)
        options = [("grpc.max_receive_message_length", MAX_RECV_BYTES)]
        if self.conf.grpc_max_conn_age_sec > 0:
            age_ms = self.conf.grpc_max_conn_age_sec * 1000
            options.append(("grpc.max_connection_age_ms", age_ms))
            options.append(("grpc.max_connection_age_grace_ms", age_ms))
        server = grpc.aio.server(
            interceptors=[_StatsInterceptor(self.metrics),
                          _TraceInterceptor()],
            options=options)
        if self.tls is not None:
            port = server.add_secure_port(
                self.conf.grpc_listen_address, self.tls.server_credentials())
        else:
            port = server.add_insecure_port(self.conf.grpc_listen_address)
        if port == 0:
            raise RuntimeError(
                f"failed to bind gRPC listener {self.conf.grpc_listen_address}")
        # A :0 bind becomes the allocated port so clients can dial it.
        host = self.conf.grpc_listen_address.rsplit(":", 1)[0]
        self.conf.grpc_listen_address = f"{host}:{port}"

        if self._debug_enabled or self._slow_window_ms > 0:
            windows = env_knob(
                "GUBER_FLIGHT_RECORDER_WINDOWS", 256, parse=int)
            rec = flightrec.FlightRecorder(
                windows=max(2, windows),
                slow_threshold_s=self._slow_window_ms / 1e3)
            rec.observer = self._observe_stage
            flightrec.install(rec)
            self._flight_recorder = rec
            self._watchdog_task = spawn_supervised(
                self._watchdog_loop,
                name="flight_watchdog",
                should_restart=lambda: not self._draining,
                metrics=self.metrics,
                loop_label="flight_watchdog",
            )
        if self._debug_enabled:
            self._debug_exporter = tracing.InMemoryExporter()
            tracing.add_exporter(self._debug_exporter)

        # The gateway comes up before the instance: a restore can take
        # seconds, and /readyz must answer 503 meanwhile.
        await self._start_gateway()
        iconf = InstanceConfig.from_config(
            self.conf.config, advertise_address=self.advertise_address,
            metrics=self.metrics,
            peer_credentials=(
                self.tls.channel_credentials() if self.tls else None))
        iconf.data_center = (self.conf.data_center
                             or self.conf.config.data_center)
        if self._global_mesh is not None:
            iconf.global_mesh = self._global_mesh
            iconf.global_mesh_node = self._global_mesh_node
        self.instance = await V1Instance.create(iconf, engine=self._engine)
        if self.instance.owns_global_mesh \
                and self.conf.peer_discovery_type != "none":
            raise ValueError(MESH_ALONE)
        server.add_generic_rpc_handlers((
            v1_handler(V1Servicer(self.instance)),
            peers_handler(PeersServicer(self.instance)),
        ))
        await server.start()
        self._grpc_server = server
        self._ready = True
        await self._start_discovery()
        log.info("gubernator-tpu-torch daemon up: grpc=%s http=%s",
                 self.conf.grpc_listen_address, self.conf.http_listen_address)

    # ------------------------------------------------------------------
    # HTTP gateway (grpc-gateway JSON + /metrics, daemon.go:245-292)
    # ------------------------------------------------------------------
    def _add_debug_routes(self, app: web.Application) -> None:
        app.router.add_get("/debug/pipeline", self._h_debug_pipeline)
        app.router.add_get("/debug/traces", self._h_debug_traces)
        app.router.add_get("/debug/state", self._h_debug_state)
        app.router.add_post("/debug/reshard", self._h_debug_reshard)
        app.router.add_get("/debug/autoscaler", self._h_debug_autoscaler)

    async def _start_gateway(self) -> None:
        if not self.conf.http_listen_address:
            return
        app = web.Application(client_max_size=MAX_RECV_BYTES)
        app.router.add_post("/v1/GetRateLimits", self._h_get_rate_limits)
        app.router.add_get("/v1/HealthCheck", self._h_health_check)
        app.router.add_get("/healthz", self._h_health_check)
        app.router.add_get("/readyz", self._h_readyz)
        app.router.add_get("/metrics", self._h_metrics)
        if self._debug_enabled:
            self._add_debug_routes(app)
        runner = web.AppRunner(app, access_log=None)
        await runner.setup()
        self._http_runner = runner
        host, _, port = self.conf.http_listen_address.rpartition(":")
        ssl_ctx = self.tls.server_ssl_context() if self.tls else None
        site = web.TCPSite(runner, host or "localhost", int(port),
                           ssl_context=ssl_ctx)
        await site.start()
        socks = site._server.sockets if site._server is not None else []
        if int(port) == 0 and socks:
            self.conf.http_listen_address = (
                f"{host or 'localhost'}:{socks[0].getsockname()[1]}")
        # A plaintext status listener for health probes behind mTLS
        # (daemon.go:305-334).
        if self.conf.http_status_listen_address:
            sapp = web.Application()
            sapp.router.add_get("/v1/HealthCheck", self._h_health_check)
            sapp.router.add_get("/healthz", self._h_health_check)
            sapp.router.add_get("/readyz", self._h_readyz)
            sapp.router.add_get("/metrics", self._h_metrics)
            if self._debug_enabled:
                self._add_debug_routes(sapp)
            srunner = web.AppRunner(sapp, access_log=None)
            await srunner.setup()
            self._status_runner = srunner
            shost, _, sport = (
                self.conf.http_status_listen_address.rpartition(":"))
            await web.TCPSite(srunner, shost or "localhost",
                              int(sport)).start()

    async def _h_get_rate_limits(self, request: web.Request) -> web.Response:
        """The JSON gateway, snake_case field names (daemon.go:251-261)."""
        if self.instance is None:
            return web.json_response(
                {"error": "starting up", "code": 14}, status=503)
        try:
            msg = json_format.Parse(await request.read(), pb.GetRateLimitsReq())
        except json_format.ParseError as e:
            return web.json_response({"error": str(e), "code": 3}, status=400)
        try:
            parent = tracing.extract(
                {k.lower(): v for k, v in request.headers.items()})
            with tracing.maybe_span("http.recv./v1/GetRateLimits",
                                    parent=parent):
                out = await self.instance.get_rate_limits(
                    convert.reqs_from_pb(msg.requests))
        except BatchTooLargeError as e:
            return web.json_response({"error": str(e), "code": 11}, status=400)
        return web.json_response(
            _json(pb.GetRateLimitsResp(responses=convert.resps_to_pb(out))))

    async def _h_readyz(self, request: web.Request) -> web.Response:
        ok = self._ready and not self._draining
        body = {"ready": ok, "draining": self._draining}
        if self.instance is not None and self.instance.restore_stats:
            body["restore"] = self.instance.restore_stats
        return web.json_response(body, status=200 if ok else 503)

    async def _h_health_check(self, request: web.Request) -> web.Response:
        if self.instance is None:
            return web.json_response(
                {"status": "unhealthy", "message": "starting up",
                 "peer_count": 0}, status=503)
        h = self.instance.health_check()
        body = _json(pb.HealthCheckResp(
            status=h.status, message=h.message, peer_count=h.peer_count))
        body["occupancy"] = self.instance.occupancy()
        return web.json_response(
            body, status=200 if h.status == "healthy" else 503)

    async def _h_metrics(self, request: web.Request) -> web.Response:
        if self.instance is not None:
            eng = self.instance.engine
            self.metrics.cache_size.set(eng.cache_size())
            if hasattr(eng, "hot_occupancy"):
                self.metrics.hot_occupancy.set(eng.hot_occupancy())
            if hasattr(eng, "cold_size"):
                self.metrics.cold_size.set(eng.cold_size())
        return web.Response(body=self.metrics.expose(),
                            content_type="text/plain")

    # ------------------------------------------------------------------
    # /debug introspection (docs/observability.md)
    # ------------------------------------------------------------------
    def _observe_stage(self, stage: str, seconds: float) -> None:
        self.metrics.stage_duration.labels(stage=stage).observe(seconds)

    async def _watchdog_loop(self) -> None:
        """Drain the slow-window records the recorder parked."""
        while not self._draining:
            rec = self._flight_recorder
            if rec is not None:
                for dump in rec.drain_slow():
                    self.metrics.slow_windows.inc()
                    log.warning(
                        "slow window %d: total=%.1fms width=%d depth=%d "
                        "stages_ms=%s", dump["window"], dump["total_ms"],
                        dump["width"], dump["queue_depth"],
                        {s: v for s, v in dump["stages_ms"].items() if v})
            await asyncio.sleep(0.25)

    async def _h_debug_pipeline(self, request: web.Request) -> web.Response:
        rec = self._flight_recorder
        try:
            limit = int(request.query.get("limit", "64"))
        except ValueError:
            return web.json_response({"error": "bad limit"}, status=400)
        return web.json_response({
            "windows": rec.recent(max(1, limit)),
            "stage_percentiles": rec.stage_percentiles(),
            "slow_windows": rec.slow_total,
        })

    async def _h_debug_traces(self, request: web.Request) -> web.Response:
        exp = self._debug_exporter
        trace_id = request.query.get("trace_id")
        name = request.query.get("name")
        try:
            limit = int(request.query.get("limit", "128"))
        except ValueError:
            return web.json_response({"error": "bad limit"}, status=400)
        if trace_id:
            spans = exp.by_trace(trace_id)
        elif name:
            spans = exp.by_name(name)
        else:
            with exp._lock:
                spans = list(exp.spans)
        spans = spans[-max(1, limit):]
        return web.json_response({
            "tracing_enabled": tracing.enabled(),
            "count": len(spans),
            "spans": [{
                "name": s.name, "trace_id": s.trace_id,
                "span_id": s.span_id, "parent_span_id": s.parent_span_id,
                "start_ns": s.start_ns,
                "duration_ms": round(s.duration_ms, 4),
                "attributes": {
                    k: v if isinstance(v, (str, int, float, bool, type(None)))
                    else repr(v) for k, v in s.attributes.items()},
                "error": s.error,
            } for s in spans],
        })

    async def _h_debug_state(self, request: web.Request) -> web.Response:
        if self.instance is None:
            return web.json_response({"error": "starting up"}, status=503)
        inst = self.instance
        eng = inst.engine
        body: dict = {
            "ready": self._ready,
            "draining": self._draining,
            "occupancy": inst.occupancy(),
            "restore": inst.restore_stats,
        }
        arena = inst.ingest_arena
        if arena is not None:
            body["ingest_arena"] = {
                "slabs": arena.n_slabs, "in_use": arena.in_use(),
                "leases": arena.metric_leases, "misses": arena.metric_misses}
        if hasattr(eng, "h2d_overlap_ratio"):
            body["engine"] = {
                "h2d_windows": eng.metric_h2d_windows,
                "h2d_overlap_ratio": round(eng.h2d_overlap_ratio(), 4)}
        writer = inst._snapshot_writer
        if writer is not None:
            body["snapshot"] = {
                "generation": writer.store.generation,
                "delta_writes": writer.metric_delta_writes,
                "base_writes": writer.metric_base_writes,
                "write_failures": writer.metric_write_failures,
            }
        body["reshard"] = inst.reshard_status()
        if inst.autoscaler is not None:
            scaler_state = inst.autoscaler.debug_state()
            scaler_state.pop("decisions", None)  # the ring lives at
            body["autoscaler"] = scaler_state    # /debug/autoscaler
        return web.json_response(body)

    async def _h_debug_autoscaler(self, request: web.Request) -> web.Response:
        """The autoscaler's config, streaks and bounded decision ring
        (docs/autoscaling.md): a dry-run rollout reads this until the
        decisions look right; 404 when the autoscaler is off."""
        if self.instance is None:
            return web.json_response({"error": "starting up"}, status=503)
        scaler = self.instance.autoscaler
        if scaler is None:
            return web.json_response(
                {"error": "autoscaler disabled (GUBER_AUTOSCALE_ENABLED)"},
                status=404)
        return web.json_response(scaler.debug_state())

    async def _h_debug_reshard(self, request: web.Request) -> web.Response:
        """Admin trigger: POST {"shards": m} runs one n -> m transition and
        answers its outcome dict; 409 while a transition runs (the
        coordinator's busy dict), 400 on a bad body or target.  The debug
        plane is operator-only (GUBER_DEBUG_ENDPOINTS)."""
        if self.instance is None:
            return web.json_response({"error": "starting up"}, status=503)
        try:
            doc = await request.json()
            shards = int(doc["shards"])
        except (ValueError, KeyError, TypeError):
            return web.json_response(
                {"error": "body must be JSON {\"shards\": <int>}"},
                status=400)
        try:
            result = await self.instance.reshard(shards)
        except ReshardError as e:
            return web.json_response({"error": str(e)}, status=400)
        if result.get("result") == "busy":
            return web.json_response(result, status=409)
        return web.json_response(result)

    # ------------------------------------------------------------------
    # Discovery (daemon.go:208-243)
    # ------------------------------------------------------------------
    async def _start_discovery(self) -> None:
        kind = self.conf.peer_discovery_type
        info = self._self_info()
        if kind == "none":
            self.set_peers([info])
            return
        from gubernator_tpu_torch import discovery

        if kind == "dns":
            self._pool = discovery.DNSPool(
                fqdn=self.conf.dns_fqdn,
                grpc_port=int(
                    self.conf.grpc_listen_address.rsplit(":", 1)[1]),
                http_port=(
                    int(self.conf.http_listen_address.rsplit(":", 1)[1])
                    if self.conf.http_listen_address else 0),
                on_update=self.set_peers,
            )
        elif kind == "etcd":
            self._pool = discovery.EtcdPool(
                endpoints=self.conf.etcd_endpoints,
                key_prefix=self.conf.etcd_key_prefix,
                info=info,
                on_update=self.set_peers,
            )
        elif kind == "k8s":
            self._pool = discovery.K8sPool(
                namespace=self.conf.k8s_namespace,
                selector=self.conf.k8s_endpoints_selector,
                pod_ip=self.conf.k8s_pod_ip,
                pod_port=self.conf.k8s_pod_port,
                mechanism=self.conf.k8s_watch_mechanism,
                on_update=self.set_peers,
            )
        else:  # member-list
            self._pool = discovery.MemberlistPool(
                bind_address=self.conf.memberlist_address,
                known_nodes=self.conf.memberlist_known_nodes,
                info=info,
                on_update=self.set_peers,
            )
        await self._pool.start()

    def _self_info(self) -> PeerInfo:
        return PeerInfo(
            grpc_address=self.advertise_address,
            http_address=self.conf.http_listen_address,
            datacenter=self.conf.data_center,
        )

    def set_peers(self, peers: Sequence[PeerInfo]) -> None:
        """Install cluster membership; the instance marks this node's own
        entry (daemon.go:399-409)."""
        self.peer_info = list(peers)
        self.instance.set_peers(self.peer_info)

    def client(self) -> "DaemonClient":
        """A client dialing this daemon (reference Daemon.Client)."""
        creds = self.tls.channel_credentials() if self.tls else None
        return DaemonClient(self.conf.grpc_listen_address, credentials=creds)

    async def wait_for_connect(self, timeout: float = 30.0) -> None:
        """Readiness: block until the gRPC listener answers HealthCheck."""
        client = self.client()
        deadline = time.monotonic() + timeout
        try:
            while True:
                try:
                    await client.health_check()
                    return
                except Exception:
                    if time.monotonic() > deadline:
                        raise
                    await asyncio.sleep(0.05)
        finally:
            await client.close()

    async def close(self) -> None:
        """Graceful shutdown (daemon.go:369-396): readiness to 503 first,
        then discovery off, then the instance (ownership transfers, the
        GLOBAL drain, the final snapshot), then the listeners."""
        self._draining = True
        if self._watchdog_task is not None:
            self._watchdog_task.cancel()
            try:
                await self._watchdog_task
            except (asyncio.CancelledError, Exception):
                pass
            self._watchdog_task = None
        if self._debug_exporter is not None:
            tracing.remove_exporter(self._debug_exporter)
            self._debug_exporter = None
        if (self._flight_recorder is not None
                and flightrec.get() is self._flight_recorder):
            flightrec.uninstall()
        self._flight_recorder = None
        if self._pool is not None:
            await self._pool.close()
            self._pool = None
        if self.instance is not None:
            await self.instance.close()
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=1.0)
        if self._http_runner is not None:
            await self._http_runner.cleanup()
            self._http_runner = None
        if self._status_runner is not None:
            await self._status_runner.cleanup()
            self._status_runner = None


class DaemonClient:
    """Thin async client of the public V1 API (reference client.go)."""

    def __init__(self, address: str, credentials=None):
        if credentials is not None:
            self.channel = grpc.aio.secure_channel(address, credentials)
        else:
            self.channel = grpc.aio.insecure_channel(address)
        self.stub = V1Stub(self.channel)
        # Raw-bytes method of the columnar path: the native codec writes
        # and reads the wire bytes; gRPC ships them.
        self._raw_get_rate_limits = self.channel.unary_unary(
            "/pb.gubernator.V1/GetRateLimits",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )

    @staticmethod
    def _metadata(budget_ms):
        hdrs: dict = {}
        tracing.inject(hdrs)
        if budget_ms is not None:
            hdrs[DEADLINE_METADATA_KEY] = str(max(0, int(budget_ms)))
        return tuple(hdrs.items()) or None

    async def get_rate_limits(self, reqs, timeout: float = 30.0,
                              budget_ms: int = None):
        """``budget_ms`` rides the ``guber-deadline-ms`` metadata key so
        the server sheds work this caller no longer waits for."""
        msg = pb.GetRateLimitsReq(requests=[convert.req_to_pb(r) for r in reqs])
        out = await self.stub.GetRateLimits(
            msg, timeout=timeout, metadata=self._metadata(budget_ms))
        return [convert.resp_from_pb(r) for r in out.responses]

    async def get_rate_limits_raw(self, raw: bytes, timeout: float = 30.0,
                                  budget_ms: int = None) -> bytes:
        """Serialized GetRateLimitsReq bytes in, GetRateLimitsResp bytes out."""
        return await self._raw_get_rate_limits(
            raw, timeout=timeout, metadata=self._metadata(budget_ms))

    async def get_rate_limits_columns(self, cols, timeout: float = 30.0,
                                      budget_ms: int = None):
        """A :class:`ReqColumns` batch (with ``name_len``) -> native wire
        encode -> raw gRPC -> native wire decode -> ((4, n) status / limit
        / remaining / reset_time, {index: error string})."""
        out = await self.get_rate_limits_raw(
            fastwire.encode_req(cols), timeout, budget_ms)
        mat, special = fastwire.parse_resp(out)
        errors = {}
        if special.any():
            msg = pb.GetRateLimitsResp.FromString(out)
            for i in np.flatnonzero(special):
                if msg.responses[i].error:
                    errors[int(i)] = msg.responses[i].error
        return mat, errors

    async def health_check(self, timeout: float = 30.0):
        return await self.stub.HealthCheck(pb.HealthCheckReq(), timeout=timeout)

    async def lease_grant(self, specs, timeout: float = 5.0):
        """Request quota leases (docs/leases.md): [LeaseSpec] ->
        [Optional[LeaseToken]] (None: the server declined; fall back to
        per-request decisions)."""
        out = await self.stub.LeaseGrant(
            fastwire.encode_lease_grant_req(specs), timeout=timeout,
            metadata=self._metadata(None))
        tokens = fastwire.parse_lease_grant_resp(out)
        if tokens is None:
            raise RuntimeError("malformed LeaseGrant response frame")
        return tokens

    async def lease_sync(self, syncs, timeout: float = 5.0):
        """Report lease consumption: [LeaseSync] -> [LeaseSyncAck]."""
        out = await self.stub.LeaseSync(
            fastwire.encode_lease_sync_req(syncs), timeout=timeout,
            metadata=self._metadata(None))
        acks = fastwire.parse_lease_sync_resp(out)
        if acks is None:
            raise RuntimeError("malformed LeaseSync response frame")
        return acks

    async def close(self) -> None:
        await self.channel.close()


async def spawn_daemon(conf: DaemonConfig, engine=None) -> Daemon:
    """Start a daemon and wait for readiness (reference SpawnDaemon,
    daemon.go:73-81)."""
    d = Daemon(conf, engine=engine)
    await d.start()
    try:
        await d.wait_for_connect()
    except BaseException:
        await d.close()
        raise
    return d
