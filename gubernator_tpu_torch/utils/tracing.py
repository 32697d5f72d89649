"""Distributed tracing: spans, W3C TraceContext propagation, profiler hooks.

The reference instruments every layer with OpenTelemetry (holster
``tracing.StartNamedScope`` wrappers — gubernator.go:315,396,589,
peer_client.go:351-362 — plus the otelgrpc server/client stats handlers,
daemon.go:109-125) and piggybacks W3C TraceContext across peers inside
``RateLimitReq.Metadata`` via ``MetadataCarrier``
(metadata_carrier.go:19-38, peer_client.go:140-141,359-360, extracted
owner-side at gubernator.go:502-504).

The port's copy of the JAX package's lightweight tracer: spans are
plain objects threaded through ``contextvars`` (correct across asyncio
tasks), exporters are pluggable, and the wire format is the standard W3C
``traceparent`` header so traces interoperate with any OTEL-instrumented
peer.  The OpenTelemetry bridge exporter is not ported.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional


TRACEPARENT = "traceparent"
# W3C trace-context: version 00 is exactly 4 fields; a higher version may
# append fields after the flags, and receivers must parse the first four
# and ignore the rest (the spec's forward-compatibility rule).
_TP_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})($|-)"
)

FLAG_SAMPLED = 0x01


@dataclass(frozen=True)
class SpanContext:
    """Identity of one span: what crosses process boundaries."""

    trace_id: str  # 32 lowercase hex chars, non-zero
    span_id: str   # 16 lowercase hex chars, non-zero
    flags: int = FLAG_SAMPLED

    @property
    def sampled(self) -> bool:
        return bool(self.flags & FLAG_SAMPLED)

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags:02x}"


@dataclass
class Span:
    """One timed operation; finished spans go to the tracer's exporters."""

    name: str
    context: SpanContext
    parent_span_id: Optional[str] = None
    start_ns: int = 0
    end_ns: int = 0
    attributes: Dict[str, object] = field(default_factory=dict)
    events: List[tuple] = field(default_factory=list)
    error: Optional[str] = None

    @property
    def trace_id(self) -> str:
        return self.context.trace_id

    @property
    def span_id(self) -> str:
        return self.context.span_id

    @property
    def duration_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def set_attribute(self, key: str, value: object) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, attributes: Optional[Dict] = None) -> None:
        """Annotate a point in time (the reference's span.AddEvent calls on
        algorithm branches, algorithms.go:57-66,163-174)."""
        self.events.append((time.time_ns(), name, attributes or {}))

    def record_exception(self, exc: BaseException) -> None:
        self.error = f"{type(exc).__name__}: {exc}"


def _rand_hex(n_bytes: int) -> str:
    # random.getrandbits is ~20× cheaper than os.urandom per span and trace
    # ids need uniqueness, not cryptographic strength.
    return format(random.getrandbits(n_bytes * 8), f"0{n_bytes * 2}x")


class SpanExporter:
    """Exporter interface: receives each finished span."""

    def export(self, span: Span) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class InMemoryExporter(SpanExporter):
    """Ring buffer of finished spans (tests + /debug introspection)."""

    def __init__(self, cap: int = 4096):
        self.spans: deque = deque(maxlen=cap)
        self._lock = threading.Lock()

    def export(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def by_trace(self, trace_id: str) -> List[Span]:
        with self._lock:
            return [s for s in self.spans if s.trace_id == trace_id]

    def by_name(self, name: str) -> List[Span]:
        with self._lock:
            return [s for s in self.spans if s.name == name]

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()


class Tracer:
    """Span factory + context manager + sampler.

    Sampling follows the OTEL env convention (``OTEL_TRACES_SAMPLER``:
    always_on / always_off / traceidratio with ``OTEL_TRACES_SAMPLER_ARG``),
    the same surface the reference's tracing.InitTracing reads.  Unsampled
    flows still *propagate* context (flags=00) but record nothing.
    """

    def __init__(self, ratio: Optional[float] = None):
        if ratio is None:
            sampler = os.environ.get("OTEL_TRACES_SAMPLER", "always_on")
            if sampler == "always_off":
                ratio = 0.0
            elif sampler == "traceidratio":
                try:
                    ratio = float(os.environ.get("OTEL_TRACES_SAMPLER_ARG", "1"))
                except ValueError:
                    ratio = 1.0
            else:
                ratio = 1.0
        self.ratio = ratio
        self.exporters: List[SpanExporter] = []
        self._current: contextvars.ContextVar[Optional[Span]] = (
            contextvars.ContextVar("guber_span", default=None)
        )

    # -- context ------------------------------------------------------
    def current_span(self) -> Optional[Span]:
        return self._current.get()

    def current_context(self) -> Optional[SpanContext]:
        s = self._current.get()
        return s.context if s is not None else None

    # -- span lifecycle ----------------------------------------------
    def _sample(self) -> bool:
        if self.ratio >= 1.0:
            return True
        if self.ratio <= 0.0:
            return False
        return random.random() < self.ratio

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        attributes: Optional[Dict[str, object]] = None,
        parent: Optional[SpanContext] = None,
        root: bool = False,
    ) -> Iterator[Span]:
        """Start a span as the current one; ends (and exports) on exit.

        ``parent`` overrides the ambient parent — pass the context extracted
        from an incoming request's metadata to continue a remote trace.
        ``root=True`` ignores the ambient parent and starts a fresh trace —
        for long-lived background tasks (batch loops, sync windows) that
        inherited an arbitrary caller's contextvars at task creation.
        """
        if parent is None and not root:
            parent = self.current_context()
        if parent is not None:
            trace_id = parent.trace_id
            flags = parent.flags
            parent_id: Optional[str] = parent.span_id
        else:
            trace_id = _rand_hex(16)
            flags = FLAG_SAMPLED if self._sample() else 0
            parent_id = None
        span = Span(
            name=name,
            context=SpanContext(trace_id, _rand_hex(8), flags),
            parent_span_id=parent_id,
            start_ns=time.time_ns(),
            attributes=dict(attributes or {}),
        )
        token = self._current.set(span)
        try:
            yield span
        except BaseException as exc:
            span.record_exception(exc)
            raise
        finally:
            self._current.reset(token)
            span.end_ns = time.time_ns()
            if span.context.sampled:
                for e in self.exporters:
                    e.export(span)

    def start_detached(
        self,
        name: str,
        attributes: Optional[Dict[str, object]] = None,
        parent: Optional[SpanContext] = None,
    ) -> Span:
        """Start a span WITHOUT making it current — for batch fan-in points
        where many remote parents land in one handler call.  Finish with
        :meth:`finish`."""
        if parent is None:
            parent = self.current_context()
        if parent is not None:
            ctx = SpanContext(parent.trace_id, _rand_hex(8), parent.flags)
            parent_id: Optional[str] = parent.span_id
        else:
            flags = FLAG_SAMPLED if self._sample() else 0
            ctx = SpanContext(_rand_hex(16), _rand_hex(8), flags)
            parent_id = None
        return Span(
            name=name,
            context=ctx,
            parent_span_id=parent_id,
            start_ns=time.time_ns(),
            attributes=dict(attributes or {}),
        )

    def finish(self, span: Span) -> None:
        span.end_ns = time.time_ns()
        if span.context.sampled:
            for e in self.exporters:
                e.export(span)

    # -- propagation (W3C TraceContext over RateLimitReq.metadata) ----
    def inject(self, metadata: Dict[str, str]) -> None:
        """Write the current context as a ``traceparent`` entry
        (peer_client.go:140-141: carried per request so peers continue the
        trace)."""
        ctx = self.current_context()
        if ctx is not None:
            metadata[TRACEPARENT] = ctx.to_traceparent()

    @staticmethod
    def extract(metadata: Optional[Dict[str, str]]) -> Optional[SpanContext]:
        """Parse a ``traceparent`` entry; None on absence or malformation
        (malformed context starts a fresh trace, per the W3C spec)."""
        if not metadata:
            return None
        m = _TP_RE.match(metadata.get(TRACEPARENT, ""))
        if not m:
            return None
        version, trace_id, span_id, flags, tail = m.groups()
        if version == "ff" or int(trace_id, 16) == 0 or int(span_id, 16) == 0:
            return None
        if version == "00" and tail:
            return None  # version 00 allows no trailing fields
        return SpanContext(trace_id, span_id, int(flags, 16))


# ---------------------------------------------------------------------
# Process-global tracer (the reference uses the otel global provider).
# ---------------------------------------------------------------------
_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def span(name, attributes=None, parent=None, root=False):
    return _tracer.span(name, attributes, parent, root)


def current_span() -> Optional[Span]:
    return _tracer.current_span()


def inject(metadata: Dict[str, str]) -> None:
    _tracer.inject(metadata)


def extract(metadata: Optional[Dict[str, str]]) -> Optional[SpanContext]:
    return Tracer.extract(metadata)


def add_exporter(exporter: SpanExporter) -> None:
    _tracer.exporters.append(exporter)


def remove_exporter(exporter: SpanExporter) -> None:
    if exporter in _tracer.exporters:
        _tracer.exporters.remove(exporter)


def enabled() -> bool:
    """Whether any exporter is installed.  Service hot paths gate their
    instrumentation on this so an untraced daemon pays nothing per request
    (the reference's no-op global otel provider has the same effect)."""
    return bool(_tracer.exporters)


def maybe_span(name, attributes=None, parent=None, root=False):
    """``span(...)`` when tracing is enabled, else a free null context."""
    if not _tracer.exporters:
        return contextlib.nullcontext()
    return _tracer.span(name, attributes, parent, root)

