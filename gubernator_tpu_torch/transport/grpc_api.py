"""gRPC service and client bindings of the V1 and PeersV1 services.

The port's copy of the JAX package's hand-written bindings, for the
methods a node and its peers serve, the quota-lease and federation
methods included.  Method paths match the reference's
generated code (``/pb.gubernator.V1/GetRateLimits`` etc., reference
gubernator_grpc.pb.go / peers_grpc.pb.go), so reference clients and
servers interoperate on the wire.
"""

from __future__ import annotations

import grpc

from gubernator_tpu_torch.pb import gubernator_pb2 as pb
from gubernator_tpu_torch.pb import peers_pb2 as peers_pb

V1_SERVICE = "pb.gubernator.V1"
PEERS_SERVICE = "pb.gubernator.PeersV1"


def _raw_or_message(m) -> bytes:
    """Pass-through serializer: the fast path hands back wire bytes, the
    object path a protobuf message."""
    return m if isinstance(m, bytes) else m.SerializeToString()


def _raw(method) -> grpc.RpcMethodHandler:
    """A unary method that takes and returns raw bytes."""
    return grpc.unary_unary_rpc_method_handler(
        method, request_deserializer=lambda b: b,
        response_serializer=lambda m: m)


def v1_handler(servicer) -> grpc.GenericRpcHandler:
    """Generic handler of the public V1 service.  ``GetRateLimits`` takes
    the raw request bytes (the servicer runs the native codec).  The
    quota-lease methods (docs/leases.md) and the federation envelope
    exchange (docs/federation.md) pass raw frames both ways (the servicer
    runs fastwire's codecs) and are registered only when the servicer
    has them, as in the reference."""
    return grpc.method_handlers_generic_handler(
        V1_SERVICE,
        {
            "GetRateLimits": grpc.unary_unary_rpc_method_handler(
                servicer.GetRateLimits,
                request_deserializer=lambda b: b,
                response_serializer=_raw_or_message,
            ),
            "HealthCheck": grpc.unary_unary_rpc_method_handler(
                servicer.HealthCheck,
                request_deserializer=pb.HealthCheckReq.FromString,
                response_serializer=pb.HealthCheckResp.SerializeToString,
            ),
            **({
                "LeaseGrant": _raw(servicer.LeaseGrant),
                "LeaseSync": _raw(servicer.LeaseSync),
            } if hasattr(servicer, "LeaseGrant") else {}),
            **({
                "FederationSync": _raw(servicer.FederationSync),
            } if hasattr(servicer, "FederationSync") else {}),
        },
    )


def peers_handler(servicer) -> grpc.GenericRpcHandler:
    """Generic handler of the peer-to-peer PeersV1 service."""
    return grpc.method_handlers_generic_handler(
        PEERS_SERVICE,
        {
            "GetPeerRateLimits": grpc.unary_unary_rpc_method_handler(
                servicer.GetPeerRateLimits,
                request_deserializer=lambda b: b,
                response_serializer=_raw_or_message,
            ),
            "UpdatePeerGlobals": grpc.unary_unary_rpc_method_handler(
                servicer.UpdatePeerGlobals,
                request_deserializer=peers_pb.UpdatePeerGlobalsReq.FromString,
                response_serializer=(
                    peers_pb.UpdatePeerGlobalsResp.SerializeToString),
            ),
        },
    )


class V1Stub:
    """Client stub of the public service."""

    def __init__(self, channel):
        self.GetRateLimits = channel.unary_unary(
            f"/{V1_SERVICE}/GetRateLimits",
            request_serializer=pb.GetRateLimitsReq.SerializeToString,
            response_deserializer=pb.GetRateLimitsResp.FromString,
        )
        self.HealthCheck = channel.unary_unary(
            f"/{V1_SERVICE}/HealthCheck",
            request_serializer=pb.HealthCheckReq.SerializeToString,
            response_deserializer=pb.HealthCheckResp.FromString,
        )
        # Raw-bytes lease methods (frame codecs in transport/fastwire.py).
        self.LeaseGrant = channel.unary_unary(
            f"/{V1_SERVICE}/LeaseGrant",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        self.LeaseSync = channel.unary_unary(
            f"/{V1_SERVICE}/LeaseSync",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        self.FederationSync = channel.unary_unary(
            f"/{V1_SERVICE}/FederationSync",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )


class PeersV1Stub:
    """Client stub of the peer service."""

    def __init__(self, channel):
        self.GetPeerRateLimits = channel.unary_unary(
            f"/{PEERS_SERVICE}/GetPeerRateLimits",
            request_serializer=peers_pb.GetPeerRateLimitsReq.SerializeToString,
            response_deserializer=peers_pb.GetPeerRateLimitsResp.FromString,
        )
        self.UpdatePeerGlobals = channel.unary_unary(
            f"/{PEERS_SERVICE}/UpdatePeerGlobals",
            request_serializer=peers_pb.UpdatePeerGlobalsReq.SerializeToString,
            response_deserializer=peers_pb.UpdatePeerGlobalsResp.FromString,
        )
