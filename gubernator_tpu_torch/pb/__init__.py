"""Generated protobuf modules of gubernator.proto and peers.proto (package
``pb.gubernator``), identical copies of the JAX package's, so both packages
load in one process and yield the same message classes."""

from . import gubernator_pb2, peers_pb2  # noqa: F401
