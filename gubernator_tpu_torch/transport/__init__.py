"""The serving edge: wire codec, protobuf conversion, gRPC and HTTP."""
