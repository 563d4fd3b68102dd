"""gRPC health checking service (grpc.health.v1.Health): a copy of the JAX
package's ``serving/health.py``.

The reference service enables the default gRPC health service (its
main.cpp:123). ``grpcio-health-checking`` is not a dependency, so the tiny
protocol is implemented directly: the ``grpc.health.v1.Health/Check``
messages are each a single optional string/enum field, hand-encoded in the
protobuf wire format.
"""

from __future__ import annotations

import struct

import grpc

SERVING = 1
NOT_SERVING = 2


def _encode_check_response(status: int) -> bytes:
    # field 1 (status), varint wire type 0
    return bytes([0x08, status])


def _decode_check_request(data: bytes) -> str:
    # field 1 (service), length-delimited
    if len(data) >= 2 and data[0] == 0x0A:
        ln = data[1]
        return data[2 : 2 + ln].decode("utf-8", "replace")
    return ""


class HealthServicer:
    def __init__(self, is_ready):
        self._is_ready = is_ready

    def Check(self, request_bytes: bytes, context) -> bytes:
        _decode_check_request(request_bytes)  # any service name → overall
        status = SERVING if self._is_ready() else NOT_SERVING
        return _encode_check_response(status)


def add_health_to_server(server: grpc.Server, is_ready):
    servicer = HealthServicer(is_ready)
    handlers = {
        "Check": grpc.unary_unary_rpc_method_handler(
            servicer.Check,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler("grpc.health.v1.Health", handlers),)
    )
