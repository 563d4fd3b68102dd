"""gRPC test client: ``python -m sentiric_stt_whisper_service_tpu_torch.cli
<file|stream> <wav> [addr]``, a copy of the JAX package's ``cli/main.py``
over the port's ``stt_pb2``.

``file`` mode sends the WAV in one unary call and prints
text/lang/prob/duration (the reference client's audio_client.cpp:91-139);
``stream`` mode strips the 44-byte header, sends 0.5 s chunks on a 500 ms
cadence (real time), then an empty EOS chunk, and prints the responses as
they come (:141-189). ``_unary`` returns the response and ``_stream`` the
send and arrival times with the responses, for callers that check them.
"""

from __future__ import annotations

import sys
import time

import grpc

from ..serving.proto import stt_pb2

_SERVICE = "sentiric.stt.v1.SttWhisperService"
_METADATA = (
    ("x-tenant-id", "cli-test"),
    ("x-trace-id", "cli-trace"),
    ("x-span-id", "cli-span"),
)
CHUNK_BYTES = 16000  # 0.5 s of PCM16 at 16 kHz
CHUNK_S = 0.5  # the cadence: one chunk per 0.5 s, as audio arrives live


def _transcribe_call(channel):
    """The unary WhisperTranscribe method on ``channel``."""
    return channel.unary_unary(
        f"/{_SERVICE}/WhisperTranscribe",
        request_serializer=stt_pb2.WhisperTranscribeRequest.SerializeToString,
        response_deserializer=stt_pb2.WhisperTranscribeResponse.FromString,
    )


def _unary(channel, wav_bytes: bytes):
    req = stt_pb2.WhisperTranscribeRequest(audio_data=wav_bytes)
    resp = _transcribe_call(channel)(req, metadata=_METADATA, timeout=600)
    print(f"Transcription : {resp.transcription!r}")
    print(f"Language      : {resp.language} (p={resp.language_probability:.3f})")
    print(f"Duration      : {resp.duration:.2f}s")
    print(f"Speaker       : {resp.speaker_id} gender={resp.gender_proxy} "
          f"emotion={resp.emotion_proxy}")
    if resp.words:
        print("Words:")
        for w in resp.words:
            print(f"  [{w.start:6.2f}-{w.end:6.2f}] p={w.probability:.2f} {w.word!r}")
    return resp


def _stream(channel, wav_bytes: bytes):
    """Stream the WAV at real time. Returns (the perf_counter time at which
    each chunk was handed to gRPC, the EOS last; [(arrival time, response)])."""
    call = channel.stream_stream(
        f"/{_SERVICE}/WhisperTranscribeStream",
        request_serializer=stt_pb2.WhisperTranscribeStreamRequest.SerializeToString,
        response_deserializer=stt_pb2.WhisperTranscribeStreamResponse.FromString,
    )
    body = wav_bytes[44:] if wav_bytes[:4] == b"RIFF" else wav_bytes
    sent, received = [], []

    def requests():
        for i in range(0, len(body), CHUNK_BYTES):
            sent.append(time.perf_counter())
            yield stt_pb2.WhisperTranscribeStreamRequest(audio_chunk=body[i : i + CHUNK_BYTES])
            time.sleep(CHUNK_S)  # simulate real-time capture
        sent.append(time.perf_counter())
        yield stt_pb2.WhisperTranscribeStreamRequest(audio_chunk=b"")  # EOS

    for resp in call(requests(), metadata=_METADATA):
        received.append((time.perf_counter(), resp))
        kind = "FINAL  " if resp.is_final else "partial"
        print(f"[{kind}] {resp.transcription!r} (spk={resp.speaker_id})")
    return sent, received


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2 or argv[0] not in ("file", "stream"):
        print("usage: stt_cli <file|stream> <wav> [addr]", file=sys.stderr)
        return 2
    mode, path = argv[0], argv[1]
    addr = argv[2] if len(argv) > 2 else "localhost:15031"
    with open(path, "rb") as f:
        wav_bytes = f.read()
    channel = grpc.insecure_channel(addr)
    try:
        if mode == "file":
            _unary(channel, wav_bytes)
        else:
            _stream(channel, wav_bytes)
    except grpc.RpcError as e:
        print(f"RPC failed: {e.code().name}: {e.details()}", file=sys.stderr)
        return 1
    finally:
        channel.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
