"""Service entry point over the port's engine: the JAX package's
``serving/main.py`` lifecycle (the reference service's main.cpp:65-168).

Startup order: logging → settings → the multi-process leg → model
provisioning (and the Silero VAD) → metrics registry → engine (on the card
unless ``Settings.device`` says "cpu"; there the ``/debug/profile``
recorder starts building in a thread of its own) → warm-up → gRPC listener (insecure
or mTLS) → HTTP and metrics servers on their own threads → park until
SIGINT/SIGTERM → ordered shutdown.

The multi-process leg (the JAX package's ``jax.distributed`` one):
``parallel.maybe_initialize_distributed`` joins the processes before any
device touch when ``STT_WHISPER_SERVICE_COORDINATOR_ADDRESS`` is set
(``DISTRIBUTED_READY``; a failure logs ``DISTRIBUTED_INIT_FAILED`` and
raises). Every process builds the engine over ``MESH_SHAPE``; rank 0 then
serves, and a rank above 0 starts no server: it follows rank 0, running
rank 0's device operations on its shard (``SttEngine.follow``,
``parallel/replay.py``) until rank 0's shutdown releases it.

    python -m sentiric_stt_whisper_service_tpu_torch.serving [--random-init]
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import threading

import torch.distributed as dist
from aiohttp import web

from ..config import Settings, load_settings
from ..parallel import maybe_initialize_distributed
from ..runtime import SttEngine
from . import device_trace
from .grpc_server import build_server
from .http_server import HttpServer, MetricsServer
from .metrics import AppMetrics
from .suts_logging import setup_logging, suts_error, suts_info


class AppThread:
    """An aiohttp app served on a thread of its own with its own event loop."""

    def __init__(self, app: web.Application, host: str, port: int, name: str):
        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(app)
        started = threading.Event()
        self.error: BaseException | None = None

        async def _start():
            await self.runner.setup()
            await web.TCPSite(self.runner, host, port).start()
            suts_info(f"{name}_READY", "", "", "", "%s listening on %s:%d", name, host, port)

        def _thread():
            asyncio.set_event_loop(self.loop)
            try:
                self.loop.run_until_complete(_start())
            except BaseException as e:  # noqa: BLE001 — raised in the starting thread
                self.error = e
                return
            finally:
                started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=_thread, daemon=True, name=name)
        self.thread.start()
        started.wait()
        if self.error is not None:
            raise RuntimeError(f"{name} could not listen on {host}:{port}") from self.error

    def stop(self, timeout: float = 10.0) -> None:
        """Close the listener and the app, then end the loop and its thread."""
        if self.loop.is_running():
            asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(timeout)
            self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout)


def _load_vad(settings: Settings) -> None:
    """Install the Silero VAD on the engine's device; the energy VAD stays
    (logged loudly) when the checkpoint cannot be provisioned or parsed."""
    try:
        from ..checkpoint import ModelManager
        from ..runtime.vad import load_silero

        vad_path = ModelManager.ensure_vad_model(settings)
        if not vad_path:
            suts_error(
                "VAD_FALLBACK_ENERGY", "", "", "",
                "No Silero checkpoint available; serving with the energy VAD",
            )
        elif load_silero(str(vad_path), device=settings.device):
            suts_info("VAD_MODEL_READY", "", "", "", "Silero VAD loaded from %s", vad_path)
        else:
            # LOUD fallback: gating behavior changes when the energy VAD
            # substitutes for Silero (a different probability model).
            suts_error(
                "VAD_FALLBACK_ENERGY", "", "", "",
                "Silero checkpoint %s is missing or failed to parse; serving with "
                "the energy VAD — gating behavior differs from the reference",
                vad_path,
            )
    except Exception as e:  # noqa: BLE001 — provisioning is best-effort, as in the reference
        suts_error(
            "VAD_MODEL_PROVISION_FAILED", "", "", "",
            "%s (continuing with energy VAD)", e,
        )


def shutdown(engine: SttEngine, grpc_server, apps, grace: float = 5.0) -> None:
    """Ordered shutdown: the gRPC server (in-flight calls get ``grace``
    seconds) and its worker pool, the HTTP and metrics servers, then the
    engine's workers, then (on a mesh) the ranks that follow rank 0."""
    grpc_server.stop(grace=grace).wait(grace + 5)
    grpc_server.worker_pool.shutdown(wait=True)
    for app in apps:
        app.stop()
    engine.shutdown()
    engine.close()


def serve(settings: Settings | None = None, random_init: bool = False, block=True):
    """Start the service. ``block=False`` returns (engine, gRPC server, (HTTP
    and metrics ``AppThread``s), stop event) with everything running; hand
    the first three to :func:`shutdown` to stop it."""
    settings = settings or load_settings()
    setup_logging(settings.log_level)
    suts_info("SERVICE_STARTING", "", "", "", "Starting CUDA STT service")

    # The multi-process leg, env-gated: before any device touch, so that
    # each process takes its card first.
    try:
        if maybe_initialize_distributed(
                device="cpu" if (settings.device or "").strip().lower() == "cpu" else None):
            suts_info(
                "DISTRIBUTED_READY", "", "", "",
                "torch.distributed initialized: process %d of %d",
                dist.get_rank(), dist.get_world_size(),
            )
    except Exception as e:  # noqa: BLE001 — refuse to serve half a cluster
        suts_error("DISTRIBUTED_INIT_FAILED", "", "", "", "%s", e)
        raise

    if not random_init:
        try:
            from ..checkpoint import ModelManager

            ModelManager.ensure_model(settings)
        except Exception as e:  # pragma: no cover - depends on network
            suts_error("MODEL_PROVISION_FAILED", "", "", "", "%s", e)
            raise
    leader = not dist.is_initialized() or dist.get_rank() == 0
    if not random_init and settings.enable_vad and leader:  # the gate runs on rank 0
        _load_vad(settings)

    metrics = AppMetrics()
    engine = SttEngine(settings, random_init=random_init)
    if not engine.is_leader:
        suts_info("REPLAY_FOLLOWING", "", "", "", "process %d follows rank 0",
                  dist.get_rank())
        engine.follow()
        suts_info("REPLAY_RELEASED", "", "", "", "rank 0 shut down; process %d stops",
                  dist.get_rank())
        return None
    if engine.device.type == "cuda":  # the first /debug/profile then finds it built
        threading.Thread(target=device_trace.prebuild, daemon=True,
                         name="device-trace-build").start()
    if os.environ.get("STT_WHISPER_SERVICE_WARMUP", "true").lower() in ("true", "1"):
        suts_info("WARMUP_START", "", "", "", "Capturing the decode graph classes")
        dt = engine.warmup()
        suts_info("WARMUP_DONE", "", "", "", "Warmup finished in %.1fs", dt)

    grpc_server = build_server(engine, metrics, settings)
    grpc_server.start()
    suts_info(
        "GRPC_SERVER_READY", "", "", "",
        "gRPC server listening on %s:%d", settings.host, settings.grpc_port,
    )
    apps = (
        AppThread(HttpServer(engine, metrics, settings).app, settings.host,
                  settings.http_port, "HTTP_SERVER"),
        AppThread(MetricsServer(metrics).app, settings.host, settings.metrics_port,
                  "METRICS_SERVER"),
    )
    stop_event = threading.Event()

    def _signal_handler(signum, frame):
        suts_info("SHUTDOWN_SIGNAL", "", "", "", "Signal %d received", signum)
        stop_event.set()

    if not block:
        return engine, grpc_server, apps, stop_event
    signal.signal(signal.SIGINT, _signal_handler)
    signal.signal(signal.SIGTERM, _signal_handler)
    suts_info("SERVICE_READY", "", "", "", "Service fully up")
    stop_event.wait()
    suts_info("SHUTDOWN_BEGIN", "", "", "", "Ordered shutdown starting")
    shutdown(engine, grpc_server, apps)
    suts_info("SHUTDOWN_COMPLETE", "", "", "", "Goodbye")
    return None


def main():
    ap = argparse.ArgumentParser(description="Sentiric STT service on a CUDA card")
    ap.add_argument(
        "--random-init", action="store_true",
        help="skip checkpoint loading; random weights (dev/testing)",
    )
    args = ap.parse_args()
    serve(random_init=args.random_init)


if __name__ == "__main__":
    main()
