"""Model provisioning: ensure checkpoints exist locally, download if not.

A copy of the JAX package's ``checkpoint/manager.py``, a port of the
reference service's ModelManager (its model_manager.cpp):
name normalization ``ggml-X.bin`` → ``X`` (:16-20), URL templating from the
HuggingFace whisper.cpp repo (config.h:19-21), size validation with
corrupt-file delete + one redownload (:51-75), download via a ``curl -L
-f`` subprocess with list-args (the reference uses fork/execvp for
shell-injection safety, :82-131 — subprocess list-args is the same
guarantee).
"""

from __future__ import annotations

import logging
import os
import subprocess
from pathlib import Path

from ..config import Settings

log = logging.getLogger(__name__)

MIN_VALID_SIZE = 1024 * 1024  # files smaller than 1 MiB are corrupt


class ModelManager:
    @staticmethod
    def model_name_from_filename(filename: str) -> str:
        name = filename
        if name.startswith("ggml-"):
            name = name[len("ggml-") :]
        if name.endswith(".bin"):
            name = name[: -len(".bin")]
        return name

    @staticmethod
    def ensure_model(settings: Settings) -> str:
        """Ensure the main model file exists; returns its path."""
        path = Path(settings.model_dir) / settings.model_filename
        name = ModelManager.model_name_from_filename(settings.model_filename)
        url = settings.model_url_template.replace("{model_name}", name)
        ModelManager.ensure_file(
            str(path), url, timeout=settings.model_load_timeout
        )
        return str(path)

    @staticmethod
    def ensure_vad_model(settings: Settings) -> str:
        path = Path(settings.model_dir) / settings.vad_model_filename
        ModelManager.ensure_file(
            str(path), settings.vad_model_url, timeout=settings.model_load_timeout
        )
        return str(path)

    @staticmethod
    def ensure_file(path: str, url: str, timeout: int = 600) -> None:
        p = Path(path)
        if p.exists():
            if p.stat().st_size >= MIN_VALID_SIZE:
                return
            log.warning("checkpoint %s looks corrupt (%d bytes); redownloading",
                        path, p.stat().st_size)
            p.unlink()
        p.parent.mkdir(parents=True, exist_ok=True)
        ModelManager.download_file(url, path, timeout)
        if not p.exists() or p.stat().st_size < MIN_VALID_SIZE:
            if p.exists():
                p.unlink()
            raise RuntimeError(
                f"model download produced invalid file: {url} -> {path}"
            )

    @staticmethod
    def download_file(url: str, path: str, timeout: int = 600) -> None:
        tmp = path + ".part"
        log.info("downloading %s -> %s", url, path)
        try:
            proc = subprocess.run(
                ["curl", "-L", "-f", "--silent", "--show-error",
                 "-o", tmp, url],
                capture_output=True,
                timeout=timeout,
            )
        except FileNotFoundError as e:
            raise RuntimeError("curl not available for model download") from e
        except subprocess.TimeoutExpired as e:
            raise RuntimeError(f"model download timed out: {url}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"curl failed rc={proc.returncode}: "
                f"{proc.stderr.decode(errors='replace')[:300]}"
            )
        os.replace(tmp, path)
