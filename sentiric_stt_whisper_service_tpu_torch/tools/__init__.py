"""Probes of the port on the card, run as modules (``python -m
sentiric_stt_whisper_service_tpu_torch.tools.<name>``)."""
