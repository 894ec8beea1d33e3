"""Losses and image metrics of the port (mirroring audio_motion_avatar_tpu.utils)."""
