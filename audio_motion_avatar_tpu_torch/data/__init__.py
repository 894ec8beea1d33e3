"""Synthetic input batches of the port (mirroring audio_motion_avatar_tpu.data)."""
