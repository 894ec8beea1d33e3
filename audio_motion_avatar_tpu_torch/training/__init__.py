"""Stage-1 evaluation of the port (mirroring audio_motion_avatar_tpu.training)."""
