"""Framework-neutral helpers copied from ``paddle_tpu.core``."""
